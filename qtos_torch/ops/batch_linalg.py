"""Batched small-SPD factorization/solve as column loops (port of
`qtos_tpu.ops.batch_linalg`).

The same math as masked elementwise updates over the whole (..., n, n) batch,
one column at a time.
"""

from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (..., n, n), column loop unrolled."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    for j in range(n):
        d = torch.sqrt(torch.clamp(A[..., j, j], min=eps))
        col = A[..., :, j] / d[..., None]
        col = torch.where(rows >= j, col, torch.zeros_like(col))
        L[..., :, j] = col
        A = A - col[..., :, None] * col[..., None, :]
    return L


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L Y = B for lower-triangular L: (..., n, n) @ (..., n, m)."""
    n = L.shape[-1]
    rows = torch.arange(n, device=L.device)
    Y = B.clone()
    for j in range(n):
        yj = Y[..., j, :] / L[..., j, j][..., None]
        colj = torch.where(rows > j, L[..., :, j], torch.zeros_like(L[..., :, j]))
        Y = Y - colj[..., :, None] * yj[..., None, :]
        Y[..., j, :] = yj
    return Y


def solve_upper_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = B for lower-triangular L (i.e. upper system)."""
    n = L.shape[-1]
    rows = torch.arange(n, device=L.device)
    X = B.clone()
    for j in range(n - 1, -1, -1):
        xj = X[..., j, :] / L[..., j, j][..., None]
        # L^T column j is L row j: entries L[j, k] for k < j
        rowj = torch.where(rows < j, L[..., j, :], torch.zeros_like(L[..., j, :]))
        X = X - rowj[..., :, None] * xj[..., None, :]
        X[..., j, :] = xj
    return X


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^{-1} B for SPD A (..., n, n), B (..., n, m)."""
    L = cholesky_unrolled(A)
    return solve_upper_t(L, solve_lower(L, B))


def spd_solve_vec(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^{-1} b for SPD A (..., n, n), b (..., n)."""
    return spd_solve(A, b[..., None])[..., 0]
