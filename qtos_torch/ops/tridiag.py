"""Batched block-tridiagonal SPD solves (port of `qtos_tpu.ops.tridiag`).

H = blocktridiag(diag=D[k], lower=L[k] at (k+1, k), upper=L[k]^T).

`block_tridiag_solve` is the plain PyTorch version of the CUDA kernel in
`qtos_torch/csrc/btd.cu` (wrapper: `qtos_torch.ops.btd.btd_solve`): a
batch-major mirror of `qtos_tpu`'s `_block_tridiag_solve_lanes`, with the
same column-unrolled Cholesky (pivot clamped at 1e-12 before rsqrt) and the
same block Thomas recursion.  It is what the CPU path runs and what the
kernel is held against on the card.
"""

from __future__ import annotations

import torch


def _chol(A):
    """Cholesky of SPD A (B, n, n) -> lower factor, unrolled columns."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    Lc = torch.zeros_like(A)
    for j in range(n):
        d = torch.rsqrt(torch.clamp(A[:, j, j], min=1e-12))            # (B,)
        col = A[:, :, j] * d[:, None]                                  # (B, n)
        col = torch.where(rows >= j, col, torch.zeros_like(col))
        Lc[:, :, j] = col
        A = A - col[:, :, None] * col[:, None, :]
    return Lc


def _solve_lower(Lc, R):
    """Lc Y = R with Lc (B, n, n) lower, R (B, n, m)."""
    n = Lc.shape[-1]
    rows = torch.arange(n, device=Lc.device)
    Y = R.clone()
    for j in range(n):
        yj = Y[:, j, :] / Lc[:, j, j][:, None]                          # (B, m)
        colj = torch.where(rows > j, Lc[:, :, j], torch.zeros_like(Lc[:, :, j]))
        Y = Y - colj[:, :, None] * yj[:, None, :]
        Y[:, j, :] = yj
    return Y


def _solve_upper_t(Lc, R):
    """Lc^T X = R."""
    n = Lc.shape[-1]
    rows = torch.arange(n, device=Lc.device)
    X = R.clone()
    for j in range(n - 1, -1, -1):
        xj = X[:, j, :] / Lc[:, j, j][:, None]
        rowj = torch.where(rows < j, Lc[:, j, :], torch.zeros_like(Lc[:, j, :]))
        X = X - rowj[:, :, None] * xj[:, None, :]
        X[:, j, :] = xj
    return X


def _spd_solve(Lc, R):
    return _solve_upper_t(Lc, _solve_lower(Lc, R))


def block_tridiag_solve(D: torch.Tensor, L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for a batch of SPD block-tridiagonal H.

    Args:
      D: (B, K, n, n) diagonal blocks (SPD after regularization).
      L: (B, K-1, n, n) sub-diagonal blocks.
      b: (B, K, n) right-hand sides.

    Returns:
      x: (B, K, n).
    """
    K = D.shape[1]
    Lcs = [_chol(D[:, 0])]
    ys = [b[:, 0]]
    for k in range(1, K):
        Lk = L[:, k - 1]
        Lc_prev = Lcs[-1]
        Wt = _spd_solve(Lc_prev, Lk.transpose(-1, -2))                  # S^-1 L^T
        Sk = D[:, k] - Lk @ Wt
        u = _spd_solve(Lc_prev, ys[-1][:, :, None])[:, :, 0]
        ys.append(b[:, k] - (Lk @ u[:, :, None])[:, :, 0])
        Lcs.append(_chol(Sk))

    xs = [None] * K
    x_next = torch.zeros_like(b[:, 0])
    for k in range(K - 1, -1, -1):
        rhs = ys[k]
        if k < K - 1:
            rhs = rhs - (L[:, k].transpose(-1, -2) @ x_next[:, :, None])[:, :, 0]
        x_next = _spd_solve(Lcs[k], rhs[:, :, None])[:, :, 0]
        xs[k] = x_next
    return torch.stack(xs, dim=1)


def block_tridiag_matvec(D: torch.Tensor, L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """H @ x for the block-tridiagonal H defined above; batch-major shapes
    as in `block_tridiag_solve`."""
    y = (D @ x[..., None])[..., 0]
    y[:, 1:] += (L @ x[:, :-1, :, None])[..., 0]
    y[:, :-1] += (L.transpose(-1, -2) @ x[:, 1:, :, None])[..., 0]
    return y
