"""Block-tridiagonal solve: the port's plain version against qtos_tpu's
Pallas kernel (interpret mode) and its lanes reference, on the shapes of
tests/test_pallas_btd.py.  The CUDA kernel is held against the plain version
in tests/test_torch_gpu.py.

Tolerance atol=5e-4 as tests/test_pallas_btd.py: float32 block Thomas on
diagonally dominant systems with O(1) solutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.ops.pallas.btd import btd_solve_pallas
from qtos_tpu.ops.tridiag import _block_tridiag_solve_lanes
from qtos_tpu.ops.tridiag import block_tridiag_matvec as j_matvec

from qtos_torch.ops.btd import btd_solve
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve

ATOL = 5e-4
SHAPES = [(3, 7, 12), (2, 5, 36), (1, 9, 5), (5, 4, 6)]


def _system(B, K, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, n, n)).astype(np.float32)
    D = (A @ A.transpose(0, 1, 3, 2) + (n + 8) * np.eye(n, dtype=np.float32)).astype(np.float32)
    L = (0.3 * rng.normal(size=(B, K - 1, n, n))).astype(np.float32)
    xt = rng.normal(size=(B, K, n)).astype(np.float32)
    b = np.array(jax.vmap(j_matvec)(jnp.asarray(D), jnp.asarray(L), jnp.asarray(xt)))
    return D, L, b, xt


@pytest.mark.parametrize("B,K,n", SHAPES)
def test_plain_matches_pallas_interpret(B, K, n):
    D, L, b, xt = _system(B, K, n, 0)
    ref = np.asarray(btd_solve_pallas(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b), interpret=True))
    x = block_tridiag_solve(torch.from_numpy(D), torch.from_numpy(L), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, ref, atol=ATOL)
    np.testing.assert_allclose(x, xt, atol=ATOL)


@pytest.mark.parametrize("B,K,n", SHAPES)
def test_plain_matches_lanes_reference(B, K, n):
    D, L, b, _ = _system(B, K, n, 1)
    mv = lambda a: jnp.moveaxis(jnp.asarray(a), 0, -1)  # noqa: E731
    ref = np.moveaxis(np.asarray(_block_tridiag_solve_lanes(mv(D), mv(L), mv(b))), -1, 0)
    x = btd_solve(torch.from_numpy(D), torch.from_numpy(L), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, ref, atol=ATOL)


def test_matvec_matches():
    D, L, _, xt = _system(3, 6, 7, 2)
    ref = np.asarray(jax.vmap(j_matvec)(jnp.asarray(D), jnp.asarray(L), jnp.asarray(xt)))
    y = block_tridiag_matvec(torch.from_numpy(D), torch.from_numpy(L), torch.from_numpy(xt))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_wrapper_cpu_runs_plain_and_counts_nothing(damped):
    """On the CPU the wrapper is the plain version, damped by lm as the LM
    loop damped its copy of D (D + diag_embed(lm * diag(D) + 1e-8)), bit
    for bit, with D left as it was; no launch is counted."""
    D, L, b = (torch.from_numpy(a) for a in _system(2, 5, 36, 3)[:3])
    lm = torch.tensor([7.5e-5, 0.4]) if damped else None
    D0 = D.clone()
    before = (btd_solve.launches, btd_solve.small_launches, btd_solve.damped_launches)
    x = btd_solve(D, L, b, lm=lm)
    H = D + torch.diag_embed(lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8) if damped else D
    assert torch.equal(x, block_tridiag_solve(H, L, b))
    assert torch.equal(D, D0)
    assert (btd_solve.launches, btd_solve.small_launches, btd_solve.damped_launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "lm_dtype", "lm_shape", "lm_contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    D, L, b, _ = (torch.from_numpy(a) for a in _system(2, 4, 6, 4))
    lm = None
    if bad == "dtype":
        D = D.double()
    elif bad == "shape":
        L = L[:, :-1]
    elif bad == "contiguous":
        D = D.transpose(-1, -2)
    elif bad == "lm_dtype":
        lm = torch.ones(2, dtype=torch.float64)
    elif bad == "lm_shape":
        lm = torch.ones(2, 1)
    else:
        lm = torch.ones(4)[::2]
    with pytest.raises((TypeError, ValueError)):
        btd_solve(D, L, b, lm=lm)
