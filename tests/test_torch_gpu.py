"""Tests of qtos_torch that need a CUDA card: the kernel against its plain
version, and the solver through the kernel.  They skip without a card.

This file imports neither JAX nor qtos_tpu, so it also runs where only the
port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts="" -q

Tolerance atol=5e-4 as tests/test_pallas_btd.py: float32 block Thomas on
diagonally dominant systems with O(1) solutions.
"""

import numpy as np
import pytest
import torch

from qtos_torch.ops.btd import btd_solve
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve

ATOL = 5e-4
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _system(B, K, n, seed, dev):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, n, n)).astype(np.float32)
    D = torch.from_numpy(A @ A.transpose(0, 1, 3, 2) + (n + 8) * np.eye(n, dtype=np.float32)).to(dev)
    L = torch.from_numpy((0.3 * rng.normal(size=(B, K - 1, n, n))).astype(np.float32)).to(dev)
    xt = torch.from_numpy(rng.normal(size=(B, K, n)).astype(np.float32)).to(dev)
    return D, L, block_tridiag_matvec(D, L, xt).contiguous(), xt


@pytest.mark.parametrize(
    "B,K,n",
    [(3, 7, 12), (2, 5, 36), (1, 9, 5), (5, 4, 6), (64, 41, 36), (3, 2, 64), (2, 1, 36)],
)
def test_kernel_matches_plain(cuda, B, K, n):
    D, L, b, xt = _system(B, K, n, 5, cuda)
    before = btd_solve.launches
    x = btd_solve(D, L, b)
    torch.cuda.synchronize()
    assert btd_solve.launches == before + 1
    torch.testing.assert_close(x, block_tridiag_solve(D, L, b), rtol=0, atol=ATOL)
    torch.testing.assert_close(x, xt, rtol=0, atol=ATOL)


def test_kernel_rejects_wide_blocks(cuda):
    D, L, b, _ = _system(1, 2, 65, 6, cuda)
    with pytest.raises(ValueError):
        btd_solve(D, L, b)


def test_solve_batch_on_card_matches_cpu(cuda):
    """The port on the card (kernel) against the port on the CPU (plain
    version): equal statuses, x within the solver tolerance 5e-3."""
    from qtos_torch.solver import SolverConfig, default_spec, solve_batch
    from qtos_torch.terrain import make_terrain

    goals = np.linspace(0.2, 0.5, 4).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        terr = make_terrain(["plane", "plane"], device=dev)
        specs = default_spec(terr, goal_xy=(goals, 0.0), K=13, duration=1.5, device=dev)
        before = btd_solve.launches
        res = solve_batch(specs, terr, SolverConfig(max_iters=3))
        launched = btd_solve.launches - before
        assert launched == (3 if dev.type == "cuda" else 0)
        out[dev.type] = (res.status.cpu(), res.x.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=5e-3)
