"""The LM loop's restore of rejected windows (`qtos_torch/ops/lm_restore.py`,
`qtos_torch/csrc/lm_restore.cu`) and the loop that uses it, on the CPU.

The plain version and the kernel's own source (built with the host C++
compiler against the CUDA stand-in in `qtos_torch/csrc/emu/`, driven through
`ops.lm_restore.run` with CPU tensors) are held to `torch.where` semantics:
rejected windows take the kept system, or zeros before one is kept, and
accepted windows keep the fresh one, bit for bit.  `_solve_pass` is held bit
for bit to `where_pass`, a frozen copy of the loop that selected the best
point's system by `torch.where` over whole tensors, on a problem whose LM
run rejects steps.

This file imports neither JAX nor qtos_tpu: tests/test_torch_gpu.py imports
`where_pass` from it on the card.
"""

import importlib
import os

import numpy as np
import pytest
import torch

from helpers import emu
from qtos_torch.ops import lm_restore
from qtos_torch.ops.btd import btd_solve
from qtos_torch.ops.lm_restore import restore_rejected, restore_rejected_plain
from qtos_torch.solver import SolverConfig, default_spec, solve_batch
from qtos_torch.solver.assemble import assemble
from qtos_torch.solver.solve import STATUS_CONVERGED, STATUS_MAX_ITERS, SolveResult, _solve_pass
from qtos_torch.solver.spec import NV
from qtos_torch.solver.transcription import initial_guess, knot_aux, max_violation, violations
from qtos_torch.terrain import make_terrain
from qtos_torch.terrain.heightfield import slope_terrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMU_DIR = os.path.join(REPO, "qtos_torch", "csrc", "emu")
# the module, not the function `qtos_torch.solver.solve` that shadows it
solve_mod = importlib.import_module("qtos_torch.solver.solve")
SHAPES = [(1, 13), (5, 13), (4, 41)]
CASES = ["accepted", "rejected", "mixed", "zero_fill"]


def where_pass(specs, terrain, cfg, x0=None):
    """The LM loop as it selected the best point's system before the
    restore: `torch.where` of the fresh and the kept D, L, g into a third
    copy every iteration, the kept system zeros before the first.  Frozen
    here as the yardstick of `_solve_pass`; the rest of the pass is
    `_solve_pass`'s without its spans."""
    B = specs.goal_r.shape[0]
    if x0 is None:
        x0 = initial_guess(specs, terrain, cfg)
    K = x0.shape[1]
    dev, dt_ = x0.device, x0.dtype
    aux = knot_aux(specs, terrain, cfg)
    slope = slope_terrain(terrain, cfg.slope_probe_d)
    x, x_best = x0, x0
    D_b = torch.zeros((B, K, NV, NV), dtype=dt_, device=dev)
    L_b = torch.zeros((B, K - 1, NV, NV), dtype=dt_, device=dev)
    g_b = torch.zeros((B, K, NV), dtype=dt_, device=dev)
    merit_b = torch.full((B,), float("inf"), dtype=dt_, device=dev)
    lm = torch.full((B,), cfg.lm_init, dtype=dt_, device=dev)
    for _ in range(cfg.max_iters):
        D, L, g, merit = assemble(x, specs, terrain, cfg, aux, slope)
        accept = merit < merit_b
        a3, a4 = accept[:, None, None], accept[:, None, None, None]
        x_best = torch.where(a3, x, x_best)
        D_b = torch.where(a4, D, D_b)
        L_b = torch.where(a4, L, L_b)
        g_b = torch.where(a3, g, g_b)
        merit_b = torch.where(accept, merit, merit_b)
        lm = torch.clamp(torch.where(accept, lm * cfg.lm_down, lm * cfg.lm_up), cfg.lm_min, cfg.lm_max)
        damp = lm[:, None, None] * torch.diagonal(D_b, dim1=-2, dim2=-1) + 1e-8
        dx = btd_solve(D_b + torch.diag_embed(damp), L_b, -g_b)
        x = x_best + dx
    viol_b = violations(x_best, specs, terrain, cfg)
    viol_t = violations(x, specs, terrain, cfg)
    mv_b, mv_t = max_violation(viol_b), max_violation(viol_t)
    take_t = mv_t < mv_b
    max_v = torch.minimum(mv_b, mv_t)
    return SolveResult(
        x=torch.where(take_t[:, None, None], x, x_best),
        status=torch.where(max_v < cfg.tol, STATUS_CONVERGED, STATUS_MAX_ITERS).to(torch.int32),
        merit=merit_b,
        max_violation=max_v,
        viol={k: torch.where(take_t, viol_t[k], viol_b[k]) for k in viol_b},
        iters=torch.full((B,), cfg.max_iters, dtype=torch.int32, device=dev),
    )


def assert_results_equal(a, b):
    """Two SolveResults equal bit for bit."""
    for name in ("x", "status", "merit", "max_violation", "iters"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.viol.keys() == b.viol.keys()
    for k in a.viol:
        assert torch.equal(a.viol[k], b.viol[k]), k


def systems(B, K, case, seed, n=NV):
    """(accept, fresh (D, L, g), kept or None) for one case: every window
    accepted, every one rejected, a random mix with both present, or that
    mix with no kept system yet (zero fill)."""
    gen = torch.Generator().manual_seed(seed)
    fresh = (torch.randn(B, K, n, n, generator=gen), torch.randn(B, K - 1, n, n, generator=gen),
             torch.randn(B, K, n, generator=gen))
    kept = None if case == "zero_fill" else tuple(torch.randn(t.shape, generator=gen) for t in fresh)
    if case in ("accepted", "rejected"):
        accept = torch.full((B,), case == "accepted")
    else:
        accept = torch.rand(B, generator=gen) < 0.5
        if B > 1:   # both kinds present
            accept[0], accept[-1] = True, False
        else:
            accept[0] = False
    return accept, fresh, kept


def expected(accept, fresh, kept):
    """`torch.where` of the fresh and the kept system (zeros without one)."""
    out = []
    for i, t in enumerate(fresh):
        other = torch.zeros_like(t) if kept is None else kept[i]
        out.append(torch.where(accept.view(-1, *[1] * (t.dim() - 1)), t, other))
    return out


def check_restored(accept, dst, fresh, kept, kept_before):
    for got, want in zip(dst, expected(accept, fresh, kept)):
        assert torch.equal(got, want)
    if kept is not None:
        for k, k0, d in zip(kept, kept_before, dst):
            assert torch.equal(k, k0), "the kept system was written"
            assert k.untyped_storage().data_ptr() != d.untyped_storage().data_ptr()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("B,K", SHAPES)
def test_plain_restore_is_where(B, K, case):
    """The plain version, through the wrapper on CPU tensors: `torch.where`
    semantics in place, the kept tensors unchanged and not shared with the
    restored ones."""
    accept, fresh, kept = systems(B, K, case, seed=B * 100 + K)
    dst = tuple(t.clone() for t in fresh)
    kept_before = None if kept is None else tuple(t.clone() for t in kept)
    launches = restore_rejected.launches
    restore_rejected(accept, dst, kept)
    assert restore_rejected.launches == launches   # the CPU runs the plain version
    check_restored(accept, dst, fresh, kept, kept_before)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_restore_emu") / "liblm_restore_emu.so"
    return lm_restore.load_library(emu.build(lm_restore.KERNEL, os.path.join(EMU_DIR, "lm_restore_emu.cpp"), out))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("B,K", SHAPES)
def test_kernel_source_restore_is_where(emu_lib, B, K, case):
    """The kernel's source on the CPU equals the plain version and
    `torch.where` bit for bit."""
    accept, fresh, kept = systems(B, K, case, seed=B * 100 + K + 1)
    dst = tuple(t.clone() for t in fresh)
    kept_before = None if kept is None else tuple(t.clone() for t in kept)
    lm_restore.run(emu_lib, accept, dst, kept)
    check_restored(accept, dst, fresh, kept, kept_before)
    plain = tuple(t.clone() for t in fresh)
    restore_rejected_plain(accept, plain, kept)
    for a, b in zip(dst, plain):
        assert torch.equal(a, b)


def test_kernel_source_refuses_misaligned_tensors(emu_lib):
    """The kernel copies 16 bytes at a time: its entry refuses a tensor that
    starts 4 bytes past a 16-byte boundary, or windows that are not whole
    float4s, and writes nothing; the wrapper's check names both."""
    B, sizes = 3, (1296, 1296, 36)
    gen = torch.Generator().manual_seed(7)
    fresh = tuple(torch.randn(B * s + 1, generator=gen)[1:].view(B, s) for s in sizes)
    kept = tuple(torch.randn(B, s, generator=gen) for s in sizes)
    assert all(t.data_ptr() % 16 for t in fresh)
    accept = torch.tensor([False, True, False])
    before = tuple(t.clone() for t in fresh)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        lm_restore.run(emu_lib, accept, fresh, kept)
    assert all(torch.equal(a, b) for a, b in zip(fresh, before))
    with pytest.raises(ValueError, match="16-byte aligned"):
        lm_restore._check_aligned(fresh, kept)
    odd = tuple(torch.randn(B, s + 2, generator=gen) for s in sizes)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        lm_restore.run(emu_lib, accept, odd, None)
    with pytest.raises(ValueError, match="whole float4s"):
        lm_restore._check_aligned(odd, None)
    lm_restore._check_aligned(kept, None)


def test_restore_rejects_bad_arguments():
    accept, fresh, kept = systems(4, 5, "mixed", seed=3)
    with pytest.raises(ValueError, match="bool accept"):
        restore_rejected(accept.to(torch.uint8), fresh, kept)
    with pytest.raises(TypeError, match="float32"):
        restore_rejected(accept, (fresh[0].double(), *fresh[1:]), None)
    with pytest.raises(ValueError, match="for a batch of 3"):
        restore_rejected(accept[:3], fresh, kept)
    with pytest.raises(ValueError, match="contiguous tensors"):
        restore_rejected(accept, (fresh[0].transpose(2, 3), *fresh[1:]), None)
    with pytest.raises(ValueError, match="not a contiguous copy"):
        restore_rejected(accept, fresh, (kept[0][:, :-1].contiguous(), *kept[1:]))


@pytest.fixture(scope="module")
def rejecting_problem():
    """Three trot windows of K=9 on flat ground, 12 LM iterations: steps
    are rejected late in the run, in some windows and not others."""
    terr = make_terrain(["plane", "plane"], device="cpu")
    goals = np.linspace(0.1, 0.45, 3).astype(np.float32)
    specs = default_spec(terr, goal_xy=(goals, 0.0), K=9, duration=1.5, device="cpu")
    return specs, terr, SolverConfig(max_iters=12)


def test_solve_pass_equals_the_where_loop(rejecting_problem, monkeypatch):
    """`_solve_pass` with the in-place restore gives the frozen `torch.where`
    loop's result bit for bit, on a run that rejects steps (asserted)."""
    specs, terr, cfg = rejecting_problem
    masks = []

    def spy(accept, dst, kept):
        masks.append(accept.clone())
        restore_rejected(accept, dst, kept)

    monkeypatch.setattr(solve_mod, "restore_rejected", spy)
    new = _solve_pass(specs, terr, cfg)
    rejected = [int((~a).sum()) for a in masks]
    assert len(masks) == cfg.max_iters
    assert sum(rejected) > 0, f"the problem must reject a step: {rejected}"
    assert any(0 < r < len(a) for r, a in zip(rejected, masks)), f"no mixed iteration: {rejected}"
    assert_results_equal(new, where_pass(specs, terr, cfg))


def test_solve_batch_equals_the_where_loop_with_rescue(rejecting_problem, monkeypatch):
    """`solve_batch` with a starved first pass and a rescue pass (both
    through `_solve_pass`) equals the same entry over the frozen loop."""
    specs, terr, _ = rejecting_problem
    cfg = SolverConfig(max_iters=2, rescue_iters=10, rescue_frac=1)
    passes = []

    def counted(*args):
        passes.append(args[0].goal_r.shape[0])
        return _solve_pass(*args)

    monkeypatch.setattr(solve_mod, "_solve_pass", counted)
    new = solve_batch(specs, terr, cfg)
    assert len(passes) == 2, f"the first pass must leave windows to rescue: {passes}"
    monkeypatch.setattr(solve_mod, "_solve_pass", where_pass)
    assert_results_equal(new, solve_batch(specs, terr, cfg))
