"""Tests of qtos_torch that need a CUDA card: the BTD, tick and assembly
kernels against their plain versions, the solver through the kernel, the
simulator and control loop on the card against the CPU, and the runner's
real-time mode.  They skip without a card.

This file imports neither JAX nor qtos_tpu, so it also runs where only the
port is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts="" -q

Tolerance atol=5e-4 as tests/test_pallas_btd.py: float32 block Thomas on
diagonally dominant systems with O(1) solutions.

The kernel solves one scenario per warp, four warps per block, and walks the
batch by grid stride over the blocks that fit on the card at once (about
2640 scenarios on an H100 at n=36), and gives each lane rows l and l + 32.
The shapes cover those edges: B not a multiple of 4, B beyond one pass of
the grid, n around 32 and at the limit 64, and K = 1, 2.  Up to two
scenarios per SM (kSmallPerSm in btd.cu), and where its factors fit in
shared memory, `btd_solve`
launches the small-batch kernel of the same source (one scenario per
block) instead: it is held to btd_kernel bit for bit at the paths' small
shapes and on both sides of the rule.  Where the small kernel's factors do
not fit (K >= 74 at n = 36) and B is at most the long-horizon kernel's
crossover (kMaxBatch in btd.cu), `btd_solve` launches that kernel (block
cyclic reduction, one cooperative launch): it is held to the plain version
at ATOL at the one-shot plan's horizons, damped and undamped, on both sides
of its rule, under a profiler and in a CUDA graph.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from qtos_torch.ops import btd
from qtos_torch.ops.btd import btd_solve, picks_small
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve

ATOL = 5e-4
with open(btd.SOURCE) as _f:
    _SRC = _f.read()
SMALL_PER_SM = int(re.search(r"constexpr int kSmallPerSm = (\d+);", _SRC).group(1))
REDUCE_MAX_BATCH = int(re.search(r"constexpr int kMaxBatch = (\d+);", _SRC).group(1))
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
    [
        (3, 7, 12), (2, 5, 36), (1, 9, 5), (5, 4, 6), (64, 41, 36), (3, 2, 64), (2, 1, 36),
        # B = 1, 7, 9 (not multiples of the 4 warps of a block) and B = 3000,
        # more scenarios than an H100 holds in flight, so the grid stride wraps
        (1, 4, 36), (7, 3, 36), (9, 3, 36), (3000, 3, 36),
        # n at the lanes' edges: one row per lane, 32, one more, two per lane
        (4, 3, 31), (4, 3, 32), (4, 3, 33), (2, 4, 64),
        # K = 1 and K = 2
        (5, 1, 7), (5, 2, 36),
    ],
)
def test_kernel_matches_plain(cuda, B, K, n):
    D, L, b, xt = _system(B, K, n, 5, cuda)
    before = btd_solve.launches
    x = btd_solve(D, L, b)
    torch.cuda.synchronize()
    assert btd_solve.launches == before + 1
    torch.testing.assert_close(x, block_tridiag_solve(D, L, b), rtol=0, atol=ATOL)
    torch.testing.assert_close(x, xt, rtol=0, atol=ATOL)


def test_kernel_pivot_clamp(cuda):
    """Row and column 3 of D_0 are zero but for the diagonal, set to 1e-13,
    below the 1e-12 clamp, and column 3 of L_0 is zero, so row 3 of H is
    decoupled.  (An exact zero pivot would give the factor a zero diagonal
    entry, 0 * rsqrt(1e-12), which both versions divide by.)  The clamp
    makes C_33 = 1e-13 * rsqrt(1e-12) = 1e-7, so x_3 = b_3 / C_33^2 is no
    longer the exact solution, but both versions compute it by the same
    steps: it must be finite and agree to rtol 1e-4, which covers the few
    ulp of rsqrt and two divisions it carries; the rest of x is an ordinary
    solve held at ATOL."""
    D, L, _, xt = _system(3, 4, 12, 8, cuda)
    D[:, 0, 3, :] = 0
    D[:, 0, :, 3] = 0
    D[:, 0, 3, 3] = 1e-13
    L[:, 0, :, 3] = 0
    b = block_tridiag_matvec(D, L, xt).contiguous()
    x = btd_solve(D, L, b)
    xp = block_tridiag_solve(D, L, b)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(xp).all())
    torch.testing.assert_close(x, xp, rtol=1e-4, atol=ATOL)


def _launch(entry, D, L, b, lm=None):
    """x from one launch of a kernel of btd.cu (`btd_solve_f32`: btd_kernel;
    `btd_small_solve_f32`: the small-batch kernel; `btd_reduce_solve_f32`:
    the long-horizon kernel), past the wrapper, damped by `lm` if given."""
    lib = btd.KERNEL.load()
    B, K, n = b.shape
    x = torch.empty_like(b)
    if entry == "btd_reduce_solve_f32":
        C = btd.reduce_scratch(B, K, n, b.device)
    else:
        C = torch.empty((B, K - 1, lib.btd_packed_floats(n)), device=b.device)
    err = getattr(lib, entry)(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(), C.data_ptr(), B, K, n,
                              torch.cuda.current_stream().cuda_stream, None if lm is None else lm.data_ptr())
    assert err == 0, f"{entry} at ({B}, {K}, {n}): CUDA error {err}"
    return x


@pytest.mark.parametrize(
    "B,K,n",
    [
        (1, 41, 36), (4, 41, 36), (20, 25, 36), (1, 33, 36),   # the TOWR window, a replan, the probe, the quick start
        (2, 1, 36), (5, 2, 36), (2, 9, 5), (4, 3, 33), (3, 17, 64), (132, 41, 36), (1, 73, 36),
    ],
)
def test_small_kernel_equals_btd_kernel(cuda, B, K, n):
    """The small-batch kernel gives btd_kernel's x bit for bit, within ATOL
    of the plain version."""
    D, L, b, _ = _system(B, K, n, 9, cuda)
    xs, xw = _launch("btd_small_solve_f32", D, L, b), _launch("btd_solve_f32", D, L, b)
    torch.cuda.synchronize()
    assert torch.equal(xs, xw), float((xs - xw).abs().max())
    torch.testing.assert_close(xs, block_tridiag_solve(D, L, b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("side", ["at", "past"])
def test_dispatch_on_each_side_of_the_crossover(cuda, side):
    """btd_solve launches the small-batch kernel up to SMALL_PER_SM scenarios
    per SM and btd_kernel past it, counting one launch per call and the
    small kernel's apart; either way x is the other kernel's bit for bit."""
    B = SMALL_PER_SM * torch.cuda.get_device_properties(cuda).multi_processor_count + (side == "past")
    small = side == "at"
    assert picks_small(B, 41, 36) == small
    D, L, b, _ = _system(B, 41, 36, 10, cuda)
    launches, smalls = btd_solve.launches, btd_solve.small_launches
    x = btd_solve(D, L, b)
    assert (btd_solve.launches, btd_solve.small_launches) == (launches + 1, smalls + small)
    other = _launch("btd_solve_f32" if small else "btd_small_solve_f32", D, L, b)
    torch.cuda.synchronize()
    assert torch.equal(x, other)


def test_dispatch_where_the_factors_do_not_fit(cuda):
    """At n = 36 the small kernel's factors fit a block's shared memory up
    to K = 73; at K = 74 btd_solve takes btd_kernel."""
    assert picks_small(1, 73, 36) and not picks_small(1, 74, 36)
    D, L, b, _ = _system(1, 74, 36, 11, cuda)
    smalls = btd_solve.small_launches
    x = btd_solve(D, L, b)
    torch.cuda.synchronize()
    assert btd_solve.small_launches == smalls
    torch.testing.assert_close(x, block_tridiag_solve(D, L, b), rtol=0, atol=ATOL)


def _btd_counts() -> tuple:
    return (btd_solve.launches, btd_solve.small_launches, btd_solve.long_launches, btd_solve.reduce_launches)


@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_long_horizon_at_batch_one_goes_to_the_reduction_kernel(cuda, damped):
    """The one-shot plan's solve, (1, 154, 36): the batch is the small
    kernel's but its factors are not, so btd_solve launches the long-horizon
    kernel and counts the launch in `long_launches` and `reduce_launches`;
    x within ATOL of the plain solve (of the damped copy when damped).  At
    the sweep's (8192, 41, 36) and the replan's (4, 41, 36) nothing is
    counted in either."""
    D, L, b, _ = _system(1, 154, 36, 14, cuda)
    lm = torch.full((1,), 0.3, device=cuda) if damped else None
    assert not picks_small(1, 154, 36) and btd.picks_reduce(1, 154, 36)
    counts = _btd_counts()
    x = btd_solve(D, L, b, lm=lm)
    torch.cuda.synchronize()
    assert _btd_counts() == (counts[0] + 1, counts[1], counts[2] + 1, counts[3] + 1)
    plain = block_tridiag_solve(_damped_copy(D, lm) if damped else D, L, b)
    torch.testing.assert_close(x, plain, rtol=0, atol=ATOL)
    past = SMALL_PER_SM * torch.cuda.get_device_properties(cuda).multi_processor_count + 1
    for B in (past, 4, 8192):
        D, L, b, _ = _system(B, 41, 36, 15, cuda)
        counts = _btd_counts()
        btd_solve(D, L, b)
        assert _btd_counts()[2:] == counts[2:], B


@pytest.mark.parametrize("B,K", [(1, 154), (1, 129), (1, 74), (2, 154), (REDUCE_MAX_BATCH, 154)])
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_reduce_kernel_matches_plain(cuda, B, K, damped):
    """The long-horizon kernel at the one-shot plan's horizon (154), the
    reference's 8 s tile (129), the first horizon past the small kernel's
    shared memory (74), and at batches up to its crossover: within ATOL of
    the plain solve (of the damped copy when damped), and damped, bit for
    bit its own undamped launch on the damped copy; D left as it was."""
    D, L, b, xt = _system(B, K, 36, 16 + K, cuda)
    gen = torch.Generator(device=cuda).manual_seed(K)
    lm = 10.0 ** (torch.rand((B,), generator=gen, device=cuda) * 4.3 - 4.0) if damped else None
    D0 = D.clone()
    x = _launch("btd_reduce_solve_f32", D, L, b, lm)
    if damped:
        Dd = _damped_copy(D, lm)
        copy = _launch("btd_reduce_solve_f32", Dd, L, b)
        torch.cuda.synchronize()
        assert torch.equal(x, copy), float((x - copy).abs().max())
        assert torch.equal(D, D0)
        torch.testing.assert_close(x, block_tridiag_solve(Dd, L, b), rtol=0, atol=ATOL)
    else:
        torch.cuda.synchronize()
        torch.testing.assert_close(x, block_tridiag_solve(D, L, b), rtol=0, atol=ATOL)
        torch.testing.assert_close(x, xt, rtol=0, atol=ATOL)


def test_reduce_kernel_pivot_clamp(cuda):
    """test_kernel_pivot_clamp's system, row 3 of D_0 decoupled with its
    pivot below the clamp, at K = 154 through the long-horizon kernel."""
    D, L, _, xt = _system(1, 154, 12, 8, cuda)
    D[:, 0, 3, :] = 0
    D[:, 0, :, 3] = 0
    D[:, 0, 3, 3] = 1e-13
    L[:, 0, :, 3] = 0
    b = block_tridiag_matvec(D, L, xt).contiguous()
    x = _launch("btd_reduce_solve_f32", D, L, b)
    xp = block_tridiag_solve(D, L, b)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(xp).all())
    torch.testing.assert_close(x, xp, rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("side", ["at", "past"])
def test_reduce_dispatch_on_each_side_of_its_crossover(cuda, side):
    """At K = 154 btd_solve launches the long-horizon kernel up to
    REDUCE_MAX_BATCH scenarios and btd_kernel past it, each call counted
    long and, on the long-horizon kernel, in reduce_launches; either way x
    within ATOL of the plain solve."""
    B = REDUCE_MAX_BATCH + (side == "past")
    reduce = side == "at"
    assert btd.picks_reduce(B, 154, 36) == reduce
    D, L, b, _ = _system(B, 154, 36, 17, cuda)
    counts = _btd_counts()
    x = btd_solve(D, L, b)
    torch.cuda.synchronize()
    assert _btd_counts() == (counts[0] + 1, counts[1], counts[2] + 1, counts[3] + reduce)
    torch.testing.assert_close(x, block_tridiag_solve(D, L, b), rtol=0, atol=ATOL)


def test_reduce_kernel_is_one_launch_in_the_trace(cuda):
    """A profiler's trace of one solve at (1, 154, 36), read as the
    benchmark reads the BTD solve (`benchmark.trace.kernel_time` by the word
    btd_kernel): one launch, and none of the small kernel."""
    from benchmark import trace

    D, L, b, _ = _system(1, 154, 36, 18, cuda)
    btd_solve(D, L, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            btd_solve(D, L, b)
            torch.cuda.synchronize()
    summary = trace.summarize(prof, trace.SPAN_PREFIX + "window")
    launches, seconds = trace.kernel_time(summary, "btd_kernel")
    assert launches == 1 and seconds > 0, summary["kernels"]
    assert trace.kernel_time(summary, "btd_small_kernel")[0] == 0
    assert any("reduce::btd_kernel" in name for name in summary["kernels"]), summary["kernels"]


def test_reduce_kernel_in_a_cuda_graph(cuda):
    """Captured under torch.cuda.graph at (1, 154, 36), damped, the solve
    replays to the eager x bit for bit, and again on new inputs copied into
    the captured ones."""
    D, L, b, _ = _system(1, 154, 36, 19, cuda)
    lm = torch.full((1,), 0.3, device=cuda)
    eager = btd_solve(D, L, b, lm=lm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        btd_solve(D, L, b, lm=lm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = btd_solve(D, L, b, lm=lm)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    D2, L2, b2, _ = _system(1, 154, 36, 20, cuda)
    D.copy_(D2), L.copy_(L2), b.copy_(b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, btd_solve(D2, L2, b2, lm=lm))


def test_small_kernel_launch_error_raises(cuda, monkeypatch):
    """No fallback: a small-batch launch the card refuses (its factors do not
    fit) raises, and no other kernel runs in its place."""
    monkeypatch.setattr(btd, "picks_small", lambda B, K, n: True)
    D, L, b, _ = _system(1, 74, 36, 12, cuda)
    launches = btd_solve.launches
    with pytest.raises(RuntimeError, match="small-batch kernel launch failed"):
        btd_solve(D, L, b)
    assert btd_solve.launches == launches


def _damped_copy(D, lm):
    """The copy of D the LM loop damped before the kernel took lm."""
    return D + torch.diag_embed(lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8)


@pytest.mark.parametrize("B,K,n", [(1, 41, 36), (4, 41, 36), (64, 41, 36), (1024, 41, 36)])
def test_damped_kernel_equals_undamped_on_the_copy(cuda, B, K, n):
    """Damped by lm, btd_solve's x is the undamped solve of the damped copy
    bit for bit, D is left as it was and the call is counted as damped; each
    kernel, launched past the wrapper, damped equals itself undamped on the
    copy and the other kernel damped."""
    D, L, b, _ = _system(B, K, n, 13, cuda)
    gen = torch.Generator(device=cuda).manual_seed(B)
    lm = 10.0 ** (torch.rand((B,), generator=gen, device=cuda) * 4.3 - 4.0)
    Dd, D0 = _damped_copy(D, lm), D.clone()
    counts = (btd_solve.launches, btd_solve.small_launches, btd_solve.damped_launches)
    small = picks_small(B, K, n)
    x = btd_solve(D, L, b, lm=lm)
    assert (btd_solve.launches, btd_solve.small_launches, btd_solve.damped_launches) == (
        counts[0] + 1, counts[1] + small, counts[2] + 1)
    copy = btd_solve(Dd, L, b)
    assert btd_solve.damped_launches == counts[2] + 1
    xs = {e: (_launch(e, D, L, b, lm), _launch(e, Dd, L, b)) for e in ("btd_solve_f32", "btd_small_solve_f32")}
    torch.cuda.synchronize()
    assert torch.equal(D, D0)
    assert torch.equal(x, copy), float((x - copy).abs().max())
    for entry, (damped, undamped) in xs.items():
        assert torch.equal(damped, undamped), (entry, float((damped - undamped).abs().max()))
        assert torch.equal(damped, x), entry
    torch.testing.assert_close(x, block_tridiag_solve(Dd, L, b), rtol=0, atol=ATOL)


def test_solve_batch_counts_damped_launches(cuda):
    """Every LM iteration of solve_batch hands its damping to the kernel:
    one damped launch per iteration, at B = 4 on the small kernel."""
    from qtos_torch.solver import SolverConfig, default_spec, solve_batch
    from qtos_torch.terrain import make_terrain

    terr = make_terrain(["plane", "plane"], device=cuda)
    specs = default_spec(terr, goal_xy=(np.linspace(0.2, 0.5, 4).astype(np.float32), 0.0), K=41, device=cuda)
    btd_solve.launches = btd_solve.small_launches = btd_solve.damped_launches = 0
    res = solve_batch(specs, terr, SolverConfig(max_iters=5))
    torch.cuda.synchronize()
    iters = int(res.iters.max())
    assert iters == 5
    assert btd_solve.damped_launches == btd_solve.launches == btd_solve.small_launches == iters


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


def _episodes(dev, B=4, K=13):
    """B short trot windows solved on `dev`: (terrain, tables (B, T, 37))."""
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
    from qtos_torch.solver.spec import index_spec
    from qtos_torch.terrain import make_terrain

    terr = make_terrain(["plane", "plane"], device=dev)
    goals = np.linspace(0.15, 0.45, B).astype(np.float32)
    specs = default_spec(terr, goal_xy=(goals, 0.0), K=K, duration=1.5, device=dev)
    res = solve_batch(specs, terr, SolverConfig(max_iters=3))
    tables = torch.stack([sample_trajectory(res.x[i], index_spec(specs, i))[0] for i in range(B)])
    return terr, tables


def test_sim_step_on_card_matches_cpu(cuda):
    """One batched physics step from moving states with feet in the ground:
    atol 1e-5, as the CPU parity test against the reference."""
    from qtos_torch.control import ControlParams
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.sim import SimParams, sim_step
    from qtos_torch.solver.spec import map_tensors
    from qtos_torch.terrain import make_terrain

    terr, tables = _episodes(cuda)
    rng = np.random.default_rng(0)
    state = state_from_row(tables[:, 200], terr, ControlParams(), drop=-0.002)
    B = tables.shape[0]
    noise = lambda scale, shape: torch.from_numpy((scale * rng.uniform(-1, 1, size=shape)).astype(np.float32)).to(cuda)
    state = dataclasses.replace(state, v=noise(0.2, (B, 3)), w=noise(0.3, (B, 3)), qd=noise(1.0, (B, 12)))
    tau = noise(4.0, (B, 12))
    out = sim_step(state, tau, terr, SimParams())
    terr_cpu = make_terrain(["plane", "plane"], device="cpu")
    ref = sim_step(map_tensors(state, lambda t: t.cpu()), tau.cpu(), terr_cpu, SimParams())
    for f in dataclasses.fields(out):
        torch.testing.assert_close(getattr(out, f.name).cpu(), getattr(ref, f.name), rtol=0, atol=1e-5,
                                   msg=lambda m, n=f.name: f"{n}: {m}")


def test_playback_on_card_matches_cpu(cuda):
    """100 ticks of the control loop over 4 episodes, card against CPU.  Stiff
    penalty contact amplifies rounding differences tick by tick; the smoke
    run's bounds after 500 + 500 ticks (1e-4 m, 5e-4 rad, 0.5 %) scaled to
    the 100 ticks played here."""
    from qtos_torch.control import ControlParams, playback, stance_warmup
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.terrain import make_terrain

    terr, tables = _episodes(cuda)
    tables = tables[:, :100].contiguous()       # the tick kernel takes a contiguous table
    out = {}
    for dev in (cuda, torch.device("cpu")):
        terr_d = terr if dev.type == "cuda" else make_terrain(["plane", "plane"], device="cpu")
        tab = tables.to(dev)
        params = ControlParams()
        s0 = stance_warmup(state_from_row(tab[:, 0], terr_d, params), terr_d, params, 50)
        final, m = playback(tab, s0, terr_d, params)
        assert final.pos.device.type == dev.type and m.pos.device.type == dev.type
        out[dev.type] = (final.pos.cpu(), final.q.cpu(), m.pos.cpu(), m.avg_com_err_per_s.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=2e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=0, atol=2e-5)
    torch.testing.assert_close(out["cuda"][3], out["cpu"][3], rtol=1e-3, atol=0)


def test_tick_kernel_matches_plain_on_card(cuda):
    """The tick kernel against the plain loop, both on the card: 4 episodes,
    700 ticks on flat ground, one launch.  Over the first 500 ticks the gates
    of chip_smoke.py's phase 6c (1e-4 m, 5e-4 rad, 0.5 %); over all 700 the
    larger of those and twice what the plain loop on the card and on the CPU
    differ by on the same inputs: past ~500 ticks any two float32 versions
    of the loop part (phase 6e, PERF.md)."""
    from qtos_torch.control import ControlParams
    from qtos_torch.control.loop import _hold_ticks, _metrics, _scan_ticks, state_from_row
    from qtos_torch.ops.tick import tick_scan
    from qtos_torch.solver.spec import map_tensors

    terr, tables = _episodes(cuda)
    tables = tables[:, :700].contiguous()
    params = ControlParams()
    s0 = _hold_ticks(state_from_row(tables[:, 0], terr, params), terr, params, 100)
    before = tick_scan.launches
    _, traces_k = tick_scan(tables, s0, terr, params)
    torch.cuda.synchronize()
    assert tick_scan.launches == before + 1
    _, traces_p = _scan_ticks(tables, s0, terr, params)
    cpu = lambda t: t.cpu()  # noqa: E731
    _, traces_c = _scan_ticks(tables.cpu(), map_tensors(s0, cpu), map_tensors(terr, cpu), params)
    assert tick_scan.launches == before + 1

    def spread(a, b, n):
        a, b = ({k: v[:, :n].cpu() for k, v in x.items()} for x in (a, b))
        ma, mb = _metrics(a, n), _metrics(b, n)
        return (float((a["pos"] - b["pos"]).abs().max()), float((a["q"] - b["q"]).abs().max()),
                float(((ma.avg_com_err_per_s - mb.avg_com_err_per_s).abs() / mb.avg_com_err_per_s).max()))

    gates = (1e-4, 5e-4, 5e-3)
    early = spread(traces_k, traces_p, 500)
    assert all(e <= g for e, g in zip(early, gates)), early
    full, plain_pair = spread(traces_k, traces_p, 700), spread(traces_p, traces_c, 700)
    assert all(f <= max(g, 2 * p) for f, g, p in zip(full, gates, plain_pair)), (full, plain_pair)


@pytest.mark.parametrize("B", [5, 33])
def test_tick_kernel_ragged_batch_matches_plain(cuda, B):
    """B = 5 and 33 episodes, not multiples of the kernel's 8 episodes per
    block, with per-episode n_valid 0, 166, 333 and 500: the kernel against
    the plain loop, both on the card, over 500 ticks at the gates of
    chip_smoke.py's phase 6c (1e-4 m, 5e-4 rad, 0.5 %), in one launch."""
    from qtos_torch.control import ControlParams
    from qtos_torch.control.loop import _hold_ticks, _metrics, _scan_ticks, state_from_row
    from qtos_torch.ops.tick import tick_scan

    terr, tables = _episodes(cuda, B=B)
    tables = tables[:, :500].contiguous()
    params = ControlParams()
    s0 = _hold_ticks(state_from_row(tables[:, 0], terr, params), terr, params, 100)
    n_valid = torch.tensor([500 * (i % 4) // 3 for i in range(B)], device=cuda)
    before = tick_scan.launches
    final_k, traces_k = tick_scan(tables, s0, terr, params, n_valid)
    torch.cuda.synchronize()
    assert tick_scan.launches == before + 1
    final_p, traces_p = _scan_ticks(tables, s0, terr, params, n_valid)
    mk, mp = _metrics(traces_k, n_valid), _metrics(traces_p, n_valid)
    rel = float(((mk.avg_com_err_per_s - mp.avg_com_err_per_s).abs() / mp.avg_com_err_per_s).nan_to_num().max())
    assert float((traces_k["pos"] - traces_p["pos"]).abs().max()) <= 1e-4
    assert float((traces_k["q"] - traces_p["q"]).abs().max()) <= 5e-4
    assert rel <= 5e-3
    assert float((final_k.pos - final_p.pos).abs().max()) <= 1e-4
    assert float((final_k.q - final_p.q).abs().max()) <= 5e-4


def test_tick_kernel_launches_once_per_call(cuda):
    """`playback` (with an int and a per-episode `n_valid`), `playback_recorded`
    and `stance_warmup` each launch the kernel exactly once; n_valid = 0
    leaves an episode in its start state bit for bit."""
    from qtos_torch.control import ControlParams, playback, stance_warmup
    from qtos_torch.control.loop import playback_recorded, state_from_row
    from qtos_torch.ops.tick import tick_hold, tick_scan

    terr, tables = _episodes(cuda)
    tables = tables[:, :50].contiguous()
    params = ControlParams()
    scan0, hold0 = tick_scan.launches, tick_hold.launches
    s0 = stance_warmup(state_from_row(tables[:, 0], terr, params), terr, params, 30)
    assert (tick_scan.launches, tick_hold.launches) == (scan0, hold0 + 1)
    playback(tables, s0, terr, params, n_valid=20)
    final, _ = playback(tables, s0, terr, params, n_valid=torch.tensor([50, 20, 0, 1], device=cuda))
    _, _, traces = playback_recorded(tables[0], stance_warmup(_episode0(s0), terr, params, 5), terr, params)
    torch.cuda.synchronize()
    assert (tick_scan.launches, tick_hold.launches) == (scan0 + 3, hold0 + 2)
    assert torch.equal(final.q[2], s0.q[2]) and torch.equal(final.anchor[2], s0.anchor[2])
    assert tuple(traces["q"].shape) == (50, 12) and bool(torch.isfinite(traces["tau"]).all())


def _episode0(state):
    """Episode 0 of a batched state."""
    import dataclasses

    return dataclasses.replace(state, **{f.name: getattr(state, f.name)[0].contiguous()
                                         for f in dataclasses.fields(state)})


def test_tick_kernel_rejects_bad_tables(cuda):
    """A mis-shaped or non-contiguous table raises on the card; nothing falls
    back to the plain loop."""
    from qtos_torch.control import ControlParams, playback
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.ops.tick import tick_scan

    terr, tables = _episodes(cuda)
    params = ControlParams()
    s0 = state_from_row(tables[:, 0], terr, params)
    before = tick_scan.launches
    with pytest.raises(ValueError, match="contiguous"):
        playback(tables[:, ::2], s0, terr, params)
    with pytest.raises(ValueError, match="T, 37"):
        playback(tables[..., :36].contiguous(), s0, terr, params)
    with pytest.raises(TypeError, match="float32"):
        playback(tables.double(), s0, terr, params)
    with pytest.raises(ValueError, match="state.pos"):
        playback(tables[:2].contiguous(), s0, terr, params)
    assert tick_scan.launches == before


def test_realtime_pacing_no_underruns_on_card(tmp_path, monkeypatch, cuda):
    """`qtos_tpu`'s real-time canary (tests/test_realtime.py) on the card: the
    same config, the same three asserts."""
    from qtos_torch.control.replan import RecedingHorizonRunner, RunnerConfig
    from qtos_torch.terrain import make_terrain

    monkeypatch.chdir(tmp_path)
    terrain = make_terrain(["plane", "plane"])
    cfg = RunnerConfig(realtime=True, max_windows=6)
    runner = RecedingHorizonRunner(terrain, (0.8, 0.0), cfg=cfg)
    rep = runner.run(verbose=False)
    assert rep.underruns == 0
    assert 0.99 <= rep.realtime_factor < 1.5, rep.realtime_factor
    assert rep.sim_ticks > 2000


def test_runner_two_windows_on_card(cuda, tmp_path, monkeypatch):
    """Two windows of the receding-horizon runner on the card (1.5 s windows
    of K=25, 2 candidates): every solve goes through the kernel, the plans
    converge, the robot stays up and advances, and the device buffer and its
    host mirror hold the same rows."""
    from qtos_torch.control.replan import RecedingHorizonRunner, RunnerConfig
    from qtos_torch.solver import SolverConfig
    from qtos_torch.terrain import make_terrain

    monkeypatch.chdir(tmp_path)                  # a failed window writes ./logs/failed_window.npz
    cfg = RunnerConfig(K=25, window_duration=1.5, f_steps=600, lookahead=900, n_candidates=2,
                       stance_warmup_steps=100, max_windows=2,
                       solver=SolverConfig(max_iters=20, tol=3e-3))
    runner = RecedingHorizonRunner(make_terrain(["plane", "plane"]), (1.0, 0.0), cfg=cfg)
    assert runner.device.type == "cuda" and runner.buffer.device.type == "cuda"
    btd_solve.launches = 0
    rep = runner.run(verbose=False)
    assert rep.windows == 3 and rep.statuses == [0, 0, 0] and rep.sim_ticks == 1200
    assert btd_solve.launches == 20 * rep.windows + cfg.escalate_iters * runner.escalations
    assert not rep.aborted and rep.stance_holds == 0
    assert 0.15 < rep.final_pos[2] < 0.35 and rep.final_pos[0] > 0.05
    assert np.isfinite(rep.com_err_series).all() and rep.avg_com_err_per_s < 120.0
    end = runner.buffer_end
    np.testing.assert_array_equal(runner.buffer[:end].cpu().numpy(), runner.host_buf.read(0, end))
    assert runner.host_buf.is_native


# Card against CPU over exp_2's first riser: the first RISER_TICKS ticks of the
# window, which cover the first touchdown after a front foot has borne load on
# the riser's ramp (tick 562; chip_smoke.py phase 6d plays all 2,501 and holds
# the same gates, PERF.md has the readings).
RISER_TICKS = 700
RISER_DPOS, RISER_DQ, RISER_FIRST_TICK = 4e-2, 0.15, 400


def test_riser_playback_on_card_matches_cpu(cuda):
    """The exp_2 window over step_2's riser (`qtos_torch.tools.riser`), solved
    and warmed up on the CPU, played from the same table and start state on
    the card and on the CPU in lock step."""
    from qtos_torch.tools import riser

    terrain, table, status, s0 = riser.riser_window("cpu")
    assert status == 0
    rep = riser.divergence(table, s0, terrain, cuda, ticks=RISER_TICKS)
    assert rep["ticks"] == RISER_TICKS
    assert rep["first_position_tick"] is None or rep["first_position_tick"] >= RISER_FIRST_TICK, rep
    assert rep["final_dpos"] <= RISER_DPOS and rep["final_dq"] <= RISER_DQ, rep


def _bench_specs(dev, B, K=41):
    from qtos_torch.solver import SolverConfig, default_spec
    from qtos_torch.terrain import make_terrain

    terrain = make_terrain(["plane"] * 3, device=dev)
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, B, device=dev), 0.0), K=K, device=dev)
    return terrain, specs, SolverConfig(max_iters=3, rescue_iters=12)


def test_sharded_solve_at_world_size_one_equals_solve_batch(cuda):
    """NCCL with one rank: the slice is the whole batch, so the arithmetic and
    the result are solve_batch's, bit for bit; the gathers go through NCCL."""
    import torch.distributed as dist

    from qtos_torch.parallel.distributed import global_scenario_mesh, initialize_multihost, solve_batch_collective
    from qtos_torch.parallel.mesh import solve_batch_sharded
    from qtos_torch.parallel.worker import free_port
    from qtos_torch.solver import solve_batch

    terrain, specs, cfg = _bench_specs(cuda, 64)
    plain = solve_batch(specs, terrain, cfg)
    dev = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = global_scenario_mesh(device=dev)
        assert dist.get_backend() == "nccl" and mesh.world == 1
        btd_solve.launches = 0
        res = solve_batch_sharded(specs, terrain, cfg, mesh)
        assert btd_solve.launches >= cfg.max_iters
        x_loc, st_loc, st_all = solve_batch_collective(specs, terrain, cfg, mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(res.x, plain.x) and torch.equal(res.status, plain.status)
    assert torch.equal(st_all, st_loc) and torch.equal(x_loc, plain.x)


def test_sharded_solve_over_two_cards():
    """Two NCCL ranks, one card each, with batches the world size does not
    divide: every rank's gathered statuses are the ranks' own, concatenated."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from qtos_torch.parallel.worker import run_ranks, solve_cases

    outs = run_ranks(solve_cases, 2, "cuda", (5, 1023), timeout=600)
    for i, B in enumerate((5, 1023)):
        local = np.concatenate([r[i]["status_local"] for r in outs])
        assert local.shape == (B,)
        for r in outs:
            np.testing.assert_array_equal(r[i]["status_gathered"], local)
            assert r[i]["x"].shape == (B, 13, 36)


# ---- the assembly kernel (qtos_torch/csrc/assemble.cu) -------------------------
# Held to the plain version on the card at atol=rtol=2e-4, tests/test_torch_assemble.py's
# tolerance, plus 1e-5 of each entry's rounding scale (the sum of its terms'
# magnitudes, qtos_torch/tools/check_assemble.py), at the shapes the paths give it: the quick start (1, 33), a replan
# (4, 41), the feasibility probe (20, 25), the card-vs-CPU solve (64, 41) and
# the bench batch (8192, 41), and at (2, 45), whose windows run in two chunks
# of the kernel's shared memory; on the bench distribution's first iterate and on
# a perturbed one over step terrain with every hinge family active.


@pytest.mark.parametrize("kind", ["bench", "steps"])
@pytest.mark.parametrize("B,K", [(1, 33), (4, 41), (20, 25), (64, 41), (8192, 41), (2, 45), (1, 154)])
def test_assemble_kernel_matches_plain(cuda, kind, B, K):
    from qtos_torch.tools import check_assemble

    row = check_assemble.compare(kind, B, K, cuda)
    assert row["finite"] and row["bitwise_repeatable"], row
    assert max(row["gate_shares"].values()) <= 1.0, row


def test_assemble_kernel_is_repeatable(cuda):
    """Two launches on one input agree bit for bit (no atomics, fixed order)."""
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.tools import check_assemble

    p = check_assemble.problem("steps", 64, 41, cuda)
    args = (p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    first, second = assemble_kernel(*args), assemble_kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_assemble_launches_once_per_call(cuda):
    """`assemble` on the card is one launch of the kernel; `solve_batch`
    launches it once per LM iteration, as it launches the BTD kernel."""
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.solver import solve_batch
    from qtos_torch.solver.assemble import assemble
    from qtos_torch.tools import check_assemble

    p = check_assemble.problem("bench", 4, 41, cuda)
    before = assemble_kernel.launches
    assemble(p["x"], p["specs"], p["terrain"], p["cfg"])
    assert assemble_kernel.launches == before + 1
    terrain, specs, cfg = _bench_specs(cuda, 8)
    assemble_kernel.launches = btd_solve.launches = 0
    solve_batch(specs, terrain, cfg)
    assert assemble_kernel.launches == btd_solve.launches >= cfg.max_iters


def test_assemble_counts_chunked_launches(cuda):
    """The one-shot plan's window of 154 knots runs in 4 chunks of the
    kernel's shared memory: the launch is counted in `chunked_launches`; a
    window of 41 knots, one chunk, is not."""
    from qtos_torch.ops.assemble import KERNEL, assemble_kernel
    from qtos_torch.tools import check_assemble

    assert KERNEL.load().assemble_chunk(154) == 39 and KERNEL.load().assemble_chunk(41) == 41
    for (B, K), chunked in (((1, 154), 1), ((4, 41), 0)):
        p = check_assemble.problem("bench", B, K, cuda)
        counts = (assemble_kernel.launches, assemble_kernel.chunked_launches)
        check_assemble.kernel(p)
        assert (assemble_kernel.launches, assemble_kernel.chunked_launches) == (counts[0] + 1, counts[1] + chunked)


def test_solve_batch_statuses_equal_the_plain_assembly_on_card(cuda, monkeypatch):
    """The bench distribution at B=64 through the kernel and through the
    plain assembly, both on the card: equal statuses, x within the solver
    tolerance 5e-3 (phase 5's gate between card and CPU)."""
    import importlib

    from qtos_torch.solver import solve_batch
    from qtos_torch.solver.assemble import assemble_plain

    solve_mod = importlib.import_module("qtos_torch.solver.solve")
    terrain, specs, cfg = _bench_specs(cuda, 64)
    kern = solve_batch(specs, terrain, cfg)
    monkeypatch.setattr(solve_mod, "assemble", assemble_plain)
    plain = solve_batch(specs, terrain, cfg)
    assert torch.equal(kern.status, plain.status)
    torch.testing.assert_close(kern.x, plain.x, rtol=0, atol=5e-3)


def test_assemble_kernel_rejects_bad_inputs(cuda):
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.solver.spec import map_tensors
    from qtos_torch.tools import check_assemble

    p = check_assemble.problem("bench", 4, 41, cuda)
    rest = (p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
    with pytest.raises(ValueError, match="contiguous x"):
        assemble_kernel(p["x"].transpose(0, 1).contiguous().transpose(0, 1), *rest)
    with pytest.raises(ValueError, match="B, K, 36"):
        assemble_kernel(p["x"][..., :35].contiguous(), *rest)
    cpu_terrain = map_tensors(p["terrain"], lambda t: t.cpu())
    with pytest.raises(ValueError, match="different devices"):
        assemble_kernel(p["x"], p["specs"], cpu_terrain, p["cfg"], p["aux"], p["slope"])


def test_bench_time_solves_on_card(cuda):
    """bench_torch.time_solves on the card at B=64: every scenario converged
    in every call, and one launch of each solver kernel per LM iteration."""
    import os
    import sys

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    try:
        import bench_torch
    finally:
        sys.path.pop(0)
    specs, terrain = bench_torch.build_specs(64, cuda)
    cfg = bench_torch.solver_config()
    t = bench_torch.time_solves(specs, terrain, cfg, repeats=2)
    assert t["B"] == 64 and t["converged"] == 64 and len(t["seconds"]) == 2
    assert t["btd_launches"] == t["assemble_launches"] == t["restore_launches"] == [cfg.max_iters] * 2


# The LM loop's restore kernel (qtos_torch/csrc/lm_restore.cu): against its
# plain version and `torch.where` bit for bit at the sweep's and the replan's
# shapes, and `solve_batch` through it against the frozen `torch.where` loop
# of tests/test_torch_lm_restore.py.


@pytest.mark.parametrize("case", ["accepted", "rejected", "mixed", "zero_fill"])
@pytest.mark.parametrize("B,K", [(8192, 41), (4, 41), (1, 41)])
def test_restore_kernel_matches_plain(cuda, B, K, case):
    from test_torch_lm_restore import expected, systems

    from qtos_torch.ops.lm_restore import restore_rejected, restore_rejected_plain

    accept, fresh, kept = systems(B, K, case, seed=B + K)
    accept, fresh = accept.to(cuda), tuple(t.to(cuda) for t in fresh)
    kept = None if kept is None else tuple(t.to(cuda) for t in kept)
    dst, plain = tuple(t.clone() for t in fresh), tuple(t.clone() for t in fresh)
    launches = restore_rejected.launches
    restore_rejected(accept, dst, kept)
    assert restore_rejected.launches == launches + 1
    restore_rejected_plain(accept, plain, kept)
    torch.cuda.synchronize()
    for got, p, want in zip(dst, plain, expected(accept, fresh, kept)):
        assert torch.equal(got, p) and torch.equal(got, want)


def test_restore_kernel_rejects_bad_inputs(cuda):
    from test_torch_lm_restore import systems

    from qtos_torch.ops.lm_restore import restore_rejected

    accept, fresh, kept = systems(4, 41, "mixed", seed=11)
    accept, fresh, kept = accept.to(cuda), tuple(t.to(cuda) for t in fresh), tuple(t.to(cuda) for t in kept)
    with pytest.raises(ValueError, match="different devices"):
        restore_rejected(accept, (fresh[0].cpu(), *fresh[1:]), None)
    with pytest.raises(ValueError, match="not a contiguous copy"):
        restore_rejected(accept, fresh, (kept[0].cpu(), *kept[1:]))
    with pytest.raises(TypeError, match="float32"):
        restore_rejected(accept, (fresh[0].half(), *fresh[1:]), None)
    with pytest.raises(ValueError, match="bool accept"):
        restore_rejected(accept.float(), fresh, kept)
    with pytest.raises(ValueError, match="for a batch of 3"):
        restore_rejected(accept[:3], fresh, kept)
    with pytest.raises(ValueError, match="not a contiguous copy"):
        restore_rejected(accept, fresh, (kept[0][:, :-1].contiguous(), *kept[1:]))
    with pytest.raises(ValueError, match="contiguous tensors"):
        restore_rejected(accept, (fresh[0].transpose(2, 3), *fresh[1:]), None)
    shifted = torch.empty(fresh[0].numel() + 1, device=cuda)[1:].view(fresh[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        restore_rejected(accept, (shifted, *fresh[1:]), None)


@pytest.mark.parametrize("B", [4, 8192])
def test_solve_batch_equals_the_where_loop_on_card(cuda, B, monkeypatch):
    """`solve_batch` through the restore kernel gives the frozen `torch.where`
    loop's x, status, merit, max_violation and viol bit for bit: the sweep's
    batch (three LM iterations and the rescue pass) and the replan's (30 LM
    iterations, which reject steps: asserted), one restore launch per LM
    iteration."""
    import importlib

    from test_torch_lm_restore import assert_results_equal, where_pass

    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.lm_restore import restore_rejected
    from qtos_torch.solver import SolverConfig, solve_batch

    solve_mod = importlib.import_module("qtos_torch.solver.solve")
    terrain, specs, cfg = _bench_specs(cuda, B)
    if B == 4:
        cfg = SolverConfig(max_iters=30, tol=3e-3)
    rejected = []

    def spy(accept, dst, kept):
        rejected.append(~accept)
        restore_rejected(accept, dst, kept)

    monkeypatch.setattr(solve_mod, "restore_rejected", spy)
    restore_rejected.launches = assemble_kernel.launches = 0
    new = solve_batch(specs, terrain, cfg)
    assert restore_rejected.launches == assemble_kernel.launches == len(rejected) >= cfg.max_iters
    if B == 4:
        assert int(torch.stack(rejected).sum()) > 0, "the replan's 30 iterations must reject a step"
    monkeypatch.setattr(solve_mod, "_solve_pass", where_pass)
    assert_results_equal(new, solve_batch(specs, terrain, cfg))


def test_replan_on_exp2_terrain_on_card_matches_cpu(cuda):
    """The benchmark's `replan.exp2` cell on the card: two replans of 4
    candidates at K=41 on exp_2's 0.05 m grid (step, step_1, step_2, plane),
    cut to 3 LM iterations, against the same replans on the CPU: knots,
    tables and contacts within `replan.exp1`'s start_gap limit (these
    replans read 3.3e-4 and 5.1e-4 on an H100; a terrain fault in the
    assembly reads some 0.08 or more), one `btd_small_kernel`, one assembly
    and one restore launch per LM iteration."""
    from benchmark import harness, program, traffic
    from benchmark.reference import compare

    from qtos_torch.control.replan import plan_windows_batch
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.lm_restore import restore_rejected

    iters, n_replans = 3, 2
    cell = harness.load_cell("replan.exp2")
    cfg = cell["cfg"]
    rcfg = program.runner_config(cfg)
    cut = rcfg.solver.replace(max_iters=iters)
    inputs = traffic.make(dict(cell["mix"], pool=n_replans), cfg, 2**31 + 20_023, "cpu")
    grid = harness.terrain_grid(cfg, "cpu")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        terr = program.terrain(grid.to(dev), cfg)
        btd_solve.launches = btd_solve.small_launches = assemble_kernel.launches = restore_rejected.launches = 0
        got = [plan_windows_batch(*(inputs[k][p].to(dev) for k in ("rows", "goals_r", "goals_yaw")), terr, rcfg,
                                  t0s=inputs["t0s"][p].to(dev), solver_cfg=cut) for p in range(n_replans)]
        launches = (btd_solve.launches, btd_solve.small_launches, assemble_kernel.launches, restore_rejected.launches)
        assert launches == ((iters * n_replans,) * 4 if dev.type == "cuda" else (0, 0, 0, 0)), launches
        out[dev.type] = [torch.cat([g[j] for g in got]).cpu() for j in (1, 2)] + [torch.cat([g[0].x for g in got]).cpu()]
    tables, contacts, x = out["cuda"]
    tables_cpu, contacts_cpu, x_cpu = out["cpu"]
    limit = 4e-3
    assert compare.knot_gap(x, x_cpu) <= limit
    assert compare.table_gap(tables, contacts, tables_cpu, contacts_cpu) <= limit


# The replan as a CUDA graph (`control/replan.py::plan_windows_batch`,
# `control/graphs.py`): the first call with a key runs eagerly, the second
# captures and replays, every later one replays.  Held bit for bit to the
# eager path, which a cache of size 0 gives (every call a key's first).
REPLAN_CELLS = {"exp_1": "replan.exp1", "exp_2": "replan.exp2"}


def _replan_world(preset, dev, pools):
    """The port's preset's terrain on `dev`, its benchmark cell's runner
    settings and `pools` replans of start rows from that cell's traffic."""
    from benchmark import harness, program, traffic

    from qtos_torch.config.experiments import get_experiment
    from qtos_torch.terrain import make_terrain

    cell = harness.load_cell(REPLAN_CELLS[preset])
    exp = get_experiment(preset)
    terr = make_terrain(exp.maps, scale_factor=exp.mesh_scale, device=dev)
    inputs = traffic.make(dict(cell["mix"], pool=pools), cell["cfg"], 2**31 + 23_017, dev)
    return terr, program.runner_config(cell["cfg"]), inputs


def _replan_outputs(out):
    res, tables, contacts = out
    return ([res.x, res.status, res.merit, res.max_violation, res.iters, tables, contacts]
            + [res.viol[k] for k in sorted(res.viol)])


# The launch counters an LM iteration of a replan moves by one each.
SOLVER_COUNTERS = ("btd_solve.launches", "btd_solve.small_launches", "btd_solve.damped_launches",
                   "assemble_kernel.launches", "restore_rejected.launches")


def _launch_counts() -> dict:
    """Every registered launch counter, by `wrapper.attribute`."""
    from qtos_torch.ops import cuda_lib

    return {f"{w.__name__}.{a}": getattr(w, a) for w, a in cuda_lib.LAUNCH_COUNTERS}


def _replans(monkeypatch, size, calls):
    """Each call's outputs, a copy of them taken as it returned, and the
    launches it counted on every registered counter, through a fresh graph
    cache of `size` keys."""
    from qtos_torch.control import replan
    from qtos_torch.control.graphs import GraphCache

    monkeypatch.setattr(replan, "_GRAPHS", GraphCache(size))
    monkeypatch.setattr(replan.plan_windows_batch, "captures", 0)
    monkeypatch.setattr(replan.plan_windows_batch, "replays", 0)
    outs, copies, launches = [], [], []
    for call in calls:
        before = _launch_counts()
        out = call()
        launches.append({k: n - before[k] for k, n in _launch_counts().items()})
        outs.append(_replan_outputs(out))
        copies.append([t.clone() for t in outs[-1]])
    return outs, copies, launches


def _assert_replays_are_eager(monkeypatch, calls, iters):
    from qtos_torch.control.replan import plan_windows_batch

    eager, _, eager_launches = _replans(monkeypatch, 0, calls)
    assert plan_windows_batch.captures == plan_windows_batch.replays == 0
    graph, copies, graph_launches = _replans(monkeypatch, 16, calls)
    assert (plan_windows_batch.captures, plan_windows_batch.replays) == (1, len(calls) - 1)
    assert eager_launches == graph_launches
    assert all(n == (iters if name in SOLVER_COUNTERS else 0) for d in graph_launches for name, n in d.items())
    assert all(name in graph_launches[0] for name in SOLVER_COUNTERS)
    for n, (e, g, c) in enumerate(zip(eager, graph, copies)):
        assert all(torch.equal(a, b) for a, b in zip(e, g)), f"call {n}: the replay is not the eager path's"
        # the caller's tensors of call n are its own: later replays leave them
        assert all(torch.equal(a, b) for a, b in zip(g, c)), f"call {n}'s outputs changed under a later call"


@pytest.mark.parametrize("preset", sorted(REPLAN_CELLS))
def test_replan_graph_replays_bit_for_bit(cuda, monkeypatch, preset):
    """Five replans of different start rows with one key, on exp_1's flat
    grid and on exp_2's climb: one eager call, one capture, and four pools
    through the one graph, every output bit for bit the eager path's, the
    launch counters the eager path's."""
    from qtos_torch.control.replan import plan_windows_batch

    terr, rcfg, i = _replan_world(preset, cuda, pools=5)
    calls = [lambda p=p: plan_windows_batch(i["rows"][p], i["goals_r"][p], i["goals_yaw"][p], terr, rcfg,
                                            t0s=i["t0s"][p]) for p in range(5)]
    _assert_replays_are_eager(monkeypatch, calls, rcfg.solver.max_iters)


@pytest.mark.parametrize("key", ["x0", "iters3", "k3"])
def test_replan_graph_other_keys(cuda, monkeypatch, key):
    """The keys a walk and the benchmark meet besides the plain one: warm
    starts (`x0`, another per call), the start check's 3 LM iterations, 3
    candidates."""
    from qtos_torch.control.replan import plan_windows_batch

    terr, rcfg, i = _replan_world("exp_1", cuda, pools=4)
    k = 3 if key == "k3" else 4
    cut = rcfg.solver.replace(max_iters=3) if key == "iters3" else None
    warm = [None] * 4
    if key == "x0":
        warm = [plan_windows_batch(i["rows"][p], i["goals_r"][p], i["goals_yaw"][p], terr, rcfg,
                                   solver_cfg=rcfg.solver.replace(max_iters=2))[0].x for p in range(4)]
    calls = [lambda p=p: plan_windows_batch(i["rows"][p][:k], i["goals_r"][p][:k], i["goals_yaw"][p][:k], terr,
                                            rcfg, t0s=i["t0s"][p][:k], x0=warm[p], solver_cfg=cut)
             for p in range(4)]
    _assert_replays_are_eager(monkeypatch, calls, 3 if cut is not None else rcfg.solver.max_iters)


def test_replayed_replan_records_one_replay_span(cuda, monkeypatch):
    """Under a profiler a replayed call is the `qtos::replan` root with one
    `qtos::replan.replay` child (n = k): the host runs none of the stages."""
    from qtos_torch.control import replan
    from qtos_torch.control.graphs import GraphCache
    from qtos_torch.utils import profiling

    terr, rcfg, i = _replan_world("exp_1", cuda, pools=1)
    monkeypatch.setattr(replan, "_GRAPHS", GraphCache(16))

    def call():
        return replan.plan_windows_batch(i["rows"][0], i["goals_r"][0], i["goals_yaw"][0], terr, rcfg,
                                         t0s=i["t0s"][0])

    call(), call()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        call()
        torch.cuda.synchronize()
    records = profiling.spans()
    assert [(r["name"], r["n"], r["parent"]) for r in records] == [("qtos::replan", 4, None),
                                                                  ("qtos::replan.replay", 4, 0)]


def test_replayed_replan_launches_what_its_counters_count(cuda, monkeypatch):
    """The kernels a replay runs, counted in a profiler's trace of one
    replayed call, are those its counters add: one BTD solve on the
    small-batch kernel, one assembly and one LM restore per LM iteration.
    (A replay's counters add what its capture counted, so only the trace
    shows what the card ran.)"""
    from qtos_torch.control import replan
    from qtos_torch.control.graphs import GraphCache

    terr, rcfg, i = _replan_world("exp_1", cuda, pools=1)
    monkeypatch.setattr(replan, "_GRAPHS", GraphCache(16))

    def call():
        return replan.plan_windows_batch(i["rows"][0], i["goals_r"][0], i["goals_yaw"][0], terr, rcfg,
                                         t0s=i["t0s"][0])

    call(), call()
    replays, before = replan.plan_windows_batch.replays, _launch_counts()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    counted = {k: n - before[k] for k, n in _launch_counts().items()}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = {kernel: sum(kernel in n for n in names)
              for kernel in ("btd_kernel", "btd_small_kernel", "assemble_kernel", "lm_restore_kernel")}
    iters = rcfg.solver.max_iters
    assert replan.plan_windows_batch.replays == replays + 1
    assert traced == {"btd_kernel": 0, "btd_small_kernel": iters, "assemble_kernel": iters,
                      "lm_restore_kernel": iters}
    assert (counted["btd_solve.launches"], counted["btd_solve.small_launches"], counted["assemble_kernel.launches"],
            counted["restore_rejected.launches"]) == (traced["btd_kernel"] + traced["btd_small_kernel"],
                                                      traced["btd_small_kernel"], traced["assemble_kernel"],
                                                      traced["lm_restore_kernel"])


def test_oneshot_plan_on_card(cuda):
    """The benchmark's `oneshot.exp1` plan, exp_1's whole path as the port's
    one-shot mode sizes it (K=154, B=1, 80 LM iterations, goal 2.1 m):
    converged, with 80 launches of the long-horizon BTD kernel (never the
    small kernel), of the chunked assembly and of the restore, each counted
    in `long_launches`, `reduce_launches` and `chunked_launches`; a sweep's
    solve_batch at (8192, 41) counts in none of them."""
    from benchmark import harness, program

    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.lm_restore import restore_rejected
    from qtos_torch.solver import default_spec, solve_batch

    cfg = harness.load_cell("oneshot.exp1")["cfg"]
    terr = program.terrain(harness.terrain_grid(cfg, cuda), cfg)
    scfg = program.solver_config(cfg["solver"])
    specs = default_spec(terr, goal_xy=(torch.tensor([2.1], device=cuda), 0.0), duration=cfg["duration_s"],
                         K=cfg["K"], device=cuda)
    counters = {c: (w, c.split(".")[1]) for w, c in (
        (btd_solve, "btd_solve.launches"), (btd_solve, "btd_solve.small_launches"),
        (btd_solve, "btd_solve.long_launches"), (btd_solve, "btd_solve.reduce_launches"),
        (assemble_kernel, "assemble_kernel.launches"),
        (assemble_kernel, "assemble_kernel.chunked_launches"), (restore_rejected, "restore_rejected.launches"))}

    def counted(call):
        before = {c: getattr(w, a) for c, (w, a) in counters.items()}
        out = call()
        torch.cuda.synchronize()
        return out, {c: getattr(w, a) - before[c] for c, (w, a) in counters.items()}

    res, n = counted(lambda: solve_batch(specs, terr, scfg))
    iters = scfg.max_iters
    assert iters == 80 and int(res.status[0]) == 0, float(res.max_violation[0])
    assert n == {"btd_solve.launches": iters, "btd_solve.small_launches": 0, "btd_solve.long_launches": iters,
                 "btd_solve.reduce_launches": iters, "assemble_kernel.launches": iters,
                 "assemble_kernel.chunked_launches": iters, "restore_rejected.launches": iters}, n
    terrain, specs, cfg3 = _bench_specs(cuda, 8192)
    _, n = counted(lambda: solve_batch(specs, terrain, cfg3.replace(rescue_iters=0)))
    assert n["btd_solve.launches"] == cfg3.max_iters and n["btd_solve.long_launches"] == 0
    assert n["btd_solve.reduce_launches"] == 0
    assert n["assemble_kernel.chunked_launches"] == 0

