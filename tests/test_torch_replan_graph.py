"""The replan's CUDA graphs on the CPU: what decides a graph's key, the
cache's policy (eager at a key's first call, captured at its second,
replayed after, the least recently used dropped), a graph's bookkeeping of
the registered launch counters, that the CPU never captures, and the
solver's cached device constants against the per-call tensors they
replaced.  The graphs themselves run only on the card
(`tests/test_torch_gpu.py`)."""

import dataclasses
import importlib

import pytest
import torch

from qtos_torch.control import graphs, replan
from qtos_torch.control.replan import RunnerConfig, graph_key, plan_windows_batch
from qtos_torch.device import constant
from qtos_torch.ops import cuda_lib
from qtos_torch.solver import SolverConfig
from qtos_torch.solver.gait import make_schedule
from qtos_torch.solver.spec import NV, RobotState
from qtos_torch.terrain import make_terrain

K = 13


def _inputs(k=4, x0=False, dtype=torch.float32):
    z = torch.zeros
    return (z(k, 37, dtype=dtype), z(k, 3), z(k), z(k), z(k, K, NV) if x0 else None, z(3), z(()))


def _key(inputs=None, terrain=None, scfg=SolverConfig(), K_=K, duration=1.5, gait="trot"):
    terrain = terrain if terrain is not None else TERRAIN
    return graph_key(_inputs() if inputs is None else inputs, terrain, scfg, K_, duration, gait)


TERRAIN = make_terrain(["plane"], device="cpu")


def test_key_is_the_same_for_other_contents():
    a, b = _inputs(), tuple(None if t is None else t + 1.0 for t in _inputs())
    assert graph_key(a, TERRAIN, SolverConfig(), K, 1.5, "trot") == graph_key(b, TERRAIN, SolverConfig(), K, 1.5, "trot")
    same_ground = dataclasses.replace(TERRAIN)
    assert _key(terrain=same_ground) == _key()


@pytest.mark.parametrize("change", [
    "solver_iters", "solver_clearance", "k", "x0", "dtype", "K", "duration", "gait",
    "terrain_dtype", "terrain_resolution", "terrain_origin", "terrain_shape",
])
def test_key_tells_apart(change):
    other = dict(
        solver_iters=lambda: _key(scfg=SolverConfig(max_iters=3)),
        solver_clearance=lambda: _key(scfg=SolverConfig(swing_clearance=0.09)),
        k=lambda: _key(inputs=_inputs(k=3)),
        x0=lambda: _key(inputs=_inputs(x0=True)),
        dtype=lambda: _key(inputs=_inputs(dtype=torch.float64)),
        K=lambda: _key(K_=K + 2),
        duration=lambda: _key(duration=2.5),
        gait=lambda: _key(gait="walk"),
        terrain_dtype=lambda: _key(terrain=dataclasses.replace(TERRAIN, height=TERRAIN.height.double())),
        terrain_resolution=lambda: _key(terrain=dataclasses.replace(TERRAIN, resolution=0.05)),
        terrain_origin=lambda: _key(terrain=dataclasses.replace(TERRAIN, origin=(-2.0, -1.0))),
        terrain_shape=lambda: _key(terrain=make_terrain(["plane", "plane"], device="cpu")),
    )[change]()
    assert other != _key()


class _StubGraph:
    made = []

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        _StubGraph.made.append(self)


def test_cache_runs_eagerly_then_captures_then_replays(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _StubGraph)
    _StubGraph.made = []
    cache = graphs.GraphCache(3)
    assert cache.graph("a", len, (1,)) == (None, False)
    g, captured = cache.graph("a", len, (2,))
    assert captured and isinstance(g, _StubGraph)
    assert g.inputs == (2,)
    assert cache.graph("a", len, (3,)) == (g, False)
    assert len(_StubGraph.made) == 1


def test_cache_drops_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _StubGraph)
    cache = graphs.GraphCache(2)
    for key in ("a", "a", "b"):
        cache.graph(key, len, (1,))
    assert list(cache.entries) == ["a", "b"]
    cache.graph("a", len, (1,))                 # "a" is now the most recent
    cache.graph("c", len, (1,))                 # and "b" goes
    assert list(cache.entries) == ["a", "c"]
    assert cache.graph("b", len, (1,)) == (None, False)   # met anew: eager again
    assert list(cache.entries) == ["c", "b"]


def test_cache_of_size_zero_always_runs_eagerly(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _StubGraph)
    cache = graphs.GraphCache(0)
    assert [cache.graph("a", len, (1,)) for _ in range(3)] == [(None, False)] * 3
    assert not cache.entries


# Each kernel wrapper module of `qtos_torch.ops` and its wrappers' launch
# counters.
WRAPPERS = {"btd": ("btd_solve",), "assemble": ("assemble_kernel",), "lm_restore": ("restore_rejected",),
            "tick": ("tick_scan", "tick_hold")}


@pytest.mark.parametrize("module", sorted(WRAPPERS))
def test_every_launch_counter_is_registered(module):
    """Every `*launches` attribute of a kernel wrapper is in the registry a
    graph reads, once, so a capture's launches are taken back and each
    replay adds them without a list kept elsewhere."""
    mod = importlib.import_module(f"qtos_torch.ops.{module}")
    for name in WRAPPERS[module]:
        wrapper = getattr(mod, name)
        attrs = [a for a in vars(wrapper) if a.endswith("launches")]
        assert attrs
        for a in attrs:
            assert cuda_lib.LAUNCH_COUNTERS.count((wrapper, a)) == 1, f"{name}.{a}"


def _counted():
    """A stand-in kernel wrapper whose launch counter is registered."""
    _counted.launches += 2


class _StubCUDAGraph:
    replays = 0

    def replay(self):
        _StubCUDAGraph.replays += 1


def test_graph_takes_back_a_capture_and_adds_each_replay(monkeypatch):
    """A capture launches nothing: every registered counter goes back to
    where it was, a counter registered after the module was written
    included, and each replay adds what the capture counted.  (The CUDA
    graph and its capture are stood in for on the CPU.)"""
    import contextlib

    monkeypatch.setattr(cuda_lib, "LAUNCH_COUNTERS", list(cuda_lib.LAUNCH_COUNTERS))
    cuda_lib.count_launches(_counted, "launches")
    cuda_lib.count_launches(_counted, "launches")            # registered once
    assert cuda_lib.LAUNCH_COUNTERS.count((_counted, "launches")) == 1
    monkeypatch.setattr(_StubCUDAGraph, "replays", 0)
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _StubCUDAGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(graphs.torch.cuda, "device", lambda d: contextlib.nullcontext())
    x = torch.arange(3.0)

    def fn(a, b):
        _counted()
        _counted()
        return a * 2.0, (a + 1.0,)

    g = graphs.Graph(fn, (x, None))
    assert _counted.launches == 0 and g.launches[g.counters.index((_counted, "launches"))] == 4
    assert all(n == 0 for c, n in zip(g.counters, g.launches) if c != (_counted, "launches"))
    out = g.replay((x + 5.0, None))
    assert torch.equal(g.static[0], x + 5.0) and g.static[1] is None
    out2 = g.replay((x, None))
    assert _counted.launches == 8 and _StubCUDAGraph.replays == 2
    # each replay returns fresh tensors (the stand-in replays nothing)
    assert out[0] is not g.out[0] and out2[1][0] is not out[1][0] and torch.equal(out[0], g.out[0])


def test_graph_tells_a_new_input_by_identity(monkeypatch):
    """`new_inputs` marks the inputs that are other tensors than the ones
    copied into their places last, by the capture or a replay, and keeps
    none of them alive."""
    import contextlib
    import gc
    import weakref

    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _StubCUDAGraph)
    monkeypatch.setattr(graphs.torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(graphs.torch.cuda, "device", lambda d: contextlib.nullcontext())
    a, b, grid = torch.arange(3.0), torch.arange(3.0), torch.zeros(2, 2)
    g = graphs.Graph(lambda x, y, h: x + h.sum(), (a, None, grid))
    assert g.new_inputs == (False, False, False)
    g.replay((a, None, grid))
    assert g.new_inputs == (False, False, False)
    fresh = grid.clone()
    g.replay((b, None, fresh))
    assert g.new_inputs == (True, False, True)
    g.replay((b, None, fresh))
    assert g.new_inputs == (False, False, False)
    gone = weakref.ref(fresh)
    del fresh
    gc.collect()
    assert gone() is None                                    # the graph held it weakly
    g.replay((b, None, grid))
    assert g.new_inputs == (False, False, True)


def test_cpu_never_captures(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(graphs, "Graph", refuse)
    monkeypatch.setattr(replan, "_GRAPHS", graphs.GraphCache(16))
    monkeypatch.setattr(plan_windows_batch, "captures", 0)
    monkeypatch.setattr(plan_windows_batch, "replays", 0)
    k = 2
    st = RobotState.standing((torch.zeros(k), torch.zeros(k)), terrain=TERRAIN, device="cpu")
    zeros = torch.zeros((k, 12))
    rows = torch.cat([zeros[:, :1], st.r, st.eul, st.feet.reshape(k, 12), st.v, st.omega, zeros], dim=-1)
    goals = st.r + torch.tensor([0.3, 0.0, 0.0])
    cfg = RunnerConfig(K=K, window_duration=1.5, n_candidates=k, solver=SolverConfig(max_iters=1))
    outs = [plan_windows_batch(rows, goals, torch.zeros(k), TERRAIN, cfg) for _ in range(3)]
    assert plan_windows_batch.captures == plan_windows_batch.replays == 0
    assert not replan._GRAPHS.entries
    for res, tables, contacts in outs[1:]:
        assert torch.equal(res.x, outs[0][0].x) and torch.equal(tables, outs[0][1])


def test_rom_box_constant_equals_the_per_call_tensor():
    for cfg in (SolverConfig(), SolverConfig(rom_box=(0.2, 0.1, 0.12))):
        for dtype in (torch.float32, torch.float64):
            want = torch.tensor(cfg.rom_box, dtype=dtype, device="cpu")
            got = constant(cfg.rom_box, dtype, torch.device("cpu"))
            assert got.dtype == want.dtype and torch.equal(got, want)
            assert constant(cfg.rom_box, dtype, torch.device("cpu")) is got     # built once


# (period, duty, offsets) of each gait that `trot_schedule` builds
GAITS = {"trot": (0.5, 0.6, (0.5, 0.0, 0.0, 0.5)), "walk": (0.8, 0.75, (0.0, 0.5, 0.75, 0.25)),
         "pace": (0.5, 0.55, (0.5, 0.0, 0.5, 0.0)), "bound": (0.45, 0.6, (0.0, 0.0, 0.5, 0.5))}


@pytest.mark.parametrize("gait", sorted(GAITS))
def test_gait_schedule_equals_the_per_call_offsets(gait):
    """Each gait's offsets as the cached constant equal a fresh
    `torch.tensor` of them, and its schedule the one built from that."""
    period, duty, offsets = GAITS[gait]
    got = constant(offsets, torch.float32, torch.device("cpu"))
    assert torch.equal(got, torch.tensor(offsets, dtype=torch.float32))
    dt = 2.5 / 40
    sched = make_schedule(gait, 41, dt, device="cpu")
    contact, prog = _trot_per_call(41, dt, offsets, period, duty)
    assert torch.equal(sched.contact, contact) and torch.equal(sched.swing_progress, prog)


def _trot_per_call(K, dt, offsets=(0.5, 0.0, 0.0, 0.5), period=0.5, duty=0.6, stance_head=0.2, stance_tail=0.2):
    """`trot_schedule` as it was with a `torch.tensor` of the offsets per call."""
    t = torch.arange(K, dtype=torch.float32) * dt
    offs = torch.tensor(offsets, dtype=torch.float32)
    T = (K - 1) * dt
    cyc = torch.remainder((t[:, None] - stance_head) / period + offs[None, :], 1.0)
    head = t[:, None] <= stance_head + 1e-9
    tail = t[:, None] >= T - stance_tail - 1e-9
    ends = head | tail
    contact = torch.where(ends, torch.ones_like(cyc), (cyc < duty).to(torch.float32))
    in_swing = cyc >= duty
    prog = (cyc - duty) / max(1.0 - duty, 1e-6)
    prog = torch.where(in_swing, torch.clamp(prog, 0.0, 1.0), torch.zeros_like(prog))
    prog = torch.where(ends, torch.zeros_like(prog), prog)
    return contact, prog


def test_constant_tells_signed_zeros_apart_and_keeps_every_tensor():
    """-0.0 and 0.0 are two constants; and a constant stays the one tensor
    however many others are made, since a captured graph reads it by
    address."""
    cpu = torch.device("cpu")
    pos, neg = constant((0.0, 1.0), torch.float32, cpu), constant((-0.0, 1.0), torch.float32, cpu)
    assert torch.equal(torch.signbit(pos), torch.tensor([False, False]))
    assert torch.equal(torch.signbit(neg), torch.tensor([True, False]))
    first = constant((0.125, 0.25, 0.375), torch.float32, cpu)
    for n in range(300):
        constant((float(n), 0.5), torch.float32, cpu)
    assert constant((0.125, 0.25, 0.375), torch.float32, cpu) is first
