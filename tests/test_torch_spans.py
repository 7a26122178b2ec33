"""The program's spans (`qtos_torch.utils.profiling.annotate`, `spans`) on
the CPU: nothing recorded and nothing launched with no profiler running;
under `torch.profiler` the span tree of each benchmarked entry
(`solve_batch`, `plan_windows_batch`, `playback`), on the trace's clock,
with the outputs bit for bit those of a run without the profiler."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qtos_torch.control.loop import ControlParams, playback, state_from_row
from qtos_torch.control.replan import RunnerConfig, plan_windows_batch
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
from qtos_torch.terrain import make_terrain
from qtos_torch.utils import profiling

B, K, ITERS, RESCUE, TICKS = 3, 13, 2, 2, 40


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


CELLS = 20 * 20                 # the terrain's grid: one "plane" tile


def _pass(n: int, iters: int):
    return ("qtos::solve.pass", n, [("qtos::solve.presolve", n, [("qtos::terrain.slope", CELLS, [])])]
            + [("qtos::lm.iter", n, [])] * iters + [("qtos::solve.select", n, [])])


@pytest.fixture(scope="module")
def world():
    terr = make_terrain(["plane"], device="cpu")
    specs = default_spec(terr, goal_xy=(torch.linspace(0.2, 0.5, B), 0.0), duration=1.5, K=K, device="cpu")
    # a tol no window meets in ITERS iterations: every window takes the rescue pass
    scfg = SolverConfig(max_iters=ITERS, rescue_iters=RESCUE, tol=1e-9)
    tables, _ = sample_trajectory(solve_batch(specs, terr, scfg).x, specs)
    rows = tables[:2, 0]
    rcfg = RunnerConfig(K=K, window_duration=1.5, n_candidates=2, solver=SolverConfig(max_iters=ITERS, tol=3e-3))
    goals = rows[:, 1:4] + torch.tensor([0.3, 0.0, 0.0])
    table = tables[:2, :TICKS].contiguous()
    s0 = state_from_row(table[:, 0], terr)
    return dict(
        solve_batch=(lambda: solve_batch(specs, terr, scfg),
                     ("qtos::solve_batch", B, [_pass(B, ITERS), _pass(B, RESCUE)])),
        plan_windows_batch=(lambda: plan_windows_batch(rows, goals, torch.zeros(2), terr, rcfg,
                                                       t0s=torch.tensor([0.0, 0.25])),
                            ("qtos::replan", 2, [("qtos::replan.start", 2, [("qtos::terrain.reseat", 2, [])]),
                                                 _pass(2, ITERS),
                                                 ("qtos::sample", 2, [])])),
        playback=(lambda: playback(table, s0, terr, ControlParams()), ("qtos::playback", 2 * TICKS, [])),
    )


@pytest.fixture(scope="module")
def runs(world):
    """Each entry run under the profiler once to warm up (the process's first
    range starts late), once without it, which ends that
    session's log, and once more under it, with the span log of that
    session."""
    out = {}
    for name, (fn, tree) in world.items():
        _profiled(fn)
        off = fn()
        on, prof = _profiled(fn)
        out[name] = dict(off=off, on=on, prof=prof, spans=profiling.spans(), tree=tree)
    return out


ENTRIES = ("solve_batch", "plan_windows_batch", "playback")


def _tree(records, i=0):
    r = records[i]
    kids = [j for j, c in enumerate(records) if c["parent"] == i]
    return (r["name"], r["n"], [_tree(records, j) for j in kids])


def test_no_profiler_no_record_no_device_operation(world, monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling._SpanLog())

    def refuse(name):
        raise AssertionError(f"a range {name!r} with no profiler running")

    monkeypatch.setattr(profiling, "_range", refuse)
    mask = torch.ones(4, dtype=torch.bool)
    with _CountOps() as ops:
        span = profiling.annotate("qtos::a")
        assert span is profiling.annotate("qtos::b", 3, accepted=mask)
        with span as entered:
            entered.set(accepted=mask)
    assert ops.n == 0
    for fn, _ in world.values():
        fn()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


@pytest.mark.parametrize("entry", ENTRIES)
def test_span_tree(runs, entry):
    """The table's spans, each inside its parent's interval, one root per
    call; the first LM iteration of a pass accepts every window."""
    r = runs[entry]
    records = r["spans"]
    assert _tree(records) == r["tree"]
    assert [c["root"] for c in records] == [0] * len(records)
    for c in records:
        assert c["start_ns"] <= c["end_ns"]
        if c["parent"] is not None:
            p = records[c["parent"]]
            assert p["start_ns"] <= c["start_ns"] and c["end_ns"] <= p["end_ns"], c["name"]
    for p in (i for i, c in enumerate(records) if c["name"] == "qtos::solve.pass"):
        its = [c for c in records if c["parent"] == p and c["name"] == "qtos::lm.iter"]
        assert its[0]["accepted"] == its[0]["n"]
        assert all(isinstance(c["accepted"], int) and 0 <= c["accepted"] <= c["n"] for c in its)
    assert profiling.spans_dropped() == 0


@pytest.mark.parametrize("entry", ENTRIES)
def test_outputs_equal_with_profiler_on_and_off(runs, entry):
    off = list(profiling._tensor_leaves(runs[entry]["off"]))
    on = list(profiling._tensor_leaves(runs[entry]["on"]))
    assert len(off) == len(on) > 0
    assert all(torch.equal(a, b) for a, b in zip(off, on))


@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_on_the_trace_clock(runs, entry):
    """Each span starts within 1 ms of its range in the profiler's raw
    events."""
    r = runs[entry]
    events = [e for e in r["prof"].profiler.kineto_results.events()
              if e.name().startswith("qtos::") and e.device_type() == torch.autograd.DeviceType.CPU]
    for name in {c["name"] for c in r["spans"]}:
        logged = sorted(c["start_ns"] for c in r["spans"] if c["name"] == name)
        traced = sorted(e.start_ns() for e in events if e.name() == name)
        assert len(logged) == len(traced) > 0, name
        assert max(abs(a - b) for a, b in zip(logged, traced)) < 1_000_000, name


def test_a_session_logs_only_its_own_spans(world):
    solve, _ = world["solve_batch"]
    play, (root, n, _) = world["playback"]
    solve()
    _profiled(solve)
    first = profiling.spans()
    play()                                       # no profiler: the log stays the last session's
    assert profiling.spans() == first and first[0]["name"] == "qtos::solve_batch"
    _profiled(play)
    assert [(c["name"], c["n"]) for c in profiling.spans()] == [(root, n)]


def test_log_cap_counts_what_it_drops(world, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_CAP", 5)
    solve, _ = world["solve_batch"]
    solve()
    _profiled(solve)
    records = profiling.spans()
    assert len(records) == 5 and profiling.spans_dropped() == 1 + (ITERS + 4) + (RESCUE + 4) - 5
    assert [c["name"] for c in records[:3]] == ["qtos::solve_batch", "qtos::solve.pass", "qtos::solve.presolve"]
