"""The readers of the program's span log (`benchmark/spans.py`,
`metrics/*`): their numbers from a span log built by hand, None from an
empty log and from a trace with no device operation, and a number from the
log the program itself leaves on the CPU."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import harness, spans

CARD = dict(kernels={"btd_kernel": dict(launches=1, seconds=1e-3)})   # a trace of a run on the card
OFF_CARD = dict(kernels={})


class Log:
    """A span log as `qtos_torch.utils.profiling.spans` gives it, times in ms."""

    def __init__(self):
        self.records, self.open = [], []

    def span(self, name, a, b, n=1, **counts):
        parent = self.open[-1] if self.open else None
        root = len(self.records) if parent is None else self.records[parent]["root"]
        self.records.append(dict(counts, name=name, parent=parent, root=root, start_ns=int(a * 1e6),
                                 end_ns=int(b * 1e6), n=n))
        return len(self.records) - 1

    def enter(self, name, a, b, n=1):
        self.open.append(self.span(name, a, b, n))

    def leave(self):
        self.open.pop()

    def solve_pass(self, t, n, presolve_ms, accepted, iter_ms=1.0):
        self.enter("qtos::solve.pass", t, t + 100, n)
        self.span("qtos::solve.presolve", t, t + presolve_ms, n)
        for i, acc in enumerate(accepted):
            self.span("qtos::lm.iter", t + 10 + i * iter_ms, t + 10 + (i + 1) * iter_ms, n, accepted=acc)
        self.span("qtos::solve.select", t + 90, t + 91, n)
        self.leave()


def hand_log() -> list:
    g = Log()
    # two sweep calls of 8 windows; the first with a rescue pass of 2
    g.enter("qtos::solve_batch", 0, 300, 8)
    g.solve_pass(0, 8, 2.0, [8, 6, 4])
    g.solve_pass(150, 2, 10.0, [2, 0])
    g.leave()
    g.enter("qtos::solve_batch", 1000, 1200, 8)
    g.solve_pass(1000, 8, 4.0, [8, 8, 2])
    g.leave()
    # two replans of 4 candidates
    for t, start, pre, iter_ms, sel, smp in ((2000, 1.0, 0.5, 0.1, 2.0, 3.0), (3000, 2.0, 1.0, 0.4, 4.0, 5.0)):
        g.enter("qtos::replan", t, t + 200, 4)
        g.span("qtos::replan.start", t, t + start, 4)
        g.enter("qtos::solve.pass", t + 5, t + 150, 4)
        g.span("qtos::solve.presolve", t + 5, t + 5 + pre, 4)
        for i in range(3):
            g.span("qtos::lm.iter", t + 10 + i, t + 10 + i + iter_ms * (i + 1), 4, accepted=4)
        g.span("qtos::solve.select", t + 100, t + 100 + sel, 4)
        g.leave()
        g.span("qtos::sample", t + 160, t + 160 + smp, 4)
        g.leave()
    # three playback calls
    for t, ms in ((4000, 10.0), (4100, 40.0), (4200, 20.0)):
        g.span("qtos::playback", t, t + ms, 256 * 2501)
    return [dict(r, index=i) for i, r in enumerate(g.records)]


EXPECTED = {
    "lm_accept_pct.sweep": 100.0 * (6 + 4 + 8 + 2) / (4 * 8),    # pass-1 iterations after the first
    "presolve_host_ms.sweep": 3.0,                               # pass 1's: 2 and 4 ms
    "lm_iter_host_us.replan": 350.0,                             # 100, 200, 300, 400, 800, 1200 us
    "presolve_host_ms.replan": 2.25,                             # 1.5 and 3.0 ms
    "select_host_ms.replan": 3.0,
    "sampler_host_ms.replan": 4.0,
    "playback_host_us.verify": 20000.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_hand_built_log(metric, monkeypatch):
    read = harness.load_module("metrics", metric).read
    monkeypatch.setattr(spans, "log", hand_log)
    assert read(CARD, {}) == pytest.approx(EXPECTED[metric])
    assert read(OFF_CARD, {}) is None                            # a CPU run reports no device-trace number
    monkeypatch.setattr(spans, "log", list)
    assert read(CARD, {}) is None


def test_every_span_reader_has_a_case():
    idx = harness.index()
    readers = {m["name"] for m in idx["per_layer"]
               if "spans" in open(f"{harness.BENCH_DIR}/metrics/{m['name']}.py").read()}
    assert readers == set(EXPECTED)


def test_readers_on_the_programs_own_log():
    """The spans the program records on the CPU under the profiler, read as
    a card's run would be."""
    from qtos_torch.control.loop import ControlParams, playback, state_from_row
    from qtos_torch.control.replan import RunnerConfig, plan_windows_batch
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
    from qtos_torch.terrain import make_terrain

    terr = make_terrain(["plane"], device="cpu")
    specs = default_spec(terr, goal_xy=(torch.tensor([0.2, 0.4]), 0.0), duration=1.5, K=13, device="cpu")
    scfg = SolverConfig(max_iters=3, rescue_iters=2, tol=1e-9)
    tables, _ = sample_trajectory(solve_batch(specs, terr, scfg).x, specs)
    rows = tables[:, 0]
    rcfg = RunnerConfig(K=13, window_duration=1.5, n_candidates=2, solver=SolverConfig(max_iters=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        solve_batch(specs, terr, scfg)
        plan_windows_batch(rows, rows[:, 1:4] + torch.tensor([0.3, 0.0, 0.0]), torch.zeros(2), terr, rcfg)
        playback(tables[:, :20].contiguous(), state_from_row(tables[:, 0], terr), terr, ControlParams())
    for metric in EXPECTED:
        v = harness.load_module("metrics", metric).read(CARD, {})
        assert v is not None and math.isfinite(v) and v >= 0, metric
    assert 0 <= harness.load_module("metrics", "lm_accept_pct.sweep").read(CARD, {}) <= 100
