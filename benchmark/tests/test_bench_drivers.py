"""Each driver's closed loop and each reference at small sizes on the CPU,
through the harness's `measure` (which skips the look for a card), and the
faults a run must catch: with the timed path broken underneath, `correct`
comes out false."""

from __future__ import annotations

import importlib
import time
import types

import pytest
import torch

from benchmark import harness, traffic
from benchmark.reference import compare

SEED = 2**31 + 12345


def small_cell(name: str) -> dict:
    """The cell at a CPU's size: a few windows (at the full 41 knots a
    sweep's three LM iterations move them; 13 knots elsewhere, tables of
    0.3 s), few iterations; the limits are the cell's own."""
    cell = harness.load_cell(name)
    cfg = cell["cfg"]
    if cell["driver"] == "solve_batch":
        cell["mix"] = dict(cell["mix"], batch=4, pool=2)
    elif cell["driver"] == "playback":
        cfg["K"], cfg["duration_s"] = 13, 0.3
        cell["mix"] = dict(cell["mix"], batch=4, pool=1)
    else:
        cfg["K"] = 13
        cfg["window_duration"] = 0.75
        cfg["solver"]["max_iters"] = 4
        cell["mix"] = dict(cell["mix"], pool=3)
    return cell


def run(cell: dict, seconds: float = 1.5, trace: int = 0) -> dict:
    args = types.SimpleNamespace(seed=SEED, seconds=seconds, trace=trace)
    return harness.measure(harness.index(), cell, args, torch.device("cpu"), time.perf_counter())


CELLS = ["sweep.b8192", "replan.exp1", "verify.b256"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = run(small_cell(name))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and set(line["metrics"]) >= {"setup_s"}
    assert list(line)[-1] == "checks"


def test_traced_run_reads_per_layer_metrics():
    line = run(small_cell("replan.exp1"), seconds=0.5, trace=1)
    assert line["correct"]
    assert set(line["metrics"]) == {"device_idle_pct.replan"}   # no kernel runs on the CPU
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def _wrap(monkeypatch, module, name, fn):
    inner = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: fn(inner(*a, **k), *a, **k))


def _traces(fn):
    """A wrapper of the tick scan's (final, traces) that edits the traces."""
    return lambda out, *a, **k: (out[0], {key: fn(v) for key, v in out[1].items()})


def test_unchanged_state_is_caught(monkeypatch):
    """Every step returns the state unchanged: the LM step is 0, every tick
    repeats the first."""
    import qtos_torch.control.loop as loop

    solve = importlib.import_module("qtos_torch.solver.solve")   # the package's `solve` is a function

    _wrap(monkeypatch, solve, "btd_solve", lambda dx, *a, **k: torch.zeros_like(dx))
    _wrap(monkeypatch, loop, "tick_scan", _traces(lambda v: v[:, :1].expand_as(v).clone()))
    for name in CELLS:
        assert not run(small_cell(name))["correct"], name


def test_half_batch_left_out_is_caught(monkeypatch):
    """The second half of every batch is left out: its windows take no LM
    step, its episodes' traces stay zero."""
    import qtos_torch.control.loop as loop

    solve = importlib.import_module("qtos_torch.solver.solve")   # the package's `solve` is a function

    def half(v, *a, **k):
        v = v.clone()
        v[v.shape[0] // 2:] = 0
        return v

    _wrap(monkeypatch, solve, "btd_solve", half)
    _wrap(monkeypatch, loop, "tick_scan", _traces(half))
    for name in CELLS:
        assert not run(small_cell(name), seconds=3.0)["correct"], name


def test_altered_answer_is_caught(monkeypatch):
    """Where the answer is produced, each window gets its neighbour's knots
    (a solve), each table or trace is one tick late (a replan, a
    playback)."""
    import dataclasses

    import qtos_torch.control.loop as loop
    import qtos_torch.control.replan as replan
    import qtos_torch.solver as solver

    def late(v):
        return torch.cat([v[:, :1], v[:, :-1]], 1)

    _wrap(monkeypatch, solver, "solve_batch",
          lambda res, *a, **k: dataclasses.replace(res, x=torch.roll(res.x, 1, dims=0)))
    _wrap(monkeypatch, replan, "plan_windows_batch", lambda out, *a, **k: (out[0], late(out[1]), out[2]))
    _wrap(monkeypatch, loop, "tick_scan", _traces(late))
    for name in CELLS:
        assert not run(small_cell(name), seconds=3.0)["correct"], name


def test_late_lm_fault_is_caught(monkeypatch):
    """Past the iterations that the start compares knot by knot, every LM
    step of the replan is 0 (iterations left out): the timed answer's
    numbers catch it."""
    import qtos_torch.control.replan as replan

    solve = importlib.import_module("qtos_torch.solver.solve")
    start_iters = harness.load_module("drivers", "plan_windows_batch").START_ITERS
    calls = [0]

    def step(dx, *a, **k):
        calls[0] += 1
        return dx if calls[0] <= start_iters else torch.zeros_like(dx)

    def solve_pass(*a, **k):
        calls[0] = 0
        return inner(*a, **k)

    inner = replan._solve_pass
    monkeypatch.setattr(replan, "_solve_pass", solve_pass)
    _wrap(monkeypatch, solve, "btd_solve", step)
    cell = small_cell("replan.exp1")
    cell["cfg"]["solver"]["max_iters"] = 10
    line = run(cell, seconds=3.0)
    assert not line["correct"]
    assert line["checks"]["start_gap"]["value"] <= line["checks"]["start_gap"]["limit"]


def test_late_tick_fault_is_caught(monkeypatch):
    """Past the ticks that are compared one by one, each episode plays its
    neighbour's rows (a later chunk read from the wrong place): the
    whole-episode numbers catch it."""
    import qtos_torch.control.loop as loop

    inner = loop.tick_scan
    check_ticks = harness.load_module("drivers", "playback").CHECK_TICKS

    def scan(table, *a, **k):
        table = table.clone()
        table[:, check_ticks:, 1:] = torch.roll(table[:, check_ticks:, 1:], 1, dims=0)
        return inner(table, *a, **k)

    monkeypatch.setattr(loop, "tick_scan", scan)
    cell = small_cell("verify.b256")
    cell["cfg"]["duration_s"] = (check_ticks + 200) / 1000
    line = run(cell, seconds=3.0)
    assert not line["correct"]
    assert line["checks"]["trace_gap"]["value"] <= line["checks"]["trace_gap"]["limit"]


def test_reference_agrees_with_itself_and_moves_with_its_inputs():
    cell = small_cell("sweep.b8192")
    drv = harness.load_module("drivers", "solve_batch").Driver(cell, SEED, torch.device("cpu"))
    drv.step(0)
    drv.release()
    a, b = drv.reference(), drv.reference()
    assert compare.knot_gap(a.x, b.x) == 0.0
    drv.goals[..., 0] += 0.05
    assert compare.knot_gap(drv.reference().x, a.x) > 1e-3


def test_replans_stand_on_the_terrain(tmp_path, monkeypatch):
    """On a tile that is not flat, the feet stand on the ground and the CoM
    and the goal the stand height above it."""
    import shutil

    import numpy as np

    from benchmark.reference.heightfield import height_at
    from benchmark.reference.solver import terrain

    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (copy / "configs" / "tiles").mkdir(exist_ok=True)
    ramp = np.repeat(np.linspace(0.0, 0.1, harness.TILE_CELLS)[None], harness.TILE_CELLS, 0)
    np.savetxt(copy / "configs" / "tiles" / "ramp.csv", ramp, delimiter=",")
    monkeypatch.setattr(harness, "BENCH_DIR", str(copy))
    cell = harness.load_cell("replan.exp1")
    cell["cfg"]["tiles"] = ["ramp", "ramp"]
    r = traffic.make(dict(cell["mix"], pool=16), cell["cfg"], SEED, "cpu")
    ground = terrain(harness.terrain_grid(cell["cfg"], "cpu"), cell["cfg"])
    feet = r["rows"][..., 7:19].reshape(16, 4, 4, 3)
    assert float(feet[..., 2].abs().max()) > 0.01
    assert torch.equal(feet[..., 2], height_at(ground, feet[..., 0], feet[..., 1]))
    com, goal = r["rows"][..., 1:4], r["goals_r"]
    for p in (com, goal):
        assert torch.allclose(p[..., 2] - height_at(ground, p[..., 0], p[..., 1]), torch.full_like(p[..., 2], 0.24))


def test_traffic_is_made_from_the_seed():
    cell = harness.load_cell("replan.exp1")
    a = traffic.make(cell["mix"], cell["cfg"], SEED, "cpu")
    b = traffic.make(cell["mix"], cell["cfg"], SEED, "cpu")
    c = traffic.make(cell["mix"], cell["cfg"], SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["rows"], c["rows"])
    rows = a["rows"]
    assert rows.shape == (1024, 4, 37) and float(rows[..., 1].min()) >= 0.0
    assert torch.allclose(rows[..., 3], torch.full_like(rows[..., 3], 0.24))
    sweep = harness.load_cell("sweep.b8192")
    g = traffic.make(sweep["mix"], sweep["cfg"], SEED, "cpu")
    B = g.shape[1]
    edges = 0.3 + 0.5 * torch.arange(B + 1, dtype=torch.float64) / B
    x = g[..., 0].double().sort(dim=1).values                          # one goal in each bin
    assert bool(((x >= edges[:-1] - 1e-6) & (x <= edges[1:] + 1e-6)).all())
