"""The benchmark's one-shot deployment, `exp1_oneshot`, and its cell
`oneshot.exp1`, on the CPU: the configuration is the plan that the port's
one-shot mode makes for exp_1 (`qtos_torch.builder.oneshot_plan`, which the
CLI calls), the cell's traffic makes a pool of distinct goals around the
preset's, the port's solve agrees with the benchmark's plain reference on a
shorter window within the cell's limits, and the sweep's roofline readers,
which the cell shares, read the long window's kernels.  The whole 154-knot plan of 80 LM
iterations is left to the card: it takes minutes here."""

from __future__ import annotations

import os
import sys
import time
import types

import pytest
import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare
from benchmark.reference import solver as ref_solver
from benchmark.reference import spec as ref_spec
from benchmark.reference import transcription as ref_transcription
from qtos_torch.builder import oneshot_plan, preset_runner_config
from qtos_torch.config.experiments import get_experiment
from qtos_torch.solver import SolverConfig, default_spec, solve_batch
from qtos_torch.terrain.heightfield import make_terrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 24_001
CELL = "oneshot.exp1"
oneshot = harness.load_module("drivers", "oneshot")


def _cell() -> dict:
    return harness.load_cell(CELL)


def test_config_is_the_ports_oneshot_plan_of_exp1():
    cfg = _cell()["cfg"]
    exp = get_experiment("exp_1")
    plan = oneshot_plan(exp.goal_xy, preset_runner_config(exp).avg_speed)
    assert (cfg["K"], cfg["duration_s"]) == (plan.K, plan.duration) == (154, 2.1 / 0.22)
    assert program.solver_config(cfg["solver"]) == plan.solver == SolverConfig(max_iters=80, tol=5e-3)
    assert cfg["solver"]["rescue_iters"] == 0
    lo, hi = cfg["goal_x"]
    assert lo < exp.goal_xy[0] < hi and cfg["goal_y"] == exp.goal_xy[1]
    ref = make_terrain(list(exp.maps), scale_factor=exp.mesh_scale, device="cpu")
    grid = harness.terrain_grid(cfg, "cpu")
    assert torch.equal(grid, ref.height)
    assert (cfg["terrain_resolution"], tuple(cfg["terrain_origin"])) == (ref.resolution, ref.origin)


def test_cli_oneshot_plans_with_oneshot_plan(tmp_path, monkeypatch):
    """`scripts/main_torch.py --oneshot` solves the spec and settings that
    `oneshot_plan` gives (here a short plan put in its place)."""
    import qtos_torch.builder as builder
    import qtos_torch.solver as solver

    short = builder.OneshotPlan(duration=0.5, K=9, solver=SolverConfig(max_iters=2, tol=5e-3))
    seen = {}
    inner = solver.solve

    def solve(spec, terrain, cfg):
        seen.update(K=spec.schedule.contact.shape[-2], duration=float(spec.duration), cfg=cfg)
        return inner(spec, terrain, cfg)

    monkeypatch.setattr(builder, "oneshot_plan", lambda goal, avg_speed: short)
    monkeypatch.setattr(solver, "solve", solve)
    monkeypatch.chdir(tmp_path)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import main_torch
    finally:
        sys.path.pop(0)
    main_torch.main(["--exp", "exp_1", "--oneshot", "--device", "cpu", "--out", str(tmp_path / "out")])
    assert seen == dict(K=short.K, duration=short.duration, cfg=short.solver)


def test_goal_sweep_pool_is_eight_distinct_goals():
    cell = _cell()
    goals = traffic.make(cell["mix"], cell["cfg"], SEED, "cpu")
    assert goals.shape == (8, 1, 2)
    gx = goals[:, 0, 0]
    assert len(set(gx.tolist())) == 8
    assert bool(((gx >= 2.0) & (gx <= 2.2)).all()) and bool((goals[..., 1] == 0).all())
    assert torch.equal(goals, traffic.make(cell["mix"], cell["cfg"], SEED, "cpu"))
    assert not torch.equal(goals, traffic.make(cell["mix"], cell["cfg"], SEED + 1, "cpu"))


def _small_cell() -> dict:
    """The cell at a CPU's size: two goals of the pool, a 3 s window of 49
    knots, 4 LM iterations; every other setting and the limits the cell's."""
    cell = _cell()
    cfg = cell["cfg"]
    cfg["K"], cfg["duration_s"] = 49, 3.0
    cfg["solver"]["max_iters"] = 4
    cell["mix"] = dict(cell["mix"], pool=2)
    return cell


def _run(cell: dict) -> dict:
    args = types.SimpleNamespace(seed=SEED, seconds=2.0, trace=0)
    return harness.measure(harness.index(), cell, args, torch.device("cpu"), time.perf_counter())


def test_port_agrees_with_the_reference_on_a_shorter_window():
    """B=2, K=49 (a 3 s window), every other setting the cell's: the port's
    `solve_batch` against the reference's, by the numbers the cell's check
    compares, within its limits: knots after the start's 3 LM iterations,
    and after 4 the reference's merit and violations of the port's knots
    against those of its own (the report exactly)."""
    cell = _small_cell()
    cfg, limits = cell["cfg"], cell["limits"]
    goals = traffic.make(cell["mix"], cfg, SEED, "cpu")[:, 0]
    grid = harness.terrain_grid(cfg, "cpu")
    terr, rterr = program.terrain(grid, cfg), ref_solver.terrain(grid, cfg)
    specs = default_spec(terr, goal_xy=(goals[:, 0], goals[:, 1]), duration=3.0, K=49, device="cpu")
    rspecs = ref_spec.default_spec(rterr, goal_xy=(goals[:, 0], goals[:, 1]), duration=3.0, K=49, device="cpu")
    scfg, rcfg = program.solver_config(cfg["solver"]), ref_solver.solver_config(cfg["solver"])
    start = [solve_batch(specs, terr, scfg.replace(max_iters=oneshot.START_ITERS)).x,
             ref_solver.solve_batch(rspecs, rterr, rcfg.replace(max_iters=oneshot.START_ITERS)).x]
    assert compare.knot_gap(*start) <= limits["start_gap"]
    res, ref = solve_batch(specs, terr, scfg), ref_solver.solve_batch(rspecs, rterr, rcfg)
    assert bool((res.status == 0).all())
    viol = ref_transcription.violations(res.x, rspecs, rterr, rcfg)
    assert compare.viol_gap(compare.stack_viol(res.viol), compare.stack_viol(viol)) == 0.0
    excess = ref_solver.merit(res.x, rspecs, rterr, rcfg) / ref_solver.merit(ref.x, rspecs, rterr, rcfg) - 1
    assert float(excess.max()) <= limits["merit_excess"]
    viol_ratio = ref_transcription.max_violation(viol) / ref.max_violation - 1
    assert float(viol_ratio.median()) <= limits["viol_excess_median"]


def test_sound_run_of_the_driver_is_correct():
    """The cell's own driver, one plan at a time, on the CPU."""
    line = _run(_small_cell())
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checks"]["report_gap"]["value"] == 0.0


def test_a_step_left_out_is_caught(monkeypatch):
    """Every LM step zeroed: the knots stay at the initial guess and the
    check comes out false."""
    import importlib

    solve = importlib.import_module("qtos_torch.solver.solve")   # the package's `solve` is a function
    monkeypatch.setattr(solve, "btd_solve", lambda D, L, b, lm=None: torch.zeros_like(b))
    line = _run(_small_cell())
    assert not line["correct"]
    checks = line["checks"]
    assert checks["start_gap"]["value"] > checks["start_gap"]["limit"]



@pytest.mark.parametrize("name,changed", [
    ("goal_weight_half", dict(goal=4.0)), ("damping_clamp", dict(lm_min=1e-3)), ("stop_at_10", dict(max_iters=10))])
def test_control_plants_each_fault_in_the_reference(monkeypatch, name, changed):
    """`control` solves the reference under the fault's settings (the goal
    weight, 8 in the cell, halved and no other weight moved) and its start
    under the same settings cut to the start's iterations; the numbers come
    from the driver's own comparison."""
    cell = _cell()
    sound = ref_solver.solver_config(cell["cfg"]["solver"])
    seen = []

    def solve_batch(specs, terr, cfg):
        seen.append(cfg)
        return types.SimpleNamespace(x=torch.zeros(1, 2, 36), viol=dict(goal=torch.zeros(1)))

    monkeypatch.setattr(ref_solver, "solve_batch", solve_batch)
    drv = types.SimpleNamespace(kept={0: None}, ref_scfg=sound, device=torch.device("cpu"),
                                _ref_problem=lambda ps, device: (None, None),
                                gaps=lambda start_x, timed_x, reported, ps: [dict(name="gaps", value=0, limit=0)])
    assert oneshot.Driver.control(drv, name) == [dict(name="gaps", value=0, limit=0)]
    start, timed = seen
    weights = dict(vars(sound.weights), **changed) if "goal" in changed else vars(sound.weights)
    assert vars(timed.weights) == vars(start.weights) == weights
    assert start.max_iters == oneshot.START_ITERS
    settings = {k: v for k, v in changed.items() if k != "goal"}
    assert timed == sound.replace(weights=timed.weights, **settings)

def _summary():
    # 1 s window: two btd_kernel launches of 3.7 ms, two assemblies of 0.25 ms
    return dict(window_s=1.0, busy_s=0.9, kernels={
        "btd_kernel(float const*, float const*)": dict(launches=2, seconds=7.4e-3),
        "assemble_kernel(AsmParams, AsmTensors, int, int, int)": dict(launches=2, seconds=0.5e-3),
    })


def test_roofline_readers_read_the_long_window():
    from benchmark import roofline

    ctx = dict(shapes=dict(B=1, K=154, iters=1, grid_cells=800), counters=dict(assemble=2, calls=2))
    btd = harness.load_module("metrics", "btd_roofline_pct.sweep").read
    asm = harness.load_module("metrics", "assemble_roofline_pct.sweep").read
    btd_bound = roofline.bound_s(*roofline.btd_work(1, 154))
    asm_bound = roofline.bound_s(*roofline.assemble_work(1, 154, 800))
    assert btd_bound == pytest.approx(4.0 * 408_960 / roofline.PEAK_BYTES_PER_S)    # bytes bound it
    assert btd(_summary(), ctx) == pytest.approx(100 * btd_bound / 3.7e-3)
    assert asm(_summary(), ctx) == pytest.approx(100 * asm_bound / 0.25e-3)
    ctx["counters"]["assemble"] = 3                                 # a rescue pass: two sizes
    assert asm(_summary(), ctx) is None
    assert btd(dict(_summary(), kernels={}), ctx) is None          # the kernel never ran
