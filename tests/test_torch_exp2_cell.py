"""The benchmark's deployment on non-flat terrain, `exp2_runner`, and its
cell `replan.exp2`, on the CPU: its height grid is the exp_2 preset's, its
replans stand on the terrain and climb, the port's replan on them agrees
with the benchmark's plain reference closely enough that a terrain fault
planted in the reference falls outside the same tolerance, and the
program's terrain spans are recorded under a profiler and change nothing
without one."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare, normal_eq
from benchmark.reference import solver as ref_solver
from benchmark.reference.heightfield import height_at as ref_height_at
from qtos_torch.config.experiments import get_experiment
from qtos_torch.control.replan import plan_windows_batch
from qtos_torch.models.solo12 import Solo12
from qtos_torch.terrain.heightfield import make_terrain
from qtos_torch.utils import profiling

SEED = 2**31 + 20_011
CELL = "replan.exp2"
START_ITERS = 3            # the LM iterations of the cell's start check
# Knots, tables and contacts of these replans after START_ITERS iterations,
# port against reference: replan.exp1's start_gap limit.  They read 4.7e-4;
# the cell's own limit is wider for the rare candidate that lands on another
# branch at a riser, which these replans do not.
START_GAP = 4e-3


def _cell() -> dict:
    return harness.load_cell(CELL)


def test_grid_is_the_exp2_preset_bit_for_bit():
    cfg = _cell()["cfg"]
    exp = get_experiment("exp_2")
    ref = make_terrain(exp.maps, scale_factor=exp.mesh_scale, device="cpu")
    grid = harness.terrain_grid(cfg, "cpu")
    assert grid.dtype == torch.float32 and grid.shape == (40, 160)
    assert torch.equal(grid.view(torch.int32), ref.height.view(torch.int32))
    assert cfg["terrain_resolution"] == ref.resolution == 0.05
    assert tuple(cfg["terrain_origin"]) == ref.origin
    assert float(grid.max()) > 0.1                 # not flat: step's 0.13 m band


def test_replans_stand_on_the_terrain_and_climb():
    """Feet on the ground, CoM and goal the stand height above it; at least
    80 % of a seeded pool of 64 replans have footholds that span 1 cm of
    height or more between the start and the goal."""
    cell = _cell()
    cfg = cell["cfg"]
    P, k = 64, cfg["n_candidates"]
    r = traffic.make(dict(cell["mix"], pool=P), cfg, SEED, "cpu")
    ground = ref_solver.terrain(harness.terrain_grid(cfg, "cpu"), cfg)
    feet = r["rows"][..., 7:19].reshape(P, k, 4, 3)
    assert torch.equal(feet[..., 2], ref_height_at(ground, feet[..., 0], feet[..., 1]))
    com, goal = r["rows"][..., 1:4], r["goals_r"]
    for p in (com, goal):
        stand = p[..., 2] - ref_height_at(ground, p[..., 0], p[..., 1])
        assert torch.allclose(stand, torch.full_like(stand, Solo12.stand_height))
    # each foot's line from its start to where it stands around the goal
    s = torch.linspace(0.0, 1.0, 41)[:, None, None, None]
    end_xy = feet[..., :2] + (goal[..., :2] - com[..., :2])[..., None, :]
    line = feet[..., :2] + s[..., None] * (end_xy - feet[..., :2])          # (41, P, k, 4, 2)
    h = ref_height_at(ground, line[..., 0], line[..., 1])
    span = h.amax(dim=(0, 2, 3)) - h.amin(dim=(0, 2, 3))                   # (P,)
    assert float((span >= 0.01).float().mean()) >= 0.8


@pytest.fixture(scope="module")
def replans():
    """Two replans of the cell's traffic, their candidates in one batch, by
    the port and by the plain reference, cut to the start check's
    iterations."""
    cell = _cell()
    cfg = cell["cfg"]
    cfg["solver"]["max_iters"] = START_ITERS
    i = traffic.make(dict(cell["mix"], pool=2), cfg, SEED, "cpu")
    rows, goals_r = i["rows"].reshape(-1, 37), i["goals_r"].reshape(-1, 3)
    goals_yaw, t0s = i["goals_yaw"].reshape(-1), i["t0s"].reshape(-1)
    grid = harness.terrain_grid(cfg, "cpu")
    res, tables, contacts = plan_windows_batch(rows, goals_r, goals_yaw, program.terrain(grid, cfg),
                                               program.runner_config(cfg), t0s=t0s)
    terr = ref_solver.terrain(grid, cfg)
    scfg = ref_solver.solver_config(cfg["solver"])
    specs = ref_solver.replan_specs(rows, goals_r, goals_yaw, terr, K=cfg["K"], duration=cfg["window_duration"],
                                    gait=cfg["gait"])
    ref = ref_solver.plan_windows(specs, t0s, terr, scfg)
    return dict(limits=cell["limits"], res=res, tables=tables, contacts=contacts, ref=ref,
                plan_ref=lambda: ref_solver.plan_windows(specs, t0s, terr, scfg),
                evaluated=ref_solver.evaluate(res.x, specs, t0s, terr, scfg))


def _start_gap(x, tables, contacts, ref) -> float:
    ref, ref_tables, ref_contacts = ref
    return max(compare.knot_gap(x, ref.x), compare.table_gap(tables, contacts, ref_tables, ref_contacts))


def test_port_replan_agrees_with_the_reference(replans):
    r = replans
    assert _start_gap(r["res"].x, r["tables"], r["contacts"], r["ref"]) <= START_GAP


def _no_gradient(terrain, x, y):
    return torch.zeros_like(x), torch.zeros_like(x)


@pytest.mark.parametrize("fault", [
    {"grad_at": _no_gradient},                                         # the terrain gradients dropped
    {"grad_at": _no_gradient, "height_at": lambda terrain, x, y: torch.zeros_like(x)},   # flat ground
], ids=["no_terrain_gradient", "flat_assembly"])
def test_a_terrain_fault_falls_outside_the_tolerance(replans, fault, monkeypatch):
    """The reference's normal equations with a terrain fault planted, put in
    the port's place, read well above START_GAP."""
    for name, f in fault.items():
        monkeypatch.setattr(normal_eq, name, f)
    res, tables, contacts = replans["plan_ref"]()
    assert _start_gap(res.x, tables, contacts, replans["ref"]) > 10 * START_GAP


def test_port_report_is_the_references_evaluation_exactly(replans):
    r = replans
    viol_ref, tables_ref, contacts_ref = r["evaluated"]
    assert r["limits"]["report_gap"] == 0.0
    assert compare.viol_gap(compare.stack_viol(r["res"].viol), compare.stack_viol(viol_ref)) == 0.0
    assert compare.table_gap(r["tables"], r["contacts"], tables_ref, contacts_ref) == 0.0
    assert float(r["res"].viol["terrain"].max()) > 0.0          # the terrain family is at work


def _small_replan():
    """A short replan (K=13, 2 LM iterations) of two of the cell's candidates
    on exp_2's grid."""
    cell = _cell()
    cfg = cell["cfg"]
    cfg["K"], cfg["window_duration"] = 13, 0.75
    cfg["solver"]["max_iters"] = 2
    i = traffic.make(dict(cell["mix"], pool=1), cfg, SEED, "cpu")
    terr = program.terrain(harness.terrain_grid(cfg, "cpu"), cfg)
    rcfg = program.runner_config(cfg)
    rows, goals_r, goals_yaw = i["rows"][0, :2], i["goals_r"][0, :2], i["goals_yaw"][0, :2]
    return lambda: plan_windows_batch(rows, goals_r, goals_yaw, terr, rcfg, t0s=i["t0s"][0, :2])


def test_terrain_spans_under_the_profiler():
    replan = _small_replan()
    replan()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        replan()
    records = profiling.spans()
    by_name = {r["name"]: r for r in records}
    slope, reseat = by_name["qtos::terrain.slope"], by_name["qtos::terrain.reseat"]
    assert slope["n"] == 40 * 160 and records[slope["parent"]]["name"] == "qtos::solve.presolve"
    assert reseat["n"] == 2 and records[reseat["parent"]]["name"] == "qtos::replan.start"


def test_no_profiler_no_record(monkeypatch):
    """Without a profiler the replan records nothing, and its outputs are
    those of the same replan under the profiler."""
    replan = _small_replan()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = [t.clone() for t in profiling._tensor_leaves(replan())]
    monkeypatch.setattr(profiling, "_LOG", profiling._SpanLog())
    plain = list(profiling._tensor_leaves(replan()))
    assert profiling.spans() == []
    assert len(traced) == len(plain) and all(torch.equal(a, b) for a, b in zip(traced, plain))
