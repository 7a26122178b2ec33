"""A replan on a world that changes while the robot walks (exp_8's box
obstacles, the benchmark's `exp8_runner` and its cell `replan.exp8`) on the
CPU: the replan's graph key sees a world's geometry and not its grid, the
port's replan on a world with a box agrees with the benchmark's plain
reference on that world, `add_box_obstacle` raises the cells the
reference's box raises, its span is recorded under a profiler, and the
configuration's grid is the exp_8 preset's.  The graphs themselves run only
on the card (`tests/test_torch_gpu.py`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare
from benchmark.reference import solver as ref_solver
from benchmark.reference import world as ref_world
from qtos_torch.config.experiments import get_experiment
from qtos_torch.control.replan import RunnerConfig, graph_key, plan_windows_batch
from qtos_torch.solver import SolverConfig
from qtos_torch.terrain.heightfield import add_box_obstacle, make_terrain
from qtos_torch.utils import profiling

SEED = 2**31 + 26_001
CELL = "replan.exp8"
K = 13
START_ITERS = 3
# Knots, tables and contacts after START_ITERS LM iterations, port against
# reference: replan.exp1's start_gap limit.
START_GAP = 4e-3


def _cell() -> dict:
    return harness.load_cell(CELL)


def _ground(cfg: dict):
    return program.terrain(harness.terrain_grid(cfg, "cpu"), cfg)


def _inputs(k: int = 4):
    z = torch.zeros
    return (z(k, 37), z(k, 3), z(k), z(k), None, z(3), z(()))


def test_grid_is_the_exp8_preset_bit_for_bit():
    cfg = _cell()["cfg"]
    exp = get_experiment("exp_8")
    want = make_terrain(exp.maps, scale_factor=exp.mesh_scale, randomize=exp.random_env,
                        rng=np.random.default_rng(0), device="cpu")
    grid = harness.terrain_grid(cfg, "cpu")
    assert grid.dtype == torch.float32 and grid.shape == (20, 60)
    assert torch.equal(grid.view(torch.int32), want.height.view(torch.int32))
    assert cfg["terrain_resolution"] == want.resolution and tuple(cfg["terrain_origin"]) == want.origin
    assert 0.0 < float(grid[:, :20].max()) < 0.02 and float(grid.max()) > 1.0     # the noise, the wall


def test_graph_key_is_the_worlds_geometry():
    """Two worlds of one geometry share a key (the grid is the graph's
    input); another shape, resolution or origin does not."""
    ground = _ground(_cell()["cfg"])

    def key(terrain):
        return graph_key(_inputs(), terrain, SolverConfig(), 41, 2.5, "trot")

    a = add_box_obstacle(ground, 2.5, 0.0)
    b = add_box_obstacle(ground, 2.9, 0.0)
    assert a.height is not b.height and not torch.equal(a.height, b.height)
    assert key(a) == key(b) == key(ground)
    assert key(dataclasses.replace(a, height=a.height[:, :40])) != key(a)
    assert key(dataclasses.replace(a, resolution=0.05)) != key(a)
    assert key(dataclasses.replace(a, origin=(-1.0, -0.5))) != key(a)


@pytest.mark.parametrize("x, y, half", [(2.5, 0.0, 0.1), (2.37, 0.0, 0.1), (2.95, 0.0, 0.1), (0.0, 0.3, 0.25),
                                        (-1.05, -0.95, 0.1), (4.98, 0.98, 0.1), (1.4, 0.55, 0.05)])
def test_box_raises_the_references_cells(x, y, half):
    """`add_box_obstacle` against `benchmark/reference/world.py`: the same
    cells raised to the same heights, a fresh grid, the rest untouched;
    boxes inside the grid, across its edges and on the wall's tile."""
    cfg = _cell()["cfg"]
    ground = _ground(cfg)
    got = add_box_obstacle(ground, x, y, half=half, height=0.34)
    want = ref_world.add_box(ground.height, cfg["terrain_resolution"], tuple(cfg["terrain_origin"]), x, y, half, 0.34)
    cells = ref_world.box_cells(tuple(ground.height.shape), cfg["terrain_resolution"], tuple(cfg["terrain_origin"]),
                                x, y, half)
    assert got.height is not ground.height and torch.equal(got.height, want)
    assert torch.equal(got.height != ground.height, cells & (ground.height < 0.34))
    assert int(cells.sum()) >= 1


def test_box_span_counts_the_cells_it_raises():
    ground = _ground(_cell()["cfg"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        add_box_obstacle(ground, 2.5, 0.0)
    assert [(r["name"], r["n"]) for r in profiling.spans()] == [("qtos::terrain.box", 4)]
    quiet = add_box_obstacle(ground, 2.5, 0.0)            # no profiler: the same grid, nothing recorded
    assert torch.equal(quiet.height, add_box_obstacle(ground, 2.5, 0.0).height)


def test_replan_on_a_world_with_a_box_agrees_with_the_reference():
    """The cell's first four worlds and their replans beside the boxes, at
    K=13: the port's replan (on the CPU, eager) and the reference's on the
    reference's own box, after START_ITERS LM iterations; on some of them
    the box moves the plan (the same replan on the world without it
    differs)."""
    cell = _cell()
    cfg = dict(cell["cfg"], K=K, window_duration=0.75)
    mix = dict(cell["mix"], worlds=4)
    inputs = traffic.make(mix, cfg, SEED, "cpu")
    rcfg = dataclasses.replace(program.runner_config(cfg), solver=program.solver_config(cfg["solver"]).replace(
        max_iters=START_ITERS))
    assert isinstance(rcfg, RunnerConfig)
    scfg = ref_solver.solver_config(cfg["solver"]).replace(max_iters=START_ITERS)
    box, moved = cfg["box"], 0
    for w in range(mix["worlds"]):
        world = add_box_obstacle(_ground(cfg), float(inputs["box_x"][w]), inputs["box_y"], half=box["half"],
                                 height=box["top"])
        assert torch.equal(world.height, inputs["worlds"][w])
        terr = ref_solver.terrain(inputs["worlds"][w], cfg)
        for p in range(w * mix["world_every"], (w + 1) * mix["world_every"]):
            args = (inputs["rows"][p], inputs["goals_r"][p], inputs["goals_yaw"][p])
            res, tables, contacts = plan_windows_batch(*args, world, rcfg, t0s=inputs["t0s"][p])
            specs = ref_solver.replan_specs(*args, terr, K=K, duration=cfg["window_duration"], gait=cfg["gait"])
            ref, ref_tables, ref_contacts = ref_solver.plan_windows(specs, inputs["t0s"][p], terr, scfg)
            assert compare.knot_gap(res.x, ref.x) <= START_GAP
            assert compare.table_gap(tables, contacts, ref_tables, ref_contacts) <= START_GAP
            flat, _, _ = plan_windows_batch(*args, _ground(cfg), rcfg, t0s=inputs["t0s"][p])
            moved += compare.knot_gap(flat.x, res.x) > 10 * START_GAP
    assert moved >= 1
