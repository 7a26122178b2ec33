"""qtos_torch terrain editing, natural cubic splines and the global planner
against qtos_tpu on identical inputs (CPU).

Tolerances: grid operations, A* and the probe's enumeration are exact;
splines atol=1e-5 (float32 Thomas solve over <= 40 knots of O(1) values);
planner queries 1e-4 (float32 spline values of O(1-5) m, then float64 numpy
interpolation of the same dense samples in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.ops.splines import natural_cubic_coeffs as j_coeffs
from qtos_tpu.ops.splines import natural_cubic_eval as j_eval
from qtos_tpu.ops.splines import tridiag_solve as j_tridiag_solve
from qtos_tpu.planner import GlobalPlanner as JGlobalPlanner
from qtos_tpu.planner import astar as j_astar
from qtos_tpu.planner import feasibility as j_feas
from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.terrain import heightfield as j_hf
from qtos_tpu.terrain import make_terrain as j_make_terrain
from qtos_tpu.terrain import tile

from qtos_torch.convert import spec_from_reference
from qtos_torch.ops.splines import natural_cubic_coeffs, natural_cubic_eval, tridiag_solve
from qtos_torch.planner import GlobalPlanner, astar, feasibility_map
from qtos_torch.planner import feasibility as t_feas
from qtos_torch.solver import SolverConfig, default_spec
from qtos_torch.terrain import (
    add_box_obstacle,
    export_heightfield_txt,
    import_heightfield_txt,
    make_terrain,
    shift_terrain,
    traversability_map,
)

ATOL = 1e-5
ATOL_PLAN = 1e-4


# -- terrain ---------------------------------------------------------------

@pytest.mark.parametrize("tiles,scale", [(["stair", "bridge"], 1), (["feasibility", "plane"], 2)])
def test_traversability_map_matches(tiles, scale):
    out = traversability_map(make_terrain(tiles, scale_factor=scale, device="cpu"))
    ref = j_hf.traversability_map(j_make_terrain(tiles, scale_factor=scale))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.sum() > 0


@pytest.mark.parametrize("rows,cols", [(0, 0), (3, 0), (-2, 0), (0, 5), (0, -4), (2, -3)])
def test_shift_terrain_matches(rows, cols):
    terr = make_terrain(["stair", "plane"], device="cpu")
    before = terr.height.clone()
    out = shift_terrain(terr, rows, cols, fill=0.5)
    ref = j_hf.shift_terrain(j_make_terrain(["stair", "plane"]), rows, cols, fill=0.5)
    np.testing.assert_array_equal(out.height.numpy(), np.asarray(ref.height))
    assert torch.equal(terr.height, before)                # out of place
    assert out.resolution == terr.resolution and out.origin == terr.origin


@pytest.mark.parametrize("x,y,half", [(1.0, 0.0, 0.1), (-0.97, 0.95, 0.1), (2.9, -0.5, 0.25)])
def test_add_box_obstacle_matches(x, y, half):
    terr = make_terrain(["stair", "plane"], device="cpu")
    before = terr.height.clone()
    out = add_box_obstacle(terr, x, y, half=half)
    ref = j_hf.add_box_obstacle(j_make_terrain(["stair", "plane"]), x, y, half=half)
    np.testing.assert_array_equal(out.height.numpy(), np.asarray(ref.height))
    assert torch.equal(terr.height, before)
    assert float(out.height.max()) >= 0.34


@pytest.mark.parametrize("towr_frame", [False, True])
def test_heightfield_txt_round_trip(tmp_path, towr_frame):
    tiles = ["stair", "plane"]
    terr, jterr = make_terrain(tiles, device="cpu"), j_make_terrain(tiles)
    p, jp = tmp_path / "t.txt", tmp_path / "j.txt"
    export_heightfield_txt(terr, str(p), towr_frame=towr_frame)
    j_hf.export_heightfield_txt(jterr, str(jp), towr_frame=towr_frame)
    assert p.read_text() == jp.read_text()
    back = import_heightfield_txt(str(p), device="cpu")
    jback = j_hf.import_heightfield_txt(str(jp))
    np.testing.assert_array_equal(back.height.numpy(), np.asarray(jback.height))
    if not towr_frame:
        np.testing.assert_array_equal(back.height.numpy(), terr.height.numpy())
    # plain whitespace txt is read too
    np.savetxt(tmp_path / "w.txt", terr.height.numpy())
    plain = import_heightfield_txt(str(tmp_path / "w.txt"), resolution=0.05, origin=(0.0, 0.0), device="cpu")
    np.testing.assert_allclose(plain.height.numpy(), terr.height.numpy(), atol=0)
    assert plain.resolution == 0.05 and plain.origin == (0.0, 0.0)


# -- splines ---------------------------------------------------------------

def test_tridiag_solve_matches():
    rng = np.random.default_rng(0)
    n = 12
    d = (4.0 + rng.uniform(0, 1, n)).astype(np.float32)
    dl, du = (rng.uniform(-1, 1, (2, n))).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    out = tridiag_solve(*(torch.from_numpy(a) for a in (dl, d, du, b)))
    ref = j_tridiag_solve(*(jnp.asarray(a) for a in (dl, d, du, b)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    np.testing.assert_allclose(A @ out.numpy(), b, atol=1e-4)


@pytest.mark.parametrize("shape", [(9,), (40,), (15, 2)])
def test_natural_cubic_matches(shape):
    rng = np.random.default_rng(1)
    y = np.cumsum(rng.uniform(-0.3, 0.5, size=shape), axis=0).astype(np.float32)
    h = 0.7
    m, jm = natural_cubic_coeffs(torch.from_numpy(y), h), j_coeffs(jnp.asarray(y), h)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=ATOL)
    assert float(m[0].abs().max()) == 0.0 and float(m[-1].abs().max()) == 0.0
    xq = rng.uniform(-0.5, h * shape[0], size=64).astype(np.float32)
    val, der = natural_cubic_eval(torch.from_numpy(y), m, h, 0.0, torch.from_numpy(xq))
    jval, jder = j_eval(jnp.asarray(y), jm, h, 0.0, jnp.asarray(xq))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), atol=ATOL)
    np.testing.assert_allclose(der.numpy(), np.asarray(jder), atol=ATOL)
    # the spline interpolates its knots
    knots = torch.arange(shape[0], dtype=torch.float32) * h
    at_knots, _ = natural_cubic_eval(torch.from_numpy(y), m, h, 0.0, knots)
    np.testing.assert_allclose(at_knots.numpy(), y, atol=1e-5)


# -- A* ----------------------------------------------------------------------

def _grids():
    rng = np.random.default_rng(2)
    wall = np.zeros((10, 20), bool)
    wall[:8, 10] = True
    sealed = np.zeros((5, 5), bool)
    sealed[:, 2] = True
    noise = rng.uniform(size=(20, 40)) < 0.25
    noise[10, 0] = noise[10, 39] = False
    return {"open": (np.zeros((10, 20), bool), (5, 0), (5, 19)), "wall": (wall, (2, 2), (2, 18)),
            "sealed": (sealed, (2, 0), (2, 4)), "noise": (noise, (10, 0), (10, 39))}


@pytest.mark.parametrize("name", ["open", "wall", "sealed", "noise"])
@pytest.mark.parametrize("diagonal", [True, False])
@pytest.mark.parametrize("with_cost", [False, True])
def test_astar_matches_cell_for_cell(name, diagonal, with_cost):
    blocked, start, goal = _grids()[name]
    cost = np.random.default_rng(3).uniform(0, 0.5, size=blocked.shape) if with_cost else None
    out = astar(blocked, start, goal, diagonal=diagonal, cost=cost)
    ref = j_astar(blocked, start, goal, diagonal=diagonal, cost=cost)
    if ref is None:
        assert out is None and name == "sealed"
    else:
        np.testing.assert_array_equal(out, ref)
        assert out.dtype == ref.dtype


def test_astar_rejects_blocked_or_outside_endpoints():
    blocked = np.zeros((4, 4), bool)
    blocked[0, 0] = True
    assert astar(blocked, (0, 0), (3, 3)) is None
    assert astar(blocked, (1, 1), (4, 3)) is None


# -- feasibility probe -------------------------------------------------------

def test_probe_enumeration_matches():
    t = tile("feasibility")
    np.testing.assert_array_equal(t_feas._danger_mask(t), j_feas._danger_mask(t))
    np.testing.assert_array_equal(t_feas._danger_mask(t, thresh=0.5), j_feas._danger_mask(t, thresh=0.5))
    pairs = t_feas._candidate_pairs(t)
    assert pairs and pairs == j_feas._candidate_pairs(t)
    for r in (1, 3):
        np.testing.assert_array_equal(t_feas._diamond_offsets(r), j_feas._diamond_offsets(r))
    a, b = np.zeros((6, 6), bool), np.zeros((6, 6), bool)
    t_feas._stamp(a, (0, 5), t_feas._diamond_offsets(3))
    j_feas._stamp(b, (0, 5), j_feas._diamond_offsets(3))
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0


def test_feasibility_map_flat_short_circuit():
    m = feasibility_map(make_terrain(["plane", "plane"], device="cpu"))
    assert m.dtype == np.float32 and m.shape == (20, 40) and m.sum() == 0


def test_default_spec_takes_batched_starts():
    """`feasibility_map` builds its probe batch from per-pair start and goal
    cells: the counterpart of `jax.vmap(default_spec)` over both."""
    tiles = ["feasibility", "plane"]
    rng = np.random.default_rng(4)
    starts = np.stack([rng.uniform(-0.8, 2.0, 8), rng.uniform(-0.8, 0.8, 8)], 1).astype(np.float32)
    goals = starts + np.array([0.2, 0.0], np.float32)
    jterr = j_make_terrain(tiles)
    ref = jax.vmap(lambda s, g: j_default_spec(jterr, start_xy=tuple(s), goal_xy=tuple(g), duration=1.5, K=13))(
        jnp.asarray(starts), jnp.asarray(goals))
    ref = spec_from_reference(jax.tree_util.tree_map(np.asarray, ref), device="cpu")
    terr = make_terrain(tiles, device="cpu")
    out = default_spec(terr, start_xy=(starts[:, 0], starts[:, 1]), goal_xy=(goals[:, 0], goals[:, 1]),
                       duration=1.5, K=13, device="cpu")
    assert out.dt == ref.dt
    for name in ("r", "eul", "v", "omega", "feet"):
        a, b = getattr(out.start, name), getattr(ref.start, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, err_msg=name)
    for a, b in [(out.goal_r, ref.goal_r), (out.goal_yaw, ref.goal_yaw), (out.duration, ref.duration),
                 (out.schedule.contact, ref.schedule.contact),
                 (out.schedule.swing_progress, ref.schedule.swing_progress)]:
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_feasibility_map_small_probe_matches():
    """The first 16 candidate pairs of the pillar tile, K=13, three LM
    iterations: the blocked map equals `qtos_tpu`'s."""
    tiles = ["feasibility", "plane"]
    kw = dict(K=13, max_batch=16)
    ref = j_feas.feasibility_map(j_make_terrain(tiles), cfg=JConfig(max_iters=3), **kw)
    out = feasibility_map(make_terrain(tiles, device="cpu"), cfg=SolverConfig(max_iters=3), **kw)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    rough = traversability_map(make_terrain(tiles, device="cpu")).numpy() > 0.5
    assert (out > 0.5)[rough].all() and out.sum() > rough.sum()       # the probe stamped something


# -- global planner ----------------------------------------------------------

PLANNER_CASES = {
    "obstacle": (["plane", "obstacle", "plane"], 1, (0.0, 0.0), (4.5, 0.0)),
    "stair-bridge-x2": (["stair", "bridge"], 2, (0.0, 0.0), (2.6, 0.0)),
}


@pytest.fixture(scope="module", params=sorted(PLANNER_CASES))
def planners(request):
    tiles, scale, start, goal = PLANNER_CASES[request.param]
    gp = GlobalPlanner(make_terrain(tiles, scale_factor=scale, device="cpu"), start, goal)
    jgp = JGlobalPlanner(j_make_terrain(tiles, scale_factor=scale), start, goal)
    return gp, jgp, goal


def test_global_planner_matches(planners):
    gp, jgp, goal = planners
    np.testing.assert_array_equal(gp.blocked, jgp.blocked)
    assert abs(gp.path_length - jgp.path_length) < ATOL_PLAN
    assert abs(gp.total_time - jgp.total_time) < ATOL_PLAN * 10
    ts = np.linspace(-0.5, gp.total_time + 0.5, 50)
    x, y, yaw = gp.point_at(ts)
    ref = np.array([[float(v) for v in jgp.point_at(t)] for t in ts])
    np.testing.assert_allclose(x.numpy(), ref[:, 0], atol=ATOL_PLAN)
    np.testing.assert_allclose(y.numpy(), ref[:, 1], atol=ATOL_PLAN)
    dyaw = yaw.numpy() - ref[:, 2]
    np.testing.assert_allclose(np.arctan2(np.sin(dyaw), np.cos(dyaw)), 0.0, atol=1e-3)
    x1, y1, _ = gp.point_at(float(ts[7]))                       # a single time
    assert abs(float(x1) - ref[7, 0]) < ATOL_PLAN and abs(float(y1) - ref[7, 1]) < ATOL_PLAN
    xe, ye, _ = gp.point_at(gp.total_time)
    assert abs(float(xe) - goal[0]) < 1e-3 and abs(float(ye) - goal[1]) < 1e-3
    np.testing.assert_allclose(gp._dense_xy, jgp._dense_xy, atol=ATOL_PLAN)


def test_global_planner_queries_match(planners):
    gp, jgp, _ = planners
    for t in np.linspace(0.0, gp.total_time, 7):
        for horizon in (0.5, 2.5):
            (p, yaw), (jp, jyaw) = gp.spine_step(t, horizon), jgp.spine_step(t, horizon)
            np.testing.assert_allclose(p, jp, atol=ATOL_PLAN)
            assert abs(np.arctan2(np.sin(yaw - jyaw), np.cos(yaw - jyaw))) < 1e-3
            assert abs(gp.height_span(t, horizon) - jgp.height_span(t, horizon)) < ATOL_PLAN
            assert abs(gp.turn_in(t, horizon) - jgp.turn_in(t, horizon)) < ATOL_PLAN
    rng = np.random.default_rng(5)
    for xy in rng.uniform([-0.5, -0.8], [3.0, 0.8], size=(8, 2)):
        assert abs(gp.time_at_position(xy) - jgp.time_at_position(xy)) < ATOL_PLAN


@pytest.mark.parametrize("tiles,goal,native", [
    (["plane", "plane"], (2.0, 0.4), True),              # flat: no soft cost anywhere
    (["feasibility", "plane"], (2.6, 0.0), False),       # pillars: the soft cost applies
], ids=["flat", "pillars"])
def test_global_planner_picks_the_search_of_the_reference(tiles, goal, native, monkeypatch):
    """Both packages search with their native A* where no soft cost applies
    and with the Python `astar` (which takes the cost) elsewhere, and give
    the same path."""
    import qtos_tpu.planner.global_planner as j_gp_mod
    import qtos_tpu.runtime as j_runtime
    import qtos_torch.planner.global_planner as t_gp_mod

    calls = []

    def spy(mod, name, tag):
        inner = getattr(mod, name)

        def wrapped(*args, **kw):
            calls.append((tag, kw.get("cost") is not None))
            return inner(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    assert t_gp_mod.native_available() and j_runtime.native_available()
    spy(t_gp_mod, "native_astar", "t-native")
    spy(t_gp_mod, "astar", "t-python")
    spy(j_runtime, "native_astar", "j-native")
    spy(j_gp_mod, "astar", "j-python")
    start = (0.0, 0.0)
    gp = GlobalPlanner(make_terrain(tiles, device="cpu"), start, goal)
    jgp = JGlobalPlanner(j_make_terrain(tiles), start, goal)
    want = ("native", False) if native else ("python", True)
    assert calls == [(f"t-{want[0]}", want[1]), (f"j-{want[0]}", want[1])]
    assert gp.blocked.any() != native
    np.testing.assert_array_equal(gp.blocked, jgp.blocked)
    assert abs(gp.path_length - jgp.path_length) < ATOL_PLAN
    np.testing.assert_allclose(gp._dense_xy, jgp._dense_xy, atol=ATOL_PLAN)


def test_global_planner_blocked_argument_and_no_path(tmp_path):
    terr = make_terrain(["plane", "plane"], device="cpu")
    wall = np.zeros((20, 40), np.float32)
    wall[:, 20] = 1.0
    with pytest.raises(RuntimeError, match="no path"):
        GlobalPlanner(terr, (0.0, 0.0), (2.0, 0.0), blocked=wall)
    wall[:4, 20] = 0.0
    for blocked in (wall, torch.from_numpy(wall)):
        gp = GlobalPlanner(terr, (0.0, 0.0), (2.0, 0.0), blocked=blocked)
        assert gp.path_length > 2.5                             # around the wall
    gp.save_plot(str(tmp_path / "plan.png"))
    assert (tmp_path / "plan.png").stat().st_size > 0
