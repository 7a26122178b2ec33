"""The cell on a changing world, `replan.exp8` (traffic kind
`replans_world`, driver `plan_windows_world`), at small sizes on the CPU:
a sound run is correct and counts its graphs, the replans stand clear of
every raised cell on their own world, the reservoir keeps whole worlds
whose replans see their box, and a reference that plans on the world before
is caught."""

from __future__ import annotations

import time
import types

import torch

from benchmark import harness, traffic
from benchmark.reference import world as ref_world
from benchmark.reference.heightfield import height_at
from benchmark.reference.solo12 import Solo12
from benchmark.reference.solver import terrain

SEED = 2**31 + 12345
CELL = "replan.exp8"


def small_cell() -> dict:
    """The cell at a CPU's size: 13 knots, windows of 0.75 s, 4 LM
    iterations, 24 worlds; the limits and the mix's ranges are the cell's."""
    cell = harness.load_cell(CELL)
    cfg = cell["cfg"]
    cfg["K"], cfg["window_duration"] = 13, 0.75
    cfg["solver"]["max_iters"] = 4
    cell["mix"] = dict(cell["mix"], worlds=24)
    return cell


def run(cell: dict, seconds: float = 2.0, trace: int = 0) -> dict:
    args = types.SimpleNamespace(seed=SEED, seconds=seconds, trace=trace)
    return harness.measure(harness.index(), cell, args, torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct_and_traced_run_reads_the_replay_share():
    line = run(small_cell())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"replan_ms", "replan_p95_ms", "setup_s"}
    traced = run(small_cell(), seconds=1.0, trace=1)
    assert traced["correct"], traced["checks"]
    # no kernel runs on the CPU, and no call captures a graph there
    assert traced["metrics"] == {"device_idle_pct.replan": traced["metrics"]["device_idle_pct.replan"],
                                 "replay_pct.exp8": dict(value=0.0, unit="%")}


def test_replans_stand_clear_on_their_own_world():
    """No start foot over a raised cell (box or wall) of the replan's world;
    feet on that world's ground, CoM and goals the stand height above it,
    beside the world's box within the mix's lateral range; a world seen
    where a start foot of its replans stands on ground the box changed, and
    a good share of worlds seen."""
    cell = harness.load_cell(CELL)
    cfg, mix = cell["cfg"], dict(cell["mix"], worlds=48)
    r = traffic.make(mix, cfg, SEED, "cpu")
    k = cfg["n_candidates"]
    assert r["rows"].shape == (96, k, 37) and r["worlds"].shape == (48, 20, 60)
    res, origin = cfg["terrain_resolution"], tuple(cfg["terrain_origin"])
    base = harness.terrain_grid(cfg, "cpu")
    flat = terrain(base, cfg)
    lo, hi = mix["com_side"]
    sees = torch.zeros(48, dtype=torch.bool)
    for p in range(96):
        w = int(r["world_of"][p])
        assert w == p // mix["world_every"]
        grid = r["worlds"][w]
        want = ref_world.add_box(base, res, origin, float(r["box_x"][w]), r["box_y"], cfg["box"]["half"],
                                 cfg["box"]["top"])
        assert torch.equal(grid, want) and float(grid.max()) > 1.0            # the box and the wall
        ground = terrain(grid, cfg)
        feet = r["rows"][p, :, 7:19].reshape(k, 4, 3)
        row, col = ref_world.cell_of(tuple(grid.shape), res, origin, feet[..., 0], feet[..., 1])
        assert not bool(ref_world.raised(grid)[row, col].any()), p
        assert torch.equal(feet[..., 2], height_at(ground, feet[..., 0], feet[..., 1]))
        sees[w] |= bool((feet[..., 2] != height_at(flat, feet[..., 0], feet[..., 1])).any())
        com, goal = r["rows"][p, :, 1:4], r["goals_r"][p]
        for q in (com, goal):
            assert torch.allclose(q[:, 2] - height_at(ground, q[:, 0], q[:, 1]), torch.full((k,), Solo12.stand_height))
        side = float((com[0, 1] - r["box_y"]).abs())
        assert lo - 1e-6 <= side <= hi + 1e-6
        assert torch.equal(goal[:, 1], com[:, 1]) and bool((goal[:, 0] > com[:, 0]).all())
    assert 2.3 <= float(r["box_x"].min()) and float(r["box_x"].max()) <= 3.0
    assert torch.equal(r["seen"], sees) and 0.25 <= float(sees.float().mean()) < 1.0


def test_traffic_is_made_from_the_seed():
    cell = harness.load_cell(CELL)
    mix = dict(cell["mix"], worlds=8)
    a = traffic.make(mix, cell["cfg"], SEED, "cpu")
    b = traffic.make(mix, cell["cfg"], SEED, "cpu")
    c = traffic.make(mix, cell["cfg"], SEED + 1, "cpu")
    assert all(torch.equal(a[key], b[key]) for key in ("rows", "goals_r", "t0s", "box_x", "worlds", "seen"))
    assert not torch.equal(a["box_x"], c["box_x"])


def test_reservoir_keeps_whole_worlds_and_stale_world_is_caught():
    """The kept replans are both replans of each kept world, every kept
    world one whose replans see its box; the report check reads more seen
    worlds than it solves; `start_gap`, which the cell gives no limit, is
    read and left out of the check; the reference planning each replan on
    the world before its own fails the exact report check."""
    cell = small_cell()
    drv = harness.load_module("drivers", cell["driver"]).Driver(cell, SEED, torch.device("cpu"))
    for n in range(24):
        drv.step(n)
    drv.release()
    kept, groups = drv._groups()
    assert len(kept) == 8 and sorted(len(js) for js in groups.values()) == [2, 2, 2, 2]
    seen = [w for w in range(12) if drv.seen[w]]
    assert all(drv.seen[w] for w in groups) and 4 < len(seen) < 12
    assert drv.counters()["calls"] == 24 and {"captures", "replays"} <= set(drv.counters())
    program = {c["name"]: c for c in drv.check()}
    assert set(program) == {"report_gap", "viol_excess_median", "merit_excess", "launch_mismatch"}
    assert all(c["value"] <= c["limit"] for c in program.values()), program
    assert drv.detail["report_worlds"] == len(seen) and drv.detail["report_wide"] == 0.0
    assert 0.0 < drv.detail["values"]["start_gap"] < 0.01
    stale = {c["name"]: c for c in drv.control("stale_world")}
    assert stale["report_gap"]["value"] > stale["report_gap"]["limit"], stale
    assert drv.detail["report_wide"] > 0.0
