"""`qtos_torch.utils` against `qtos_tpu.utils` on the same numpy inputs.
The containers, codecs and tracking summary are numpy code in both packages,
so they are compared exactly."""

import os
import types

import numpy as np
import pytest
import torch

from qtos_tpu.utils import containers as j_containers
from qtos_tpu.utils import frames as j_frames
from qtos_tpu.utils.profiling import solve_telemetry as j_solve_telemetry
from qtos_tpu.utils.tracking import Tracking as JTracking

from qtos_torch.utils import Logger, Timer, annotate, cmd_pose_from_row, row_from_cmd_pose, solve_telemetry, trace
from qtos_torch.utils import containers, frames
from qtos_torch.utils.tracking import Tracking
from qtos_torch.utils.visual import VisualPlanner


@pytest.mark.parametrize("mod", [containers, j_containers], ids=["torch", "tpu"])
def test_containers(mod):
    q = mod.LimitedFIFOQueue(3)
    assert q.average() == 0.0
    for v in (1.0, 2.0, 3.0, 4.0):
        q.enqueue(v)
    assert len(q) == 3 and q.average() == 3.0 and q.dequeue() == 2.0
    f = mod.FIFOQueue()
    with pytest.raises(IndexError):
        f.dequeue()
    f.enqueue("a")
    assert f.size() == len(f) == 1 and not f.is_empty() and f.dequeue() == "a"
    s = mod.LimitedStack(2)
    with pytest.raises(IndexError):
        s.pop()
    with pytest.raises(IndexError):
        s.peek()
    for i in range(3):
        s.push((np.array([i, 0.0]), np.array([i, 1.0, 2.0])))
    assert s.size() == 2 and s.peek() == ([2.0, 0.0], [2.0, 1.0, 2.0])
    assert s.pop()[0] == [2.0, 0.0] and s.pop()[0] == [1.0, 0.0] and s.is_empty()
    s.push("x")
    s.clear()
    assert s.is_empty() and mod.Limited_Stack is mod.LimitedStack


def test_frames_round_trip_matches():
    rng = np.random.default_rng(0)
    row = rng.standard_normal(37).astype(np.float32)
    cmd, jcmd = cmd_pose_from_row(row), j_frames.cmd_pose_from_row(row)
    assert frames.EE_NAMES == j_frames.EE_NAMES
    assert set(cmd) == set(jcmd)
    for k in cmd:
        a, b = (cmd[k]["P"], jcmd[k]["P"]) if isinstance(cmd[k], dict) else (cmd[k], jcmd[k])
        np.testing.assert_array_equal(a, b)
    back = row_from_cmd_pose(float(row[0]), cmd)
    np.testing.assert_array_equal(back, row)
    np.testing.assert_array_equal(back, j_frames.row_from_cmd_pose(float(row[0]), jcmd))


def test_logger_appends(tmp_path):
    log = Logger(str(tmp_path / "logs"), "run")
    log.write("first")
    log.write("second")
    log.close()
    lines = open(tmp_path / "logs" / "run.out").read().splitlines()
    assert len(lines) == 2 and lines[0].endswith("first") and lines[1].endswith("second")


def test_tracking_summary_matches(tmp_path):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((200, 37)).astype(np.float32)
    table[:, 0] = np.arange(200) / 1000.0
    sim_pos = table[:, 1:4] + 0.01 * rng.standard_normal((200, 3)).astype(np.float32)
    sim_feet = table[:, 7:19].reshape(-1, 4, 3) + 0.01
    tr, jtr = Tracking(str(tmp_path / "t")), JTracking(str(tmp_path / "j"))
    for t in (tr, jtr):
        t.extend(table[:120], sim_pos[:120], sim_feet=sim_feet[:120])
        t.extend(table[120:], sim_pos[120:], sim_feet=sim_feet[120:])
    assert tr.summary() == jtr.summary()                     # exact: the same numpy code
    assert tr.summary()["ticks"] == 200
    tr.write_log(str(tmp_path / "logs" / "experiment_data.out"))
    assert "avg_com_err_per_s" in open(tmp_path / "logs" / "experiment_data.out").read()
    tr.plot()
    assert sorted(os.listdir(tmp_path / "t")) == [
        "CoM_track.png", "ref_sim_com.png", "ref_sim_feet.png",
        "tracking_error.png", "tracking_error_vs_distance.png"]
    path = VisualPlanner(table, out_dir=str(tmp_path / "v"), look_ahead=100, step_size=5).render(at_row=20)
    assert os.path.getsize(path) > 0


def test_timer_and_solve_telemetry_keys():
    res = types.SimpleNamespace(
        status=np.array([0, 1, 0, 0], np.int32),
        max_violation=np.array([1e-3, 5e-2, 2e-3, 1.5e-3], np.float32),
        merit=np.array([0.1, 0.4, 0.2, 0.3], np.float32),
        iters=np.array([30, 30, 30, 30], np.int32),
    )
    tres = types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in vars(res).items()})
    with Timer() as t:
        out = tres.merit * 2
        t.block(out, {"a": [tres.status]}, tres)             # CPU tensors: nothing to wait for
    assert t.elapsed is not None and t.elapsed >= 0.0
    got, want = solve_telemetry(tres, wall_s=0.5), j_solve_telemetry(res, wall_s=0.5)
    assert got == want
    assert set(solve_telemetry(tres)) == set(want) - {"wall_s", "solves_per_s"}


def test_trace_and_annotate_write_a_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as logdir:
        with annotate("region"):
            torch.ones(4).sum()
    text = open(os.path.join(logdir, "trace.json")).read()
    assert "region" in text
