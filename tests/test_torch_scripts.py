"""The port's recorder, sweep and solve profiler on the CPU, each run from a
scratch directory.  The recorder is held to `scripts/record.py`'s contract:
one CSV row of [12 joint angles, 12 velocities, 12 torques] per tick,
duplicated `--copy-pts` times; status 0 exits 0."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import record_torch  # noqa: E402
import sweep_torch  # noqa: E402

sys.path.pop(0)

from qtos_torch.tools import profile_solve  # noqa: E402


def test_record_writes_the_hardware_replay_csv(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "traj"
    rc = record_torch.main(["--exp", "exp_1", "-g", "0.3", "0", "--copy-pts", "2", "--out", str(out),
                            "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and "solve status=0" in text
    rows = np.loadtxt(out / "towr_traj_cmode_torque.csv", delimiter=",")
    ticks = int(round(2.5 * 1000)) + 1                                   # K=41, 2.5 s at 1 kHz
    assert rows.shape == (2 * ticks, 36) and np.isfinite(rows).all()
    np.testing.assert_array_equal(rows[0::2], rows[1::2])                # each row twice
    assert np.abs(rows[:, 24:]).max() <= 8.0 + 1e-3                       # torques inside the motor clip
    summary = json.load(open(tmp_path / "logs" / "torch" / "record_exp_1.out"))
    assert summary["ticks"] == ticks
    assert not (tmp_path / "data").exists()                              # nothing outside --out and logs/torch


def _summary(reached, windows, ticks, holds, err, **extra):
    return dict(experiment="exp_1", reached_goal=reached, windows=windows, sim_ticks=ticks,
                final_pos=[2.05, 0.0, 0.24], goal=[2.1, 0.0, 0.24], avg_com_err_per_s=err,
                solve_ms_p50=700.0, stance_holds=holds, aborted=False, statuses=[0] * windows, **extra)


def test_sweep_renders_the_table_beside_the_reference(tmp_path):
    (tmp_path / "logs" / "torch").mkdir(parents=True)
    json.dump(_summary(True, 5, 12465, 0, 36.14, wall_time_s=115.06, btd_launches=150, device="cuda:0",
                       device_name="NVIDIA H100 80GB HBM3", power_limit="700.00 W"),
              open(tmp_path / "logs" / "torch" / "experiment_data_exp_1.out", "w"))
    json.dump(_summary(True, 5, 12465, 0, 33.8, wall_time_s=60.0),
              open(tmp_path / "logs" / "experiment_data_exp_1.out", "w"))
    json.dump(_summary(False, 13, 29922, 2, 141.4, wall_time_s=60.0),
              open(tmp_path / "logs" / "experiment_data_exp_2.out", "w"))
    render = lambda: sweep_torch.update_parity(                         # noqa: E731
        sweep_torch.render_table(sweep_torch.load_summaries(str(tmp_path)), str(tmp_path)), str(tmp_path))
    render()
    text = open(tmp_path / "docs" / "PARITY_TORCH.md").read()
    assert "Port runs on: NVIDIA H100 80GB HBM3, power limit 700.00 W." in text
    rows = {line.split("|")[1].strip(): line for line in text.splitlines() if line.startswith("| exp_")}
    assert sorted(rows) == sorted(f"exp_{i}" for i in range(1, 11))
    assert "| exp_1 | **yes** | — | 0.05 of 2.1 | 5 | 12465 | 0 | 36.1 | 115.1 | 150 |" in rows["exp_1"]
    assert rows["exp_1"].endswith("| **yes** | 5 | 12465 | 0 | 33.8 |")
    assert "no run" in rows["exp_2"] and rows["exp_2"].endswith("| no | 13 | 29922 | 2 | 141.4 |")
    assert "no run | — |" in rows["exp_3"]
    # re-rendering replaces the table and keeps what surrounds it
    path = tmp_path / "docs" / "PARITY_TORCH.md"
    path.write_text("# title\n\nnotes above\n\n" + text.split("\n", 1)[1] + "\nnotes below\n")
    render()
    again = path.read_text()
    assert again.count(sweep_torch.MARK_BEGIN) == 1 and "notes above" in again and "notes below" in again


def test_sweep_deletes_stale_evidence_before_a_run(tmp_path):
    stale = tmp_path / "logs" / "torch" / "experiment_data_exp_1.out"
    stale.parent.mkdir(parents=True)
    stale.write_text(json.dumps(_summary(True, 5, 12465, 0, 36.14)))
    # the run is cut at once, so it writes no summary: the stale one must not remain
    assert sweep_torch.run_experiment("exp_1", timeout=0.01, root=str(tmp_path)) is None
    assert not stale.exists()


@pytest.fixture(scope="module")
def profiled():
    return profile_solve.profile_once(4, K=13, device="cpu")


@pytest.mark.parametrize("key", ["top_kernels", "btd_share", "assembly_share", "idle_share", "device_busy_ms"])
def test_profile_solve_measures_no_device_number_on_the_cpu(profiled, key):
    assert (profiled["B"], profiled["K"], profiled["converged"], profiled["iterations"]) == (4, 13, 4, 3)
    assert profiled[key] == "not measured"


def test_profile_solve_prints_its_keys(profiled, capsys):
    assert profiled["aten_ops_per_iteration"] > 100                     # counted on the host
    profile_solve.report(profiled)
    text = capsys.readouterr().out
    assert "aten operations per LM iteration" in text and "not measured" in text


def test_profile_solve_marks_every_assemble_call():
    import torch

    from qtos_torch.solver import SolverConfig, default_spec, solve_batch
    from qtos_torch.terrain import make_terrain

    terrain = make_terrain(["plane"] * 3, device="cpu")
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, 4), 0.0), K=13, device="cpu")
    inner = profile_solve.solve_mod.assemble
    with profile_solve._marked_assembly() as seen, \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solve_batch(specs, terrain, SolverConfig(max_iters=3))
    assert seen == {"calls": 3, "rows": 12}
    assert sum(e.name == profile_solve.ASSEMBLE for e in prof.events()) == 3
    assert profile_solve.solve_mod.assemble is inner and inner.__name__ == "assemble"


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0), ([(0.0, 2.0)], 2.0), ([(1.0, 3.0), (0.0, 2.0), (5.0, 6.0)], 4.0), ([(0.0, 4.0), (1.0, 2.0)], 4.0)])
def test_profile_solve_busy_time_is_the_union_of_device_intervals(intervals, busy):
    assert profile_solve._busy_us(intervals) == busy


def test_profile_solve_reports_a_share_outside_the_unit_interval_unclamped(capsys):
    assert profile_solve._share(1.0, 4.0, "x") == 0.25 and capsys.readouterr().out == ""
    assert profile_solve._share(5.0, 4.0, "the busy share") == 1.25
    assert "WARNING: the busy share reads 1.2500" in capsys.readouterr().out


def test_profile_solve_tallies_kernels_without_its_own_ranges():
    """The trace lists each `record_function` range twice, on the host and
    as a device-side annotation over the kernels it launched: only real
    kernels count as busy time, and assembly is the host ranges' kernel time."""
    from types import SimpleNamespace

    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dtype, a, b, total=0.0):
        return SimpleNamespace(name=name, device_type=dtype, time_range=SimpleNamespace(start=a, end=b),
                               device_time_total=total)

    events = [ev(profile_solve.CALL, cpu, 0.0, 10.0), ev(profile_solve.CALL, cuda, 2.0, 20.0),
              ev(profile_solve.ASSEMBLE, cpu, 1.0, 3.0, total=5.0), ev(profile_solve.ASSEMBLE, cuda, 2.0, 9.0),
              ev("gemm", cuda, 2.0, 7.0), ev("btd_kernel", cuda, 8.0, 9.0), ev("copy", cuda, 15.0, 20.0),
              ev("qtos::lm.iter", cuda, 2.0, 9.5)]
    t = profile_solve._tally(events, {"calls": 1, "rows": 4})
    assert [e.name for e in t["kernels"]] == ["gemm", "btd_kernel", "copy"]
    assert (t["span_us"], t["busy_us"], t["assembly_us"]) == (20.0, 11.0, 5.0)
