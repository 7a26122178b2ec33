"""The port's experiment presets, `build` and the command-line script (CPU)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from qtos_tpu.config import EXPERIMENTS as J_EXPERIMENTS

from qtos_torch.builder import Bundle, build
from qtos_torch.config import EXPERIMENTS, ExperimentConfig, get_experiment
from qtos_torch.control.replan import RunnerConfig
from qtos_torch.terrain import tile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.parametrize("name", sorted(J_EXPERIMENTS))
def test_experiment_matches(name):
    exp, jexp = EXPERIMENTS[name], J_EXPERIMENTS[name]
    assert [f.name for f in dataclasses.fields(exp)] == [f.name for f in dataclasses.fields(jexp)]
    for f in dataclasses.fields(exp):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    for tile_name in exp.maps:
        assert tile(tile_name).shape[0] >= 20


def test_get_experiment():
    assert set(EXPERIMENTS) == set(J_EXPERIMENTS)
    assert get_experiment("exp_3") is EXPERIMENTS["exp_3"] and get_experiment("3") is EXPERIMENTS["exp_3"]
    assert get_experiment("test").goal_xy == (1.0, 0.0)
    with pytest.raises(KeyError, match="unknown experiment"):
        get_experiment("exp_999")


def test_build_bundle_wiring():
    b = build("exp_1", goal_xy=(1.0, 0.0), device="cpu")
    assert isinstance(b, Bundle)
    assert b.exp.name == "exp_1"
    assert b.terrain.height.dim() == 2 and b.terrain.device.type == "cpu"
    assert b.runner.planner is b.planner
    assert b.runner.device.type == "cpu" and b.runner.buffer.device.type == "cpu"
    np.testing.assert_allclose(np.asarray(b.runner.goal_xy), [1.0, 0.0])   # goal override propagated
    assert b.blocked is None                                               # exp_1 has no bool_map_search
    # the preset's own runner configuration is the full-size one
    cfg = b.runner.cfg
    assert (cfg.K, cfg.window_duration, cfg.f_steps, cfg.n_candidates) == (41, 2.5, 2500, 4)
    assert cfg.avg_speed == b.exp.avg_speed and cfg.gait == b.exp.gait


def test_build_accepts_config_object_and_overrides():
    cfg = get_experiment("exp_2")
    rcfg = RunnerConfig(K=13, window_duration=1.5)
    b = build(cfg, runner_cfg=rcfg, device="cpu")
    assert b.exp is cfg and b.runner.cfg is rcfg
    np.testing.assert_allclose(b.runner.goal_xy, [5.6, 0.0])
    # a preset that probes by default can be built without the probe
    b3 = build("exp_3", probe_feasibility=False, device="cpu")
    assert b3.blocked is None and isinstance(b3.exp, ExperimentConfig)


def test_build_without_a_card_raises_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build("exp_1")


def test_cli_smoke_test_on_the_cpu(tmp_path):
    """`scripts/main_torch.py --test --device cpu` exits 0 and writes only
    under its --out directory and logs/torch/ of the directory it runs in."""
    out = tmp_path / "artifacts"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "main_torch.py"), "--test", "--device", "cpu",
         "--out", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout
    written = sorted(os.path.relpath(os.path.join(root, f), tmp_path)
                     for root, _, files in os.walk(tmp_path) for f in files)
    assert written == [os.path.join("logs", "torch", "smoke_test.out")]
    assert sorted(os.listdir(out)) == ["tracking", "traj"]
    summary = json.load(open(tmp_path / "logs" / "torch" / "smoke_test.out"))
    assert summary["ok"] is True and summary["device"] == "cpu" and "power_limit" in summary
    assert summary["mean_com_err"] < 0.15


def test_cli_parser_has_the_reference_flags():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import main as j_main
        import main_torch
    finally:
        sys.path.pop(0)

    def flags(parser):
        return {a.dest for a in parser._actions}
    got, want = flags(main_torch.build_parser()), flags(j_main.build_parser())
    assert got == (want - {"cpu"}) | {"device"}
    args = main_torch.build_parser().parse_args([])
    assert args.device is None and args.out == os.path.join("data", "torch")
    assert main_torch.LOG_DIR == os.path.join("logs", "torch")
