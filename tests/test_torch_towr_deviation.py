"""scripts/towr_deviation_torch.py against scripts/towr_deviation.py on the CPU.

TOWR's golden table is not in the repository, but both scripts read any
37-column 1 kHz table.  So the golden here is a window that qtos_tpu solves
and samples on the CPU (plane x4, K=13, 1.5 s to (0.35, 0), 30 LM
iterations; fixed, no randomness), written as CSV to a temporary directory.
Both scripts then cut the same windows out of it.

Sizes: the measured windows are 1.0 s at K=11, solved with the script's
own 120 LM iterations: about 35 s per `measure` pair on one worker, most of it the
port's eager iterations on the CPU.  Converged, the two packages' figures
agree to 5e-5 m or better (measured at 80 and 120 iterations, rows 0 and
500); they are held to DEV_ATOL = 1 mm.  Mid-descent they need not: at 40
iterations, while the iterates still move by 0.1-0.4 per step, the feet's
rms deviation parted by 4 mm at row 500.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
import scripts.towr_deviation as ref_towr  # noqa: E402
import scripts.towr_deviation_torch as port_towr  # noqa: E402

sys.path.pop(0)

DURATION, K, ITERS = 1.0, 11, 120
TOL = 3e-3            # the SolverConfig tolerance both scripts solve to
DEV_ATOL = 1e-3       # m, on com_rms, feet_rms and end_dev
PROG_ATOL = 1e-6


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    from qtos_tpu.solver import SolverConfig, default_spec, sample_trajectory, solve
    from qtos_tpu.terrain import make_terrain

    terr = make_terrain(["plane"] * 4)
    spec = default_spec(terr, goal_xy=(0.35, 0.0), K=13, duration=1.5)
    res = solve(spec, terr, SolverConfig(max_iters=30, tol=TOL))
    assert int(res.status) == 0
    table, _ = sample_trajectory(res.x, spec, hz=1000)
    table = np.asarray(table)
    assert table.shape == (1501, 37)
    path = str(tmp_path_factory.mktemp("towr") / "golden.csv")
    np.savetxt(path, table, delimiter=",")
    return path


@pytest.mark.parametrize("row0", [0, 500])
def test_towr_window_matches(golden, monkeypatch, row0):
    monkeypatch.setattr(ref_towr, "GOLDEN", golden)
    jspec, jg = ref_towr.towr_window(DURATION, K, row0)
    spec, g = port_towr.towr_window(DURATION, K, row0, golden=golden, device="cpu")
    np.testing.assert_array_equal(g, jg)
    assert spec.dt == jspec.dt
    assert spec.schedule.contact.dtype == torch.float32
    np.testing.assert_array_equal(spec.schedule.contact.numpy(), np.asarray(jspec.schedule.contact))
    np.testing.assert_allclose(spec.schedule.swing_progress.numpy(), np.asarray(jspec.schedule.swing_progress),
                               atol=PROG_ATOL, rtol=0)
    for name in ("r", "eul", "v", "omega", "feet"):
        np.testing.assert_array_equal(getattr(spec.start, name).numpy(), np.asarray(getattr(jspec.start, name)))
    np.testing.assert_array_equal(spec.goal_r.numpy(), np.asarray(jspec.goal_r))
    assert float(spec.goal_yaw) == float(jspec.goal_yaw)
    assert float(spec.duration) == float(jspec.duration)
    # the window holds both swing and double support
    contact = spec.schedule.contact.numpy()
    assert (contact == 0).any() and (contact.sum(-1) == 4).any()


@pytest.mark.parametrize("row0", [0, 500])
def test_measure_matches(golden, monkeypatch, row0):
    monkeypatch.setattr(ref_towr, "GOLDEN", golden)
    jout, _, _ = ref_towr.measure(DURATION, K, ITERS, row0)
    out, res, _ = port_towr.measure(DURATION, K, ITERS, row0, golden=golden, device="cpu")
    assert res.x.device.type == "cpu"
    assert set(out) == set(jout)
    assert out["status"] == jout["status"] == 0
    assert out["max_violation"] < TOL and jout["max_violation"] < TOL
    for key in ("com_rms", "feet_rms", "end_dev"):
        assert abs(out[key] - jout[key]) <= DEV_ATOL, (key, out[key], jout[key])
    # the figures are the window's own, not zeros
    assert out["com_rms"] > 0 and np.isfinite(list(out.values())).all()


def test_measure_on_the_card_by_default(golden):
    """device=None means CUDA: without a card the script says so instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_towr.measure(DURATION, K, 1, 0, golden=golden)
