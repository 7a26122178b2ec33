"""A checkpoint of `qtos_tpu`'s runner resumes in `qtos_torch` (CPU).

`qtos_tpu` walks one window (full-size window, K=41, 2.5 s, `f_steps` 1250,
2 candidates, goal 0.6 m on flat ground) and writes its checkpoint;
`runner_state_from_reference` carries it into the port's runner, every array
equal bit for bit (they are copies), and the port finishes the walk."""

import dataclasses

import jax
import numpy as np
import pytest

from qtos_tpu.control import replan as j_replan
from qtos_tpu.control.loop import ControlParams as JControlParams
from qtos_tpu.sim.engine import SimState as JSimState
from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.control import replan as t_replan
from qtos_torch.convert import (
    runner_config_from_reference,
    runner_state_from_reference,
    terrain_from_reference,
)
from qtos_torch.sim.engine import SimState

WALK = dict(K=41, window_duration=2.5, f_steps=1250, lookahead=1875, n_candidates=2,
            stance_warmup_steps=100, buffer_rows=8000)
GOAL = (0.6, 0.0)


def test_sim_leaves_are_in_the_reference_flatten_order():
    """`sim_<i>` in a checkpoint is leaf i of JAX's flattening of SimState:
    the explicit list the port keeps must name the same fields in that order."""
    assert t_replan.SIM_LEAVES == tuple(f.name for f in dataclasses.fields(SimState))
    marked = JSimState(**{name: np.full((i + 1,), float(i)) for i, name in enumerate(t_replan.SIM_LEAVES)})
    leaves, _ = jax.tree_util.tree_flatten(marked)
    assert len(leaves) == len(t_replan.SIM_LEAVES)
    for i, leaf in enumerate(leaves):
        assert leaf.shape == (i + 1,) and float(leaf[0]) == float(i)


def test_runner_config_from_reference():
    jcfg = j_replan.RunnerConfig(
        lookahead=1875, f_steps=1250, n_candidates=2, gait="walk", warm_start=True, turn_pace=0.5,
        checkpoint_path="x.npz", solver=JConfig(max_iters=20, tol=3e-3),
        control=JControlParams(yaw_corr=0.1))
    cfg = runner_config_from_reference(jcfg)
    assert isinstance(cfg, t_replan.RunnerConfig)
    for f in dataclasses.fields(t_replan.RunnerConfig):
        if f.name not in ("solver", "control"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
            assert type(getattr(cfg, f.name)) is type(getattr(jcfg, f.name)), f.name
    assert cfg.solver.max_iters == 20 and cfg.solver.tol == 3e-3 and cfg.control.yaw_corr == 0.1
    assert runner_config_from_reference(j_replan.RunnerConfig()) == t_replan.RunnerConfig()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_checkpoint.npz")
    jterr = j_make_terrain(["plane", "plane"])
    jcfg = j_replan.RunnerConfig(solver=JConfig(max_iters=20, tol=3e-3), max_windows=1,
                                 checkpoint_every=1, checkpoint_path=path, **WALK)
    jr = j_replan.RecedingHorizonRunner(jterr, GOAL, cfg=jcfg)
    jr.run(verbose=False)
    return jterr, jcfg, jr, path


def test_reference_checkpoint_resumes_in_the_port(checkpoint, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jterr, jcfg, jr, path = checkpoint
    with np.load(path, allow_pickle=False) as z:
        d = dict(z)
    state = runner_state_from_reference(d)
    cfg = dataclasses.replace(runner_config_from_reference(jcfg), max_windows=8, checkpoint_every=0,
                              checkpoint_path=str(tmp_path / "port_checkpoint.npz"))
    runner = t_replan.RecedingHorizonRunner(terrain_from_reference(jterr, device="cpu"), GOAL,
                                            cfg=cfg, device="cpu")
    runner.load_state_dict(state)

    st = runner._st
    assert st["exec_idx"] == jr._st["exec_idx"] == 1250 and st["window"] == 1
    assert runner.buffer_end == jr.buffer_end
    np.testing.assert_array_equal(runner.buffer.numpy(), np.asarray(jr.buffer))
    np.testing.assert_array_equal(runner.contact_buf.numpy(), np.asarray(jr.contact_buf))
    np.testing.assert_array_equal(runner._row_shift, jr._row_shift)
    np.testing.assert_array_equal(runner.host_buf.read(0, runner.buffer_end),
                                  jr.host_buf.read(0, jr.buffer_end))
    for name in t_replan.SIM_LEAVES:
        np.testing.assert_array_equal(getattr(st["sim"], name).numpy(),
                                      np.asarray(getattr(jr._st["sim"], name)), err_msg=name)
    np.testing.assert_array_equal(st["prev_x"].numpy(), np.asarray(jr._st["prev_x"]))
    assert st["statuses"] == list(jr._st["statuses"]) and st["planning_done"] == jr._st["planning_done"]
    assert len(st["com_errs"][0]) == 1250
    # copies: the port's state does not follow the source arrays
    d["buffer"][0] = 99.0
    state["buffer"][1] = 99.0
    assert float(runner.buffer[0, 3]) != 99.0 and float(runner.buffer[1, 3]) != 99.0

    # the port's own checkpoint has the same keys, and the walk finishes from it
    own = runner.save_checkpoint()
    with np.load(own, allow_pickle=False) as z:
        assert set(z.files) == set(d)
        for key in d:
            if key != "buffer":
                np.testing.assert_array_equal(z[key], state[key], err_msg=key)
    rep = runner.run(verbose=False, resume_from=own)
    assert rep.reached_goal and not rep.aborted and rep.stance_holds == 0
    assert all(s == 0 for s in rep.statuses) and rep.windows >= 2
    assert np.linalg.norm(rep.final_pos[:2] - np.array(GOAL)) < 0.15
    assert rep.avg_com_err_per_s < 120.0
    assert rep.sim_ticks == len(rep.com_err_series) == len(rep.ref_table) > 1250


def test_runner_state_from_reference_rejects_a_broken_checkpoint(checkpoint):
    with np.load(checkpoint[3], allow_pickle=False) as z:
        d = dict(z)
    for drop in ("buffer", "sim_6", "row_shift"):
        with pytest.raises(KeyError, match=drop):
            runner_state_from_reference({k: v for k, v in d.items() if k != drop})
    with pytest.raises(ValueError, match="SimState.quat"):
        runner_state_from_reference(dict(d, sim_1=d["sim_0"]))
    with pytest.raises(ValueError, match="more than 7"):
        runner_state_from_reference(dict(d, sim_7=d["sim_0"]))
