"""qtos_torch control loop against qtos_tpu on identical inputs (CPU).

The tables are solved and sampled by `qtos_tpu` (K=13 windows of 1.5 s on
flat ground, the tiny-problem shape, and one K=33 window of 2.5 s) and handed
to both packages as numpy arrays.

Tolerances.  One tick: atol=1e-5 on positions, angles, filters and errors.
Torques and joint velocities get their own: the desired joint velocity is a
difference of two IK results over dt = 1e-3, so a 2e-7 rad rounding
difference in IK is 2e-4 rad/s and, through kd = 1.2, 2.4e-4 N m of torque;
one step of joint dynamics (1 / 0.012 * dt) makes that 2e-5 rad/s.  Short
playbacks (300 ticks): atol=2e-3 on `pos` and `feet`.  A whole episode
(2,501 ticks through stiff penalty contact) is compared by its metrics only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.control import ControlParams as JControlParams
from qtos_tpu.control import playback as j_playback
from qtos_tpu.control import stance_warmup as j_stance_warmup
from qtos_tpu.control.loop import _tick as j_tick
from qtos_tpu.control.loop import control_profile as j_control_profile
from qtos_tpu.control.loop import gait_control_params as j_gait_control_params
from qtos_tpu.control.loop import plan_joint_targets as j_plan_joint_targets
from qtos_tpu.control.loop import playback_recorded as j_playback_recorded
from qtos_tpu.control.loop import state_from_row as j_state_from_row
from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver import sample_trajectory as j_sample_trajectory
from qtos_tpu.solver import solve as j_solve
from qtos_tpu.solver.solve import solve_batch as j_solve_batch
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.control import ControlParams, TrackingMetrics, decode_row, playback, stance_warmup
from qtos_torch.control.loop import (
    _tick,
    control_profile,
    gait_control_params,
    plan_joint_targets,
    playback_recorded,
    record_csv,
    state_from_row,
)
from qtos_torch.convert import (
    control_params_from_reference,
    sim_state_from_reference,
    terrain_from_reference,
    to_numpy,
)

ATOL = 1e-5
ATOL_TAU = 1e-3
ATOL_QD = 1e-4
ATOL_SHORT = 2e-3
B, K, ROWS = 4, 13, 300
STATE_FIELDS = ("pos", "quat", "v", "w", "q", "qd", "anchor")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _row(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def world():
    """Four K=13 tables (first ROWS rows), warmed-up start states of both
    packages, and the two terrains."""
    jterr = j_make_terrain(["plane", "plane"])
    goals = jnp.linspace(0.15, 0.45, B)
    specs = jax.vmap(lambda g: j_default_spec(jterr, goal_xy=(g, 0.0), K=K, duration=1.5))(goals)
    res = j_solve_batch(specs, jterr, JConfig(max_iters=3))
    tables = jax.vmap(lambda x, s: j_sample_trajectory(x, s)[0])(res.x, specs)[:, :ROWS]
    jparams = JControlParams()
    js0 = jax.vmap(lambda r: j_stance_warmup(j_state_from_row(r, jterr, jparams), jterr, jparams, 100))(
        tables[:, 0])
    return dict(
        jterr=jterr, jtables=tables, js0=js0,
        terr=terrain_from_reference(_np_tree(jterr), device="cpu"),
        tables=torch.from_numpy(np.array(tables)),
        s0=sim_state_from_reference(_np_tree(js0), device="cpu"),
    )


def _assert_metrics(m: TrackingMetrics, jm, atol):
    np.testing.assert_allclose(m.pos.numpy(), np.asarray(jm.pos), atol=atol, err_msg="pos")
    np.testing.assert_allclose(m.feet.numpy(), np.asarray(jm.feet), atol=atol, err_msg="feet")
    np.testing.assert_allclose(m.com_err.numpy(), np.asarray(jm.com_err), atol=atol, err_msg="com_err")
    np.testing.assert_allclose(m.ee_err.numpy(), np.asarray(jm.ee_err), atol=atol, err_msg="ee_err")
    np.testing.assert_allclose(m.yaw.numpy(), np.asarray(jm.yaw), atol=atol, err_msg="yaw")
    # cumulative error over <= 300 ticks, x1000 / n: atol scales with it
    np.testing.assert_allclose(m.avg_com_err_per_s.numpy(), np.asarray(jm.avg_com_err_per_s),
                               atol=1000 * atol, rtol=0)
    np.testing.assert_allclose(m.cum_com_err.numpy(), np.asarray(jm.cum_com_err), atol=ROWS * atol, rtol=0)


@pytest.mark.parametrize("gait", ["trot", "walk", "pace", "bound", "stand"])
def test_gait_control_params_match(gait):
    ref = control_params_from_reference(j_gait_control_params(gait))
    out = gait_control_params(gait)
    for f in ("motor", "sim", "ee_shift", "use_force_ff", "frame", "base_corr", "max_corr", "corr_tau",
              "vel_corr", "vel_tau", "yaw_corr", "max_yaw_corr", "yaw_tau"):
        assert getattr(out, f) == getattr(ref, f), f


def test_control_profile_matches_and_rejects_unknown():
    assert control_profile("stairs") == control_params_from_reference(j_control_profile("stairs"))
    assert ControlParams() == control_params_from_reference(JControlParams())
    with pytest.raises(KeyError, match="unknown control profile"):
        control_profile("no-such-profile")


def test_decode_row_schema():
    cmd = decode_row(torch.arange(37.0))
    assert float(cmd["t"]) == 0.0
    np.testing.assert_allclose(cmd["r"].numpy(), [1, 2, 3])
    np.testing.assert_allclose(cmd["feet"].numpy()[0], [7, 8, 9])       # FL
    np.testing.assert_allclose(cmd["feet"].numpy()[3], [16, 17, 18])    # HR
    np.testing.assert_allclose(cmd["v"].numpy(), [19, 20, 21])
    np.testing.assert_allclose(cmd["f"].numpy()[0], [25, 26, 27])
    assert tuple(decode_row(torch.zeros(5, 3, 37))["feet"].shape) == (5, 3, 4, 3)


def test_plan_joint_targets_and_state_from_row_match(world):
    jparams = JControlParams(ee_shift=0.015)
    params = control_params_from_reference(jparams)
    rows, jrows = world["tables"][:, 150], world["jtables"][:, 150]
    q, _ = plan_joint_targets(rows, params)
    jq, _ = jax.vmap(lambda r: j_plan_joint_targets(r, jparams))(jrows)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=ATOL)
    table = world["tables"][0]
    q_all, _ = plan_joint_targets(table, params)                     # a whole table at once
    np.testing.assert_allclose(q_all[150].numpy(), np.asarray(jq[0]), atol=ATOL)
    s = state_from_row(rows, world["terr"], params, drop=0.02)
    js = jax.vmap(lambda r: j_state_from_row(r, world["jterr"], jparams, 0.02))(jrows)
    for k in STATE_FIELDS:
        np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(js, k)), atol=ATOL, err_msg=k)
    assert rows[0, 9] == world["tables"][0, 150, 9]                  # the table is not written to


@pytest.mark.parametrize("use_force_ff", [False, True], ids=["noff", "ff"])
@pytest.mark.parametrize("frame", ["live", "hybrid", "plan"])
def test_tick_matches(world, frame, use_force_ff):
    """One tick from a drifted, moving state with non-zero filters, so every
    correction term is live; a batch of 4 against `jax.vmap`, and episode 2
    alone against the unbatched JAX tick."""
    rng = np.random.default_rng(7)
    u = lambda scale, shape: (scale * rng.uniform(-1, 1, size=shape)).astype(np.float32)
    jparams = JControlParams(frame=frame, use_force_ff=use_force_ff, vel_corr=0.15, yaw_corr=0.3,
                             ee_shift=0.005)
    params = control_params_from_reference(jparams)
    leaves = {k: np.array(getattr(world["js0"], k)) for k in STATE_FIELDS}
    leaves["pos"] += u(0.02, (B, 3))
    leaves["v"] += u(0.1, (B, 3))
    leaves["w"] += u(0.2, (B, 3))
    leaves["qd"] += u(0.5, (B, 12))
    jrows = world["jtables"][:, 120]
    q_prev = np.asarray(jax.vmap(lambda r: j_plan_joint_targets(r, jparams)[0])(world["jtables"][:, 119]))
    filters = (u(0.01, (B, 4, 3)), u(0.05, (B, 3)), u(0.05, (B,)))
    jstate = type(world["js0"])(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jcarry = (jstate, jnp.asarray(q_prev), *(jnp.asarray(f) for f in filters))
    carry = (sim_state_from_reference(_np_tree(jstate), "cpu"), torch.from_numpy(q_prev.copy()),
             *(torch.from_numpy(f) for f in filters))

    def check(new, out, jnew, jout):
        for k in STATE_FIELDS:
            np.testing.assert_allclose(getattr(new[0], k).numpy(), np.asarray(getattr(jnew[0], k)),
                                       atol=ATOL_QD if k == "qd" else ATOL, err_msg=f"state.{k}")
        for i, name in enumerate(("q_des_plan", "corr_filt", "verr_filt", "yerr_filt"), start=1):
            np.testing.assert_allclose(new[i].numpy(), np.asarray(jnew[i]), atol=ATOL, err_msg=name)
        assert sorted(out) == sorted(jout)
        for k in jout:
            atol = {"tau": ATOL_TAU, "qd": ATOL_QD}.get(k, ATOL)
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=atol, err_msg=k)

    jnew, jout = jax.vmap(lambda c, r: j_tick(c, r, world["jterr"], jparams))(jcarry, jrows)
    new, out = _tick(carry, world["tables"][:, 120], world["terr"], params)
    check(new, out, jnew, jout)
    one = (sim_state_from_reference(_np_tree(_row(jstate, 2)), "cpu"), *(c[2] for c in carry[1:]))
    new1, out1 = _tick(one, world["tables"][2, 120], world["terr"], params)
    jnew1, jout1 = j_tick(_row(jcarry, 2), jrows[2], world["jterr"], jparams)
    check(new1, out1, jnew1, jout1)


def test_playback_matches_on_one_table(world):
    jparams = JControlParams()
    jfinal, jm = j_playback(world["jtables"][1], _row(world["js0"], 1), world["jterr"], jparams)
    s0 = sim_state_from_reference(_np_tree(_row(world["js0"], 1)), "cpu")
    final, m = playback(world["tables"][1], s0, world["terr"], ControlParams())
    assert tuple(m.pos.shape) == (ROWS, 3) and tuple(m.feet.shape) == (ROWS, 4, 3)
    _assert_metrics(m, jm, ATOL_SHORT)
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(jfinal.pos), atol=ATOL_SHORT)
    np.testing.assert_allclose(final.q.numpy(), np.asarray(jfinal.q), atol=ATOL_SHORT)
    back = to_numpy(m)
    assert isinstance(back, TrackingMetrics) and isinstance(back.pos, np.ndarray)


def test_playback_n_valid_freezes_the_state(world):
    """With n_valid=120 the final state is the state after tick 120, the
    metric counts 120 ticks, and the traces still have every row."""
    jparams = JControlParams()
    table = world["tables"][1]
    s0 = sim_state_from_reference(_np_tree(_row(world["js0"], 1)), "cpu")
    final, m = playback(table, s0, world["terr"], ControlParams(), n_valid=120)
    short_final, short_m = playback(table[:120], s0, world["terr"], ControlParams())
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(final, k).numpy(), getattr(short_final, k).numpy(), err_msg=k)
    assert tuple(m.pos.shape) == (ROWS, 3)
    np.testing.assert_array_equal(m.pos[:120].numpy(), short_m.pos.numpy())
    np.testing.assert_allclose(float(m.avg_com_err_per_s), float(short_m.avg_com_err_per_s), rtol=1e-6)
    jfinal, jm = j_playback(world["jtables"][1], _row(world["js0"], 1), world["jterr"], jparams,
                            jnp.asarray(120))
    _assert_metrics(m, jm, ATOL_SHORT)
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(jfinal.pos), atol=ATOL_SHORT)
    # a count per episode as a tensor gives the same
    final_t, m_t = playback(table, s0, world["terr"], ControlParams(), n_valid=torch.tensor(120))
    np.testing.assert_array_equal(final_t.q.numpy(), final.q.numpy())
    np.testing.assert_array_equal(m_t.avg_com_err_per_s.numpy(), m.avg_com_err_per_s.numpy())


def test_playback_batch_matches_vmap(world):
    jparams = JControlParams()
    n_valid = np.array([300, 120, 0, 299], np.int32)
    jfinal, jm = jax.vmap(lambda t, s, n: j_playback(t, s, world["jterr"], jparams, n))(
        world["jtables"], world["js0"], jnp.asarray(n_valid))
    final, m = playback(world["tables"], world["s0"], world["terr"], ControlParams(),
                        n_valid=torch.from_numpy(n_valid))
    assert tuple(m.pos.shape) == (B, ROWS, 3) and tuple(m.feet.shape) == (B, ROWS, 4, 3)
    assert tuple(m.com_err.shape) == (B, ROWS) and tuple(m.avg_com_err_per_s.shape) == (B,)
    _assert_metrics(m, jm, ATOL_SHORT)
    for k in ("pos", "q", "anchor"):
        np.testing.assert_allclose(getattr(final, k).numpy(), np.asarray(getattr(jfinal, k)),
                                   atol=ATOL_SHORT, err_msg=k)
    # episode 2 ran no tick: its state is the start state
    np.testing.assert_array_equal(final.q[2].numpy(), world["s0"].q[2].numpy())
    # without n_valid, each episode of the batch is the unbatched playback
    final_all, m_all = playback(world["tables"], world["s0"], world["terr"])
    s0 = sim_state_from_reference(_np_tree(_row(world["js0"], 3)), "cpu")
    final_3, m_3 = playback(world["tables"][3], s0, world["terr"])
    np.testing.assert_allclose(m_all.pos[3].numpy(), m_3.pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(m_all.avg_com_err_per_s[3]), float(m_3.avg_com_err_per_s), rtol=1e-3)


def test_playback_recorded_and_record_csv(world, tmp_path):
    s0 = sim_state_from_reference(_np_tree(_row(world["js0"], 0)), "cpu")
    final, m, traces = playback_recorded(world["tables"][0], s0, world["terr"], ControlParams())
    jfinal, jm, jtraces = j_playback_recorded(world["jtables"][0], _row(world["js0"], 0), world["jterr"],
                                              JControlParams())
    _assert_metrics(m, jm, ATOL_SHORT)
    assert sorted(traces) == sorted(jtraces)
    np.testing.assert_allclose(traces["q"].numpy(), np.asarray(jtraces["q"]), atol=ATOL_SHORT)
    # the same controller as playback
    _, m2 = playback(world["tables"][0], s0, world["terr"], ControlParams())
    np.testing.assert_array_equal(m.pos.numpy(), m2.pos.numpy())

    path = tmp_path / "replay.csv"
    record_csv(traces, str(path), copy_trajectory_pts=2)
    rows = np.loadtxt(path, delimiter=",", dtype=np.float32)
    assert rows.shape == (2 * ROWS, 36)
    np.testing.assert_array_equal(rows[0::2], rows[1::2])
    want = np.concatenate([traces[k].numpy() for k in ("q", "qd", "tau")], axis=-1)
    np.testing.assert_allclose(rows[0::2], want, rtol=5e-6, atol=1e-12)        # "%.6g"
    record_csv(to_numpy(traces), str(path))
    assert np.loadtxt(path, delimiter=",").shape == (ROWS, 36)


def test_whole_episode_tracks_like_the_reference():
    """The quick start: a K=33 trot window, 500 warm-up ticks, 2,501 ticks of
    playback.  Compared by metrics: `avg_com_err_per_s` within 5 %, the final
    CoM within 2 cm; and the gates `qtos_tpu`'s own test puts on the episode."""
    jterr = j_make_terrain(["plane", "plane"])
    spec = j_default_spec(jterr, goal_xy=(0.5, 0.0), K=33)
    res = j_solve(spec, jterr, JConfig(max_iters=30))
    assert int(res.status) == 0
    jtable, _ = j_sample_trajectory(res.x, spec)
    jparams = JControlParams()
    js0 = j_stance_warmup(j_state_from_row(jtable[0], jterr, jparams), jterr, jparams, 500)
    jfinal, jm = j_playback(jtable, js0, jterr, jparams)

    terr = terrain_from_reference(_np_tree(jterr), device="cpu")
    table = torch.from_numpy(np.array(jtable))
    params = ControlParams()
    s0 = stance_warmup(state_from_row(table[0], terr, params), terr, params, 500)
    np.testing.assert_allclose(s0.pos.numpy(), np.asarray(js0.pos), atol=1e-3)
    final, m = playback(table, s0, terr, params)

    assert tuple(m.pos.shape) == (2501, 3)
    ref = float(jm.avg_com_err_per_s)
    assert abs(float(m.avg_com_err_per_s) - ref) < 0.05 * ref
    assert float(np.linalg.norm(final.pos.numpy() - np.asarray(jfinal.pos))) < 0.02
    plan_end = table[-1, 1:4].numpy()
    assert float(m.avg_com_err_per_s) < 60.0
    assert abs(float(final.pos[0]) - plan_end[0]) < 0.12
    assert abs(float(final.pos[2]) - plan_end[2]) < 0.03
