"""qtos_torch receding-horizon runner against qtos_tpu on identical inputs (CPU).

Small size: 2 candidates, `max_iters` 20, 100 warm-up steps.  The pieces
(spec building, stance tables, one replan, the failure policy) use K=13 knots
and 1.5 s windows.  The whole runs use the full-size window (K=41, 2.5 s)
with `f_steps` 1250, `lookahead` 1875 and a 0.6 m goal: with 1.5 s windows
(K=13 or K=25) both packages bounce by 5 cm in z, take the same decisions,
and still end 3 cm and 20 % of `avg_com_err_per_s` apart, because 1 kHz
contact dynamics amplify rounding; at the full-size window they agree to a
millimetre.

Tolerances.  Spec building, stance tables and the buffer bookkeeping are
copies and a few float32 operations: 1e-6 or exact.  One replan: statuses
equal and the solution within 5e-3, the solve tolerance of
`test_torch_solve.py`; that tolerance is on the solver's variables, which
hold forces divided by FORCE_SCALE, so the table's force columns (in N) get
5e-3 * FORCE_SCALE.  A whole run is compared by its report: same outcome,
same windows, ticks and statuses, final position within 3 cm,
`avg_com_err_per_s` within 10 % (measured: 0.6 mm and 0.05 %).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.control import replan as j_replan
from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver.spec import RobotState as JRobotState
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.control import replan as t_replan
from qtos_torch.control.loop import playback
from qtos_torch.convert import terrain_from_reference, to_numpy
from qtos_torch.models.solo12 import Solo12
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory
from qtos_torch.solver.spec import FORCE_SCALE, NV, index_spec
from qtos_torch.terrain import make_terrain

ATOL = 1e-6
ATOL_PLAN = 5e-3
SMALL = dict(K=13, window_duration=1.5, f_steps=600, lookahead=900, n_candidates=2,
             stance_warmup_steps=100, max_windows=8)
WALK = dict(SMALL, K=41, window_duration=2.5, f_steps=1250, lookahead=1875, buffer_rows=8000)
GOAL = (0.6, 0.0)


def _cfgs(**kw):
    base = dict(SMALL)
    base.update(kw)
    return (j_replan.RunnerConfig(solver=JConfig(max_iters=20, tol=3e-3), **base),
            t_replan.RunnerConfig(solver=SolverConfig(max_iters=20, tol=3e-3), **base))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _standing_rows(jterr, xs):
    rows = []
    for x in xs:
        s = JRobotState.standing((float(x), 0.0), yaw=0.0, terrain=jterr)
        rows.append(np.concatenate([np.zeros(1), s.r, s.eul, np.asarray(s.feet).reshape(12),
                                    s.v, s.omega, np.zeros(12)]).astype(np.float32))
    return np.stack(rows)


# -- pieces --------------------------------------------------------------

def test_spec_from_row_matches():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((3, 37)).astype(np.float32)
    goals = rng.standard_normal((3, 3)).astype(np.float32)
    yaws = rng.standard_normal(3).astype(np.float32)
    K, dur = 13, 1.5
    js = jax.vmap(lambda r, g, y: j_replan.spec_from_row(r, g, y, None, K, dur))(
        jnp.asarray(rows), jnp.asarray(goals), jnp.asarray(yaws))
    ts = to_numpy(t_replan.spec_from_row(_t(rows), _t(goals), _t(yaws), None, K, dur))
    one = to_numpy(t_replan.spec_from_row(_t(rows[1]), _t(goals[1]), _t(yaws[1]), None, K, dur))
    assert ts.dt == one.dt == float(js.dt)
    for name in ("r", "eul", "v", "omega", "feet"):
        np.testing.assert_allclose(getattr(ts.start, name), np.asarray(getattr(js.start, name)), atol=ATOL)
        np.testing.assert_array_equal(getattr(one.start, name), getattr(ts.start, name)[1])
    for name in ("goal_r", "goal_yaw", "duration"):
        np.testing.assert_allclose(getattr(ts, name), np.asarray(getattr(js, name)), atol=ATOL)
    np.testing.assert_array_equal(ts.schedule.contact, np.asarray(js.schedule.contact))
    np.testing.assert_allclose(ts.schedule.swing_progress, np.asarray(js.schedule.swing_progress), atol=ATOL)
    assert one.schedule.contact.shape == (K, 4) and one.duration.shape == ()


def test_stance_table_matches():
    row = np.random.default_rng(1).standard_normal(37).astype(np.float32)
    jt, jc = j_replan.stance_table(jnp.asarray(row), 1501, 2.75)
    tt, tc = t_replan.stance_table(_t(row), 1501, 2.75)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_batched_sampler_is_the_single_one():
    """`sample_trajectory` over a leading axis with one t0 per scenario gives
    what one call per scenario gives."""
    rng = np.random.default_rng(2)
    K, B = 13, 3
    terr = make_terrain(["plane"], device="cpu")
    specs = default_spec(terr, goal_xy=(np.linspace(0.2, 0.4, B).astype(np.float32), 0.0),
                         duration=1.5, K=K, device="cpu")
    x = _t(0.1 * rng.standard_normal((B, K, NV)))
    t0s = _t([0.0, 1.25, 7.5])
    tables, contacts = sample_trajectory(x, specs, t0=t0s)
    assert tables.shape == (B, 1501, 37) and contacts.shape == (B, 1501, 4)
    for i in range(B):
        table, contact = sample_trajectory(x[i], index_spec(specs, i), t0=float(t0s[i]))
        np.testing.assert_allclose(tables[i].numpy(), table.numpy(), atol=ATOL)
        np.testing.assert_array_equal(contacts[i].numpy(), contact.numpy())


def test_plan_windows_batch_matches():
    """One replan on stepped terrain with a drift shift and a yaw residual."""
    jterr = j_make_terrain(["step", "plane"])
    terr = terrain_from_reference(jterr, device="cpu")
    jcfg, tcfg = _cfgs()
    rows = _standing_rows(jterr, [0.1, 0.3])
    rows[:, 19] = 0.05                                   # a forward velocity to rotate
    goals = rows[:, 1:4] + np.array([[0.3, 0.02, 0.0], [0.25, -0.02, 0.0]], np.float32)
    gyaws = np.array([0.05, -0.05], np.float32)
    t0s = np.array([1.25, 1.5], np.float32)
    drift3 = np.array([0.03, -0.02, 0.0], np.float32)
    dyaw = np.float32(0.08)
    jres, jtab, jcon = j_replan.plan_windows_batch(
        jnp.asarray(rows), jnp.asarray(goals), jnp.asarray(gyaws), jterr, jcfg,
        t0s=jnp.asarray(t0s), drift3=jnp.asarray(drift3), dyaw=jnp.asarray(dyaw))
    rows_t = _t(rows)
    keep = rows_t.clone()
    tres, ttab, tcon = t_replan.plan_windows_batch(
        rows_t, _t(goals), _t(gyaws), terr, tcfg, t0s=_t(t0s), drift3=_t(drift3), dyaw=_t(dyaw))
    assert torch.equal(rows_t, keep)                     # the core never writes to its rows
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=ATOL_PLAN)
    np.testing.assert_allclose(ttab[..., :25].numpy(), np.asarray(jtab)[..., :25], atol=ATOL_PLAN)
    np.testing.assert_allclose(ttab[..., 25:].numpy(), np.asarray(jtab)[..., 25:], atol=ATOL_PLAN * FORCE_SCALE)
    np.testing.assert_array_equal(tcon.numpy(), np.asarray(jcon))
    np.testing.assert_allclose(tres.max_violation.numpy(), np.asarray(jres.max_violation), atol=ATOL_PLAN)
    # the shifted, rotated and re-seated start state is what the table begins with
    np.testing.assert_allclose(ttab[:, 0, 1:3].numpy(), rows[:, 1:3] + drift3[:2], atol=1e-4)
    np.testing.assert_allclose(ttab[:, 0, 6].numpy(), rows[:, 6] + dyaw, atol=1e-4)
    # defaults: no t0s, no drift
    tres0, ttab0, _ = t_replan.plan_windows_batch(rows_t, _t(goals), _t(gyaws), terr, tcfg)
    np.testing.assert_allclose(ttab0[:, 0, 0].numpy(), 0.0, atol=ATOL)
    np.testing.assert_allclose(ttab0[:, 0, 1:4].numpy(), rows[:, 1:4], atol=1e-4)


# -- the runner's bookkeeping on seeded buffers ----------------------------

@pytest.fixture(scope="module")
def runners():
    """A runner of each package on flat ground with the same seeded segments
    stitched in: 3 segments of 1,501 rows, each overwriting the tail of the
    one before, contacts all-four about one row in three."""
    jterr = j_make_terrain(["plane", "plane"])
    terr = terrain_from_reference(jterr, device="cpu")
    jcfg, tcfg = _cfgs(buffer_rows=6000)
    jr = j_replan.RecedingHorizonRunner(jterr, (0.5, 0.0), cfg=jcfg)
    tr = t_replan.RecedingHorizonRunner(terr, (0.5, 0.0), cfg=tcfg, device="cpu")
    rng = np.random.default_rng(3)
    at = 0
    for i in range(3):
        table = rng.standard_normal((1501, 37)).astype(np.float32)
        table[:, 0] = (at + np.arange(1501)) / 1000.0
        contact = np.where(rng.random((1501, 1)) < 0.33, 1.0,
                           (rng.random((1501, 4)) < 0.5).astype(np.float32)).astype(np.float32)
        shift = None if i == 0 else rng.standard_normal(2).astype(np.float32)
        jr._stitch(at, jnp.asarray(table), jnp.asarray(contact), shift_xy=shift)
        tr._stitch(at, _t(table), _t(contact), shift_xy=shift)
        at += 1100
    return jr, tr


def _same_buffers(jr, tr):
    assert tr.buffer_end == jr.buffer_end
    np.testing.assert_array_equal(tr.buffer.numpy(), np.asarray(jr.buffer))
    np.testing.assert_array_equal(tr.contact_buf.numpy(), np.asarray(jr.contact_buf))
    np.testing.assert_array_equal(tr._row_shift, jr._row_shift)
    end = tr.buffer_end
    np.testing.assert_array_equal(tr.host_buf.read(0, end), jr.host_buf.read(0, end))
    np.testing.assert_array_equal(tr.host_buf.read(0, end), tr.buffer[:end].numpy())


def test_stitch_matches(runners):
    jr, tr = runners
    assert tr.buffer_end == 2 * 1100 + 1501
    _same_buffers(jr, tr)


def test_find_stitch_row_and_candidates_match(runners):
    jr, tr = runners
    for target in (0, 1, 777, 1499, 2200, 3600, 3700, 3701, 9999):
        assert tr._find_stitch_row(target) == jr._find_stitch_row(target)
    for target, lo in ((0, 0), (900, 0), (2000, 2500), (3500, 0), (3690, 0), (5000, 100)):
        assert tr._candidate_rows(target, lo=lo) == jr._candidate_rows(target, lo=lo)


def test_select_matches(runners):
    jr, tr = runners
    cases = [([1, 0, 0], [0.5, 0.1, 0.2]), ([1, 1], [0.02, 0.01]), ([1, 1], [0.2, 0.04]),
             ([0, 1], [1e-3, 1e-4]), ([1, 1], [0.03, 0.2])]
    for status, viol in cases:
        status, viol = np.array(status, np.int32), np.array(viol, np.float32)
        assert tr._select(status, viol) == jr._select(status, viol)
    assert tr._select(np.array([1, 1]), np.array([0.2, 0.04])) is None
    assert tr._select(np.array([1, 1]), np.array([0.02, 0.01])) == 1


def test_shift_warm_start_matches():
    rng = np.random.default_rng(4)
    K = 13
    rows = rng.standard_normal((2, 37)).astype(np.float32)
    goal, yaw = np.zeros(3, np.float32), np.float32(0.0)
    x_prev = rng.standard_normal((K, NV)).astype(np.float32)
    jx = jax.vmap(lambda r: j_replan.RecedingHorizonRunner._shift_warm_start(
        jnp.asarray(x_prev), j_replan.spec_from_row(r, goal, yaw, None, K, 1.5)))(jnp.asarray(rows))
    shift = t_replan.RecedingHorizonRunner._shift_warm_start
    tx = shift(_t(x_prev), t_replan.spec_from_row(
        _t(rows), _t(goal).expand(2, 3), _t(yaw).expand(2), None, K, 1.5))
    assert tx.shape == (2, K, NV)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    one = shift(_t(x_prev), t_replan.spec_from_row(_t(rows[1]), _t(goal), _t(yaw), None, K, 1.5))
    np.testing.assert_array_equal(one.numpy(), tx[1].numpy())


def test_maybe_compact_matches(runners):
    """Last of the seeded-buffer tests: it shifts both runners' buffers."""
    jr, tr = runners
    for r in (jr, tr):
        r._st = dict(exec_idx=1200)
        r._maybe_compact()
    assert tr._st["exec_idx"] == jr._st["exec_idx"] == 1
    assert tr.buffer_end == 3701 - 1199
    assert len(tr._archive) == len(jr._archive) == 1
    np.testing.assert_array_equal(tr._archive[0], jr._archive[0])
    _same_buffers(jr, tr)
    for r in (jr, tr):                                  # far from capacity now: nothing moves
        r._st = dict(exec_idx=500)
        r._maybe_compact()
    assert tr._st["exec_idx"] == 500 and len(tr._archive) == 1
    _same_buffers(jr, tr)


def test_runners_share_no_storage():
    terr = make_terrain(["plane", "plane"], device="cpu")
    _, tcfg = _cfgs(buffer_rows=4000)
    a = t_replan.RecedingHorizonRunner(terr, (0.5, 0.0), cfg=tcfg, device="cpu")
    b = t_replan.RecedingHorizonRunner(terr, (0.5, 0.0), cfg=tcfg, device="cpu")
    table = torch.ones((1501, 37))
    a._stitch(0, table, torch.ones((1501, 4)))
    a._st = dict(sim=None, exec_idx=3, window=1, planning_done=False, prev_x=torch.zeros(13, NV),
                 com_errs=[], solve_times=[0.1], statuses=[0])
    a._st["sim"] = t_replan.state_from_row(
        _t(_standing_rows(j_make_terrain(["plane"]), [0.0])[0]), terr, a.control)
    snap = a.state_dict()
    b.load_state_dict(snap)
    a.buffer[5] = 7.0
    a._row_shift[5] = 7.0
    table[6] = 9.0
    assert snap["buffer"][5, 0] == 1.0 and snap["row_shift"][5, 0] == 0.0      # a snapshot is a copy
    assert float(b.buffer[5, 0]) == 1.0 and float(a.buffer[6, 0]) == 1.0
    snap["buffer"][8] = 3.0
    snap["sim_0"][:] = 3.0
    assert float(b.buffer[8, 0]) == 1.0 and not bool((b._st["sim"].pos == 3.0).any())
    assert b.buffer_end == 1501 and b._st["exec_idx"] == 3
    with pytest.raises(ValueError, match="lives on"):
        t_replan.RecedingHorizonRunner(terr, (0.5, 0.0), cfg=tcfg, device="meta")


# -- failure policy and the execution chunk (the port alone) ------------------

def test_failure_policy_stance_hold_then_abort(tmp_path, monkeypatch):
    """Every replan after the first solve is forced unusable: the runner
    escalates, stitches a stance hold, and the watchdog aborts after
    `max_consec_failures` windows.  Runs inside tmp_path: the forensics dump
    goes to ./logs/failed_window.npz when ./logs exists."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "logs").mkdir()
    terr = make_terrain(["plane", "plane"], device="cpu")
    _, cfg = _cfgs(f_steps=300, lookahead=450, stance_warmup_steps=50,
                   max_consec_failures=2, escalate_iters=2)
    r = t_replan.RecedingHorizonRunner(terr, (0.5, 0.0), cfg=cfg, device="cpu")
    calls = {"n": 0}

    def select(status, viol):
        calls["n"] += 1
        return 0 if calls["n"] == 1 else None            # the initial solve passes
    r._select = select
    rep = r.run(verbose=False)
    assert rep.aborted and not rep.reached_goal
    assert rep.stance_holds == 2 and rep.windows == 3 and r.escalations == 2
    assert calls["n"] == 1 + 2 * 2                       # each failed replan selects twice
    dump = np.load(tmp_path / "logs" / "failed_window.npz")
    assert dump["rows"].shape == (2, 37) and dump["status"].shape == (2,) and "viol_dynamics" in dump.files
    # the last stitched segment is a stance hold at the earliest candidate row
    end = r.buffer_end
    hold = r.host_buf.read(end - r.seg_rows, r.seg_rows)
    assert hold.shape == (r.seg_rows, 37)
    np.testing.assert_array_equal(hold[:, 19:25], 0.0)
    np.testing.assert_array_equal(hold[:, 1:19], np.broadcast_to(hold[0, 1:19], (r.seg_rows, 18)))
    np.testing.assert_allclose(hold[:, 27::3], Solo12.mass * 9.81 / 4.0, rtol=1e-6)
    np.testing.assert_allclose(np.diff(hold[:, 0]), 1e-3, atol=1e-5)
    np.testing.assert_array_equal(r.contact_buf[end - r.seg_rows:end].numpy(), 1.0)
    # without a ./logs directory the dump is skipped and the fallback still comes
    (tmp_path / "empty").mkdir()
    monkeypatch.chdir(tmp_path / "empty")
    out = r._plan(r._st["exec_idx"] + 450, rep.goal)
    assert out[-1] is True and out[5] is None and list((tmp_path / "empty").iterdir()) == []


# -- whole runs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same short walk in both packages (flat ground, goal 0.6 m, full-size
    windows).  A buffer of 8,000 rows makes both compact it on the way; the
    port's execution chunks are recorded."""
    cwd = tmp_path_factory.mktemp("runs")
    old = os.getcwd()
    os.chdir(cwd)                                        # a failed window would write ./logs here
    try:
        jterr = j_make_terrain(["plane", "plane"])
        jcfg, tcfg = _cfgs(**WALK)
        jr = j_replan.RecedingHorizonRunner(jterr, GOAL, cfg=jcfg)
        jrep = jr.run(verbose=False)
        tr = t_replan.RecedingHorizonRunner(terrain_from_reference(jterr, device="cpu"), GOAL,
                                            cfg=tcfg, device="cpu")
        chunks, inner = [], tr._exec_chunk

        def exec_chunk(start, n_exec, s0):
            chunks.append((start, n_exec, tr.buffer_end, tr.buffer[start:start + n_exec].clone()))
            return inner(start, n_exec, s0)
        tr._exec_chunk = exec_chunk
        trep = tr.run(verbose=False)
    finally:
        os.chdir(old)
    return jrep, trep, jr, tr, chunks


def test_short_run_matches_by_its_report(runs):
    jrep, trep, jr, tr, _ = runs
    assert jrep.reached_goal and trep.reached_goal
    assert not trep.aborted and trep.stance_holds == jrep.stance_holds == 0
    assert trep.windows == jrep.windows >= 2
    assert trep.statuses == jrep.statuses == [0] * trep.windows
    assert trep.sim_ticks == jrep.sim_ticks
    assert np.linalg.norm(trep.final_pos - jrep.final_pos) < 0.03
    assert trep.avg_com_err_per_s < 120.0
    assert abs(trep.avg_com_err_per_s / jrep.avg_com_err_per_s - 1.0) < 0.10
    np.testing.assert_allclose(trep.goal, jrep.goal, atol=ATOL)
    assert trep.ref_table.shape == jrep.ref_table.shape == (trep.sim_ticks, 37)
    assert len(trep.com_err_series) == trep.sim_ticks and trep.sim_feet_series.shape == (trep.sim_ticks, 4, 3)
    assert len(trep.solve_wall_times) == trep.windows and tr.escalations == 0
    assert len(tr._archive) == len(jr._archive) >= 1     # both compacted their buffers
    # the first window is planned from the same standing start: the same plan
    np.testing.assert_allclose(trep.ref_table[:1250, :25], jrep.ref_table[:1250, :25], atol=ATOL_PLAN)
    assert tr.plan_history.size() == trep.windows - 1 and tr.solve_ms_window.average() > 0.0


def test_execution_never_reaches_unstitched_rows(runs):
    """Every chunk the run executed is exactly rows [start, start + n) below
    `buffer_end`, none of the zeros behind it; and a chunk at the very end of
    a small buffer, where a fixed `f_steps` slice would leave the buffer, is
    played row for row."""
    _, trep, _, tr, chunks = runs
    assert sum(n for _, n, _, _ in chunks) == trep.sim_ticks
    assert np.all(np.diff(trep.ref_table[:, 0]) >= 0.0)  # path time is monotone across the seams
    for start, n, end, rows in chunks:
        assert 0 < n <= tr.cfg.f_steps and start + n <= end
        assert rows.shape == (n, 37) and bool((rows[:, 3] > 0.1).all())       # planned CoM heights, not zeros
    done = np.concatenate([rows.numpy() for _, _, _, rows in chunks])
    np.testing.assert_array_equal(done[:, 0], trep.ref_table[:, 0])

    _, cfg = _cfgs(**dict(WALK, buffer_rows=2600))
    small = t_replan.RecedingHorizonRunner(tr.terrain, GOAL, cfg=cfg, device="cpu")
    table = _t(trep.ref_table[:2501])
    small._stitch(0, table, torch.ones((2501, 4)))
    s0 = t_replan.state_from_row(table[2200], small.terrain, small.control)
    assert 2200 + cfg.f_steps > cfg.buffer_rows          # the fixed slice would not fit
    final, m = small._exec_chunk(2200, 301, s0)
    ref_final, ref_m = playback(table[2200:2501], s0, small.terrain, small.control)
    assert m.com_err.shape == (301,) and torch.equal(m.com_err, ref_m.com_err)
    assert torch.equal(final.pos, ref_final.pos) and torch.equal(final.q, ref_final.q)
    for start, n in ((2200, 302), (2501, 1), (-1, 5), (10, 0)):
        with pytest.raises(ValueError, match="leaves the stitched rows"):
            small._exec_chunk(start, n, s0)
