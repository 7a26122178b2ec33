#!/usr/bin/env python3
"""Where qtos_torch's walk of exp_4 parts from qtos_tpu's, both on the CPU.

    python tests/helpers/exp4_parting.py walk OUT_DIR      # ~15 min: both walks
    python tests/helpers/exp4_parting.py compare OUT_DIR   # reads the walks' records
    python tests/helpers/exp4_parting.py window0 OUT_DIR   # ~3 min: window 0 and chunk 0

`walk` runs `scripts/main.py --exp exp_4 --cpu` and `scripts/main_torch.py
--exp exp_4 --device cpu`, each in a process of its own with OUT_DIR/<pkg> as
its working directory (so neither touches the repository's logs/ or data/),
with the runner's `_plan_dispatch`/`_plan_finish`/`run` wrapped to record
each replan: its candidate rows, measured drift, goals, statuses, violations,
solutions, the selected stitch row and the realized CoM trace.  `compare`
prints, window by window, how far the two walks' inputs and outputs are
apart.  `window0` solves window 0 from the recorded inputs in both packages,
beside each package's own B=1 vs B=4 rounding on the same window, and plays
qtos_tpu's first 2,500 rows through both packages' physics from one start
row, tick by tick.  Imports both packages: it is a test helper, not part of
the port.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
LEAVES = dict(r=slice(0, 3), eul=slice(3, 6), v=slice(6, 9), omega=slice(9, 12), feet=slice(12, 24),
              forces_over_5=slice(24, 36))


def _np(a):
    if type(a).__module__.startswith("torch"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _record(pkg: str, out: str) -> None:
    """One walk with per-window records (runs in its own process)."""
    sys.path[:0] = [os.path.join(REPO, "scripts"), REPO]
    if pkg == "tpu":
        import main as cli

        from qtos_tpu.control import replan as R
        argv = ["--exp", "exp_4", "--cpu", "--out", "data"]
    else:
        import main_torch as cli

        from qtos_torch.control import replan as R
        argv = ["--exp", "exp_4", "--device", "cpu", "--out", "data"]
    recs = []
    Runner = R.RecedingHorizonRunner
    dispatch, finish, run = Runner._plan_dispatch, Runner._plan_finish, Runner.run

    def _dispatch(self, target, goal_r_final, x_warm=None, drift_xy=None, lo=0):
        p = dispatch(self, target, goal_r_final, x_warm=x_warm, drift_xy=drift_xy, lo=lo)
        recs.append(dict(
            target=target, ats=np.asarray(p["ats"]),
            drift=None if drift_xy is None else tuple(np.asarray(v, np.float64) for v in drift_xy),
            rows=_np(p["rows"]), goals=_np(p["goals"]), gyaws=_np(p["gyaws"]), drift3=_np(p["drift3"]),
            dyaw=_np(p["dyaw"]), status=_np(p["res"].status), viol=_np(p["res"].max_violation),
            x=_np(p["res"].x)))
        return p

    def _finish(self, p):
        r = finish(self, p)
        recs[-1].update(at=r[0], failed=r[7], table_last=_np(r[1])[-1])
        return r

    def _run(self, *a, **k):
        rep = run(self, *a, **k)
        recs.append(dict(report=dict(sim_pos=np.asarray(rep.sim_pos_series), final_pos=np.asarray(rep.final_pos),
                                     windows=rep.windows, ticks=rep.sim_ticks, holds=rep.stance_holds,
                                     err=rep.avg_com_err_per_s)))
        return rep

    Runner._plan_dispatch, Runner._plan_finish, Runner.run = _dispatch, _finish, _run
    try:
        cli.main(argv)
    finally:
        with open(out, "wb") as f:
            pickle.dump(recs, f)


def walk(out_dir: str) -> None:
    procs = []
    for pkg in ("tpu", "torch"):
        cwd = os.path.join(out_dir, pkg)
        os.makedirs(cwd, exist_ok=True)
        log = open(os.path.join(out_dir, f"{pkg}.log"), "w")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "_record", pkg,
                                       os.path.join(os.path.abspath(out_dir), f"{pkg}.pkl")],
                                      cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT))
    for p in procs:
        p.wait()


def _load(out_dir, pkg):
    with open(os.path.join(out_dir, f"{pkg}.pkl"), "rb") as f:
        recs = pickle.load(f)
    return [r for r in recs if "report" not in r], next(r["report"] for r in recs if "report" in r)


def compare(out_dir: str) -> None:
    (wa, ra), (wb, rb) = _load(out_dir, "tpu"), _load(out_dir, "torch")
    for name, r in (("qtos_tpu", ra), ("qtos_torch", rb)):
        print(f"{name}: {r['windows']} windows, {r['ticks']} ticks, {r['holds']} holds, "
              f"avg_com_err_per_s {r['err']:.2f}, final {np.round(r['final_pos'], 4).tolist()}")
    # record 0 is the runner's first plan (before any tick); record i >= 1 is
    # the replan dispatched at the start of the runner's window i - 1
    for i, (a, b) in enumerate(zip(wa, wb)):
        line = [f"record {i} (target {a['target']} / {b['target']})"]
        if a["drift"] is not None and b["drift"] is not None:
            line.append(f"measured drift apart {np.abs(a['drift'][0] - b['drift'][0]).max():.3e} m, "
                        f"yaw {abs(a['drift'][2] - b['drift'][2]):.3e} rad")
        line.append(f"rows' CoM apart {np.abs(a['rows'][:, 1:4] - b['rows'][:, 1:4]).max():.3e}")
        line.append(f"goals apart {np.abs(a['goals'] - b['goals']).max():.3e}")
        line.append(f"statuses {a['status'].tolist()} / {b['status'].tolist()}")
        line.append(f"solutions apart {np.abs(a['x'] - b['x']).max():.3e}")
        line.append(f"stitch {a['at']} / {b['at']}, failed {a['failed']} / {b['failed']}")
        print("; ".join(line))
    T = min(len(ra["sim_pos"]), len(rb["sim_pos"]))
    d = np.abs(ra["sim_pos"][:T] - rb["sim_pos"][:T]).max(-1)
    print("realized CoM apart, first tick beyond " + ", ".join(
        f"{th:g} m: {int(np.argmax(d > th)) if (d > th).any() else None}" for th in (1e-4, 1e-3, 1e-2)))
    print("realized CoM apart at ticks " + ", ".join(f"{t}: {d[t]:.3e}" for t in (2499, 4991, 7482) if t < T))


def window0(out_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    import torch

    sys.path[:0] = [REPO]
    from qtos_tpu.config import get_experiment as j_get_experiment
    from qtos_tpu.control import replan as JR
    from qtos_tpu.control.loop import control_profile as j_control_profile
    from qtos_tpu.control.loop import gait_control_params as j_gait_control_params
    from qtos_tpu.control.loop import playback as j_playback
    from qtos_tpu.control.loop import stance_warmup as j_stance_warmup
    from qtos_tpu.control.loop import state_from_row as j_state_from_row
    from qtos_tpu.terrain import make_terrain as j_make_terrain

    from qtos_torch.builder import preset_runner_config
    from qtos_torch.config import get_experiment
    from qtos_torch.control import replan as PR
    from qtos_torch.control.loop import playback, stance_warmup, state_from_row
    from qtos_torch.terrain import make_terrain

    exp = j_get_experiment("exp_4")
    jterr = j_make_terrain(list(exp.maps), scale_factor=exp.mesh_scale, randomize=exp.random_env,
                           rng=np.random.default_rng(0))
    # the runner config as scripts/main.py builds it for exp_4
    jcfg = JR.RunnerConfig(avg_speed=exp.avg_speed, gait=exp.gait)
    if exp.swing_clearance > jcfg.solver.swing_clearance:
        jcfg.rough_clearance = exp.swing_clearance
    jcfg.rough_pace = exp.rough_pace
    if exp.control_profile:
        jcfg.control = j_control_profile(exp.control_profile)
    if exp.friction != 1.0:
        base = jcfg.control if jcfg.control is not None else j_gait_control_params(exp.gait)
        jcfg.control = base.replace(sim=base.sim.replace(friction=exp.friction))
    jr = JR.RecedingHorizonRunner(jterr, exp.goal_xy, cfg=jcfg)
    pexp = get_experiment("exp_4")
    pterr = make_terrain(list(pexp.maps), scale_factor=pexp.mesh_scale, randomize=pexp.random_env,
                         rng=np.random.default_rng(0), device="cpu")
    pcfg = preset_runner_config(pexp)
    pr = PR.RecedingHorizonRunner(pterr, pexp.goal_xy, cfg=pcfg, device=torch.device("cpu"))
    print(f"terrains equal: {np.array_equal(np.asarray(jterr.height), pterr.height.numpy())}")

    (wa, _), (wb, _) = _load(out_dir, "tpu"), _load(out_dir, "torch")
    rec = wa[0]
    for k in ("rows", "goals", "gyaws", "drift3", "dyaw"):
        assert np.array_equal(rec[k], wb[0][k]), f"window 0's {k} differ"

    def leafdiff(a, b):
        return ", ".join(f"{k} {np.abs(a[..., s] - b[..., s]).max():.2e}" for k, s in LEAVES.items())

    def j_solve(idx):
        res, tabs, _ = JR.plan_windows_batch(
            jnp.asarray(rec["rows"][idx]), jnp.asarray(rec["goals"][idx]), jnp.asarray(rec["gyaws"][idx]),
            jterr, jcfg, t0s=jnp.asarray(rec["rows"][idx, 0]), drift3=jnp.asarray(rec["drift3"]),
            dyaw=jnp.asarray(rec["dyaw"]))
        return np.asarray(res.x), np.asarray(tabs)

    def p_solve(idx):
        t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
        res, tabs, _ = PR.plan_windows_batch(
            t(rec["rows"][idx]), t(rec["goals"][idx]), t(rec["gyaws"][idx]), pterr, pcfg,
            t0s=t(rec["rows"][idx, 0]), drift3=t(rec["drift3"]), dyaw=t(rec["dyaw"]))
        return res.x.numpy(), tabs.numpy()

    every = np.arange(len(rec["rows"]))
    jx, jt = j_solve(every)
    px, pt = p_solve(every)
    print(f"window 0 re-solved equals the walks' records: qtos_tpu {np.array_equal(jx, rec['x'])}, "
          f"qtos_torch {np.array_equal(px, wb[0]['x'])}")
    print(f"window 0, port vs qtos_tpu at B={len(every)}: {leafdiff(px, jx)}")
    print(f"  tables apart: CoM {np.abs(pt[..., 1:4] - jt[..., 1:4]).max():.2e} m, feet "
          f"{np.abs(pt[..., 7:19] - jt[..., 7:19]).max():.2e} m, forces {np.abs(pt[..., 25:37] - jt[..., 25:37]).max():.2e} N")
    px1 = np.concatenate([p_solve(np.array([i]))[0] for i in every])
    jx1 = np.concatenate([j_solve(np.array([i]))[0] for i in every])
    print(f"  the port's own B=1 vs B={len(every)}: {leafdiff(px1, px)}")
    print(f"  qtos_tpu's own B=1 vs B={len(every)}: {leafdiff(jx1, jx)}")

    # chunk 0 through both physics: qtos_tpu's first 2,500 rows, one start row
    sel = int(np.flatnonzero(rec["status"] == 0)[0])        # the runner takes the first converged
    assert rec["ats"][sel] == rec["at"]
    table = jt[sel][:2500]
    js = j_stance_warmup(j_state_from_row(jnp.asarray(table[0]), jterr, jr.control), jterr, jr.control,
                         jcfg.stance_warmup_steps)
    ps = stance_warmup(state_from_row(torch.as_tensor(table[0]), pterr, pr.control), pterr, pr.control,
                       pcfg.stance_warmup_steps)
    print("chunk 0 from one table: warm-up state apart " + ", ".join(
        f"{k} {np.abs(np.asarray(getattr(js, k)) - getattr(ps, k).numpy()).max():.2e}"
        for k in ("pos", "quat", "v", "w", "q", "qd")))
    _, jm = j_playback(jnp.asarray(table), js, jterr, jr.control)
    _, pm = playback(torch.as_tensor(table), ps, pterr, pr.control)
    d = np.abs(np.asarray(jm.pos) - pm.pos.numpy()).max(-1)
    print("  CoM apart, first tick beyond " + ", ".join(
        f"{th:g} m: {int(np.argmax(d > th)) if (d > th).any() else None}" for th in (1e-6, 1e-5, 1e-4, 1e-3)))
    print(f"  at tick 2499: CoM {d[2499]:.3e} m, feet {np.abs(np.asarray(jm.feet)[2499] - pm.feet.numpy()[2499]).max():.3e} m, "
          f"yaw {abs(float(np.asarray(jm.yaw)[2499]) - float(pm.yaw[2499])):.3e} rad")


if __name__ == "__main__":
    cmd, arg = sys.argv[1], sys.argv[2]
    if cmd == "_record":
        _record(arg, sys.argv[3])
    else:
        dict(walk=walk, compare=compare, window0=window0)[cmd](arg)
