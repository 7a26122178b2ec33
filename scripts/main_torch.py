#!/usr/bin/env python3
"""qtos_torch experiment script: the counterpart of `scripts/main.py` for the
PyTorch/CUDA port.

    python scripts/main_torch.py --exp exp_1              # continuous replanning run
    python scripts/main_torch.py --exp exp_1 --oneshot    # single whole-path solve (ref -t)
    python scripts/main_torch.py --test                   # canned smoke replay (ref -T)
    python scripts/main_torch.py --exp exp_1 -g 2.0 0.5   # override goal
    python scripts/main_torch.py --test --device cpu      # off the card

It runs on CUDA unless `--device` says otherwise.  Summaries go to
`logs/torch/`, artifacts (global_plan.png, trajectory CSV, tracking plots) to
`data/torch/` unless `--out` names another directory: the files that
`scripts/main.py` writes under `logs/` and `data/` are never touched.  Every
summary names the device its times were taken on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

LOG_DIR = os.path.join("logs", "torch")


def build_parser():
    p = argparse.ArgumentParser(description="qtos_torch experiment script")
    p.add_argument("--exp", "-exp", default="exp_1", help="experiment preset (exp_1..exp_10)")
    p.add_argument("-g", "--goal", nargs="+", type=float, default=None, help="goal x y [z]")
    p.add_argument("--oneshot", "-t", action="store_true", help="single whole-path solve, no replanning")
    p.add_argument("--test", "-T", action="store_true", help="headless smoke test on canned trajectory")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--record", "-r", action="store_true",
                   help="after the run, record a realized joint trajectory CSV for hardware replay "
                        "(scripts/record_torch.py's path)")
    p.add_argument("--out", default=os.path.join("data", "torch"), help="artifact output dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", nargs="?", const=os.path.join(LOG_DIR, "trace"), default=None,
                   metavar="DIR", help="capture a torch.profiler trace of the run")
    p.add_argument("--visual", action="store_true",
                   help="render 3-D plan-preview artifacts (reference visual.py)")
    p.add_argument("--realtime", action="store_true",
                   help="pace execution at 1 kHz wall clock while replans land "
                        "(reference scripts/run.py:166-169); the summary then "
                        "reports buffer underruns")
    return p


def device_info(dev) -> dict:
    """What the times of this run were taken on: the device's name and, for
    a card, its power limit as nvidia-smi reports it."""
    import torch

    from qtos_torch.tools.kit import card

    if dev.type != "cuda":
        return {"device": str(dev), "device_name": "cpu", "power_limit": None}
    try:
        limit = card(("power.limit",), index=dev.index or 0)
    except RuntimeError:
        limit = None
    return {"device": str(dev), "device_name": torch.cuda.get_device_name(dev), "power_limit": limit}


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from qtos_torch.builder import preset_runner_config
    from qtos_torch.config import get_experiment
    from qtos_torch.control.replan import RecedingHorizonRunner
    from qtos_torch.device import resolve_device
    from qtos_torch.terrain import make_terrain

    dev = resolve_device(args.device)
    info = device_info(dev)
    print(f"running on {info['device_name']} ({info['device']}), power limit {info['power_limit']}")

    os.makedirs(LOG_DIR, exist_ok=True)
    os.makedirs(os.path.join(args.out, "traj"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "tracking"), exist_ok=True)

    if args.test:
        return run_smoke_test(dev, info)

    exp = get_experiment(args.exp)
    goal = tuple(args.goal[:2]) if args.goal else exp.goal_xy
    rng = np.random.default_rng(args.seed)
    terrain = make_terrain(
        list(exp.maps), scale_factor=exp.mesh_scale, randomize=exp.random_env, rng=rng, device=dev
    )

    blocked = None
    if exp.bool_map_search:
        from qtos_torch.planner.feasibility import feasibility_map

        print("probing feasibility map with batched solves...")
        t0 = time.time()
        blocked = feasibility_map(terrain)
        print(f"feasibility map done in {time.time()-t0:.1f}s "
              f"({int(blocked.sum())} blocked cells)")
        save_map_plot(blocked, os.path.join(args.out, "bool_map.png"))

    cfg = preset_runner_config(exp, realtime=args.realtime)
    if args.oneshot:
        return run_oneshot(terrain, goal, cfg, args, info)

    runner = RecedingHorizonRunner(terrain, goal, cfg=cfg, blocked=blocked, device=dev)
    save_plan_plot(runner.planner, os.path.join(args.out, "global_plan.png"))
    from qtos_torch.ops.btd import btd_solve

    btd_solve.launches = 0
    t0 = time.time()
    if args.profile:
        from qtos_torch.utils.profiling import trace

        with trace(args.profile):
            report = runner.run()
        print(f"trace written to {args.profile}")
    else:
        report = runner.run()
    wall = time.time() - t0
    launches = btd_solve.launches

    save_tracking_artifacts(report, args.out)
    if args.visual and report.ref_table is not None and len(report.ref_table):
        # offline analog of the reference's live scrolled plan preview
        # (QTOS/visual.py Visual_Planner.step): snapshot the upcoming plan at
        # several points along the run
        from qtos_torch.utils.visual import VisualPlanner

        vp = VisualPlanner(report.ref_table, out_dir=os.path.join(args.out, "visual"))
        T = len(report.ref_table)
        for frac in (0.0, 0.5, 0.9):
            vp.render(at_row=int(frac * (T - 1)), name=f"plan_{int(frac*100):02d}")
        print(f"plan-preview artifacts in {os.path.join(args.out, 'visual')}")
    recorded_ok = True
    if args.record:
        # the runner does not record joints: the hardware-replay CSV comes
        # from scripts/record_torch.py's path (one solved window over the
        # whole path, played back recorded) for the same preset and goal
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from record_torch import record

        rec = record(exp.name, list(goal), out=os.path.join(args.out, "traj"), device=dev)
        recorded_ok = rec["status"] == 0
    summary = dict(
        experiment=exp.name,
        reached_goal=report.reached_goal,
        windows=report.windows,
        sim_ticks=report.sim_ticks,
        final_pos=[float(v) for v in report.final_pos],
        goal=[float(v) for v in report.goal],
        avg_com_err_per_s=report.avg_com_err_per_s,
        solve_ms_p50=float(np.median(report.solve_wall_times[1:]) * 1000)
        if len(report.solve_wall_times) > 1
        else float(report.solve_wall_times[0] * 1000),
        stance_holds=report.stance_holds,
        aborted=report.aborted,
        statuses=report.statuses,
        # the BTD kernel's launches in the run (0 off the card: the plain
        # version runs there)
        btd_launches=launches,
        wall_time_s=wall,
        # the times above (solve_ms_p50, wall_time_s) were taken on:
        **info,
    )
    if args.realtime:
        summary["underruns"] = report.underruns
        summary["realtime_factor"] = round(report.realtime_factor, 3)
    write_summary(f"experiment_data_{exp.name}.out", summary)
    print(json.dumps(summary, indent=2))
    return 0 if report.reached_goal and recorded_ok else 1


def write_summary(name: str, summary: dict) -> None:
    with open(os.path.join(LOG_DIR, name), "w") as f:
        json.dump(summary, f, indent=2)


def run_oneshot(terrain, goal, cfg, args, info):
    """Single solve of the whole path (reference `-t` run_default,
    main.py:105-137: -duration 4.0 x num_tiles)."""
    import numpy as np

    from qtos_torch.control import ControlParams, playback, stance_warmup
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve
    from qtos_torch.solver.sampler import table_to_csv

    dev = terrain.device
    dist = float(np.hypot(goal[0], goal[1]))
    duration = max(2.5, dist / cfg.avg_speed)
    K = int(round(duration / 0.0625)) + 1
    spec = default_spec(terrain, start_xy=(0.0, 0.0), goal_xy=goal, duration=duration, K=K, device=dev)
    t0 = time.time()
    res = solve(spec, terrain, SolverConfig(max_iters=80, tol=5e-3))
    status, viol = int(res.status), float(res.max_violation)
    solve_s = time.time() - t0
    print(f"oneshot solve: status={status} viol={viol:.2e} "
          f"({solve_s:.1f}s on {info['device_name']}, power limit {info['power_limit']}, K={K})")
    table, _ = sample_trajectory(res.x, spec)
    table_to_csv(os.path.join(args.out, "traj", "towr.csv"), table)
    params = ControlParams()
    s0 = stance_warmup(state_from_row(table[0], terrain, params), terrain, params, 500)
    final, m = playback(table, s0, terrain, params)
    pos = final.pos.cpu()
    print(f"playback: final=({float(pos[0]):.2f},{float(pos[1]):.2f}) "
          f"metric={float(m.avg_com_err_per_s):.1f}")
    write_summary("oneshot.out", dict(
        status=status, max_violation=viol, K=K, solve_s=solve_s,
        final_pos=[float(v) for v in pos], avg_com_err_per_s=float(m.avg_com_err_per_s), **info))
    return 0 if status == 0 else 1


def run_smoke_test(dev, info):
    """Headless canned-trajectory replay (reference `-T`): solve one short
    window, replay it through the full stack."""
    import numpy as np

    from qtos_torch.control import ControlParams, playback, stance_warmup
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve
    from qtos_torch.terrain import make_terrain

    terrain = make_terrain(["plane", "plane"], device=dev)
    spec = default_spec(terrain, goal_xy=(0.5, 0.0), K=33, device=dev)
    t0 = time.time()
    res = solve(spec, terrain, SolverConfig(max_iters=30))
    table, _ = sample_trajectory(res.x, spec)
    print("replaying freshly solved canned trajectory")
    params = ControlParams()
    s0 = stance_warmup(state_from_row(table[0], terrain, params), terrain, params, 300)
    final, m = playback(table, s0, terrain, params)
    err = float(m.com_err.mean())
    final_z = float(final.pos[2])
    wall = time.time() - t0
    print(f"smoke test: mean CoM err {err:.3f} m, final z {final_z:.3f} "
          f"({wall:.1f} s on {info['device_name']}, power limit {info['power_limit']})")
    ok = bool(np.isfinite(err) and err < 0.15 and 0.1 < final_z < 0.4)
    write_summary("smoke_test.out", dict(ok=ok, mean_com_err=err, final_z=final_z,
                                         wall_time_s=wall, **info))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def save_tracking_artifacts(report, out_dir):
    """Render the reference's four tracking plots with the run's real series
    (reference: QTOS/tracking.py:202-401 — CoM track, per-foot ref-vs-sim
    panels, error, error-vs-distance) into <out>/tracking/."""
    try:
        from qtos_torch.utils.tracking import Tracking

        tr = Tracking(os.path.join(out_dir, "tracking"))
        T = len(report.sim_pos_series)
        tr.extend(report.ref_table[:T], report.sim_pos_series,
                  sim_feet=report.sim_feet_series)
        tr.plot()
        print(f"tracking artifacts in {tr.out_dir}: "
              f"{tr.summary()}")
    except ImportError as e:  # matplotlib optional
        print("plot skipped:", e)


def save_plan_plot(planner, path):
    try:
        planner.save_plot(path)
    except ImportError as e:  # matplotlib optional
        print("plot skipped:", e)


def save_map_plot(blocked, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        fig, ax = plt.subplots()
        ax.imshow(np.asarray(blocked), origin="lower", cmap="gray_r")
        fig.savefig(path, dpi=100)
        plt.close(fig)
    except ImportError as e:  # matplotlib optional
        print("plot skipped:", e)


if __name__ == "__main__":
    sys.exit(main())
