#!/usr/bin/env python3
"""Record a realized joint trajectory for hardware (SOLO12 SDK) replay with
the PyTorch/CUDA port: the counterpart of `scripts/record.py`.

One window over the whole path (K from the distance over the preset's
`avg_speed`, `SolverConfig(max_iters=60, tol=5e-3)`) is solved, sampled to
1 kHz, warmed up for 500 ticks and played back, and the realized
[12 joint angles, 12 velocities, 12 torques] of each tick, duplicated
`--copy-pts` times, go to `<out>/towr_traj_cmode_torque.csv`.  The tracking
plots go to `<out>/../tracking` and a JSON summary (status, CSV shape,
tracking metrics) to `logs/torch/record_<exp>.out`; the files
`scripts/record.py` writes are never touched.

    python scripts/record_torch.py --exp exp_1 -g 1.0 0
    python scripts/record_torch.py --exp exp_1 -g 0.5 0 --device cpu

It runs on CUDA unless `--device` says otherwise, and exits 1 when the solve
does not converge (the CSV is written all the same).
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
    p = argparse.ArgumentParser(description="qtos_torch hardware-replay recorder")
    p.add_argument("--exp", default="exp_1", help="experiment preset (exp_1..exp_10)")
    p.add_argument("-g", "--goal", nargs="+", type=float, default=None, help="goal x y")
    p.add_argument("--copy-pts", type=int, default=1,
                   help="row duplication factor (reference copy_trajectory_pts)")
    p.add_argument("--out", default=os.path.join("data", "torch", "traj"))
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p


def record(exp_name: str, goal=None, copy_pts: int = 1, out: str = os.path.join("data", "torch", "traj"),
           device=None) -> dict:
    """Solve -> sample -> warm up -> play back recorded -> CSV.  Returns the
    summary (status, max violation, CSV path and shape, tracking metrics)."""
    import numpy as np

    from qtos_torch.config import get_experiment
    from qtos_torch.control import ControlParams, stance_warmup
    from qtos_torch.control.loop import playback_recorded, record_csv, state_from_row
    from qtos_torch.device import resolve_device
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve
    from qtos_torch.terrain import make_terrain
    from qtos_torch.utils.tracking import Tracking

    dev = resolve_device(device)
    exp = get_experiment(exp_name)
    goal = tuple(goal[:2]) if goal else exp.goal_xy
    terrain = make_terrain(list(exp.maps), scale_factor=exp.mesh_scale, device=dev)

    dist = float(np.hypot(goal[0], goal[1]))
    duration = max(2.5, dist / exp.avg_speed)
    K = int(round(duration / 0.0625)) + 1
    spec = default_spec(terrain, goal_xy=goal, duration=duration, K=K, device=dev)
    t0 = time.time()
    res = solve(spec, terrain, SolverConfig(max_iters=60, tol=5e-3))
    status, viol = int(res.status), float(res.max_violation)
    print(f"solve status={status} viol={viol:.2e} (K={K}, {time.time() - t0:.1f} s on {dev})")
    table, _ = sample_trajectory(res.x, spec)

    params = ControlParams()
    s0 = stance_warmup(state_from_row(table[0], terrain, params), terrain, params, 500)
    _, _, traces = playback_recorded(table, s0, terrain, params)

    os.makedirs(out, exist_ok=True)
    out_csv = os.path.join(out, "towr_traj_cmode_torque.csv")
    record_csv(traces, out_csv, copy_pts)
    rows = traces["q"].shape[0] * copy_pts
    print(f"wrote {out_csv} ({rows} rows x 36 cols)")

    tr = Tracking(os.path.join(os.path.dirname(os.path.abspath(out)), "tracking"))
    tr.extend(table.cpu().numpy(), traces["pos"].cpu().numpy())
    tr.plot()
    summary = dict(experiment=exp.name, goal=[float(g) for g in goal], K=K, status=status,
                   max_violation=viol, csv=out_csv, rows=int(rows), cols=36,
                   device=str(dev), **tr.summary())
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, f"record_{exp.name}.out"), "w") as f:
        json.dump(summary, f, indent=2)
    print("tracking:", json.dumps(tr.summary()))
    return summary


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    summary = record(args.exp, args.goal, args.copy_pts, args.out, args.device)
    return 0 if summary["status"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
