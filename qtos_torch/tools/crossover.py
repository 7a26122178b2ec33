r"""Walk a preset in two legs, each on a device of its own, through the
runner's checkpoint: which device carries a walk's outcome?

    python3 -m qtos_torch.tools.crossover --exp exp_2 --device cuda --windows 5 --save A.npz
    python3 -m qtos_torch.tools.crossover --exp exp_2 --device cpu --resume A.npz
    python3 -m qtos_torch.tools.crossover --exp exp_2 --device cuda --stairs

The first form runs the preset's first N windows (the configuration
`scripts/main_torch.py` runs it with) and writes the runner's checkpoint
after the last; the second continues a checkpoint to the walk's end on
another (or the same) device.  A checkpoint holds the trajectory buffers,
the execution cursor, the simulator's state and the solver's warm start,
but not the yaw trace of the last chunk, so a resumed walk replans its first
window from the measured yaw alone: compare a crossover with the same
checkpoint resumed on its own device.  `--stairs` walks the preset with
exp_6's stair settings instead (`rough_pace=12.0`, the `stairs` controller
profile), the preset itself unchanged.  Each run prints the runner's
per-window log and, last, one JSON line: reached, solves, ticks, stance
holds, final position, `avg_com_err_per_s`, wall seconds and the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from qtos_torch.builder import preset_runner_config
from qtos_torch.config import get_experiment
from qtos_torch.control.loop import control_profile
from qtos_torch.control.replan import RecedingHorizonRunner
from qtos_torch.device import resolve_device
from qtos_torch.terrain import make_terrain


def runner_for(exp_name: str, device, stairs: bool = False, **overrides) -> RecedingHorizonRunner:
    """The preset's runner on `device`; `stairs` swaps in exp_6's stair
    settings, `overrides` replace RunnerConfig fields."""
    exp = get_experiment(exp_name)
    if exp.bool_map_search or exp.random_env:
        raise ValueError(f"{exp.name}: this tool walks presets without a probed or random map")
    dev = resolve_device(device)
    terrain = make_terrain(list(exp.maps), scale_factor=exp.mesh_scale, device=dev)
    cfg = preset_runner_config(exp)
    if stairs:
        stair = get_experiment("exp_6")
        cfg.rough_pace = stair.rough_pace
        cfg.control = control_profile(stair.control_profile)
    cfg = dataclasses.replace(cfg, **overrides)
    return RecedingHorizonRunner(terrain, exp.goal_xy, cfg=cfg, device=dev)


def summary(rep, wall: float, device) -> dict:
    return dict(reached_goal=rep.reached_goal, aborted=rep.aborted, solves=rep.windows,
                ticks=rep.sim_ticks, stance_holds=rep.stance_holds, statuses=rep.statuses,
                final_pos=[float(v) for v in rep.final_pos],
                avg_com_err_per_s=float(rep.avg_com_err_per_s), wall_s=wall, device=str(device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp", default="exp_2")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--windows", type=int, default=None, help="stop after this many windows")
    p.add_argument("--save", default=None, help="write the checkpoint here after the last window")
    p.add_argument("--resume", default=None, help="continue this checkpoint")
    p.add_argument("--stairs", action="store_true", help="exp_6's stair settings")
    args = p.parse_args(argv)
    overrides = {}
    if args.windows is not None:
        overrides["max_windows"] = args.windows
    if args.save:
        if args.windows is None:
            p.error("--save needs --windows")
        overrides.update(checkpoint_every=args.windows, checkpoint_path=args.save)
    runner = runner_for(args.exp, args.device, stairs=args.stairs, **overrides)
    t0 = time.time()
    rep = runner.run(verbose=True, resume_from=args.resume)
    wall = time.time() - t0
    out = summary(rep, wall, runner.device)
    out.update(exp=args.exp, stairs=args.stairs, resumed_from=args.resume, saved=args.save)
    print(json.dumps(out))
    return 0 if np.isfinite(rep.final_pos).all() else 1


if __name__ == "__main__":
    raise SystemExit(main())
