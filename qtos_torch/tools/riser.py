r"""One exp_2 window over the first riser, played on two devices tick by tick.

    python3 -m qtos_torch.tools.riser [--ticks N]

exp_2 ("climbing over steps": step, step_1, step_2, plane at mesh scale 2)
first climbs where the route meets step_2's 5-7.5 cm riser at x = 3.4 m.
`riser_window` solves the runner's window there on the CPU: the runner's
shape (K=41, 2.5 s, `max_iters` 30, tol 3e-3), a standing start at
x = 3.1 m and a 0.55 m goal, so all four feet cross the riser.  `divergence` plays one table from one start state
on two devices in lock step and reports, for every leaf, the first tick at
which the two differ by more than a threshold: the contact flags (pen > 0),
the stiction anchors, the terrain height under each foot, the joint state
and the base state.  The CLI plays that window on the card against the CPU
and prints the report; it needs a card.
"""

from __future__ import annotations

import argparse
import json

import torch

from qtos_torch.config import get_experiment
from qtos_torch.control.loop import _tick, gait_control_params, plan_joint_targets, stance_warmup, state_from_row
from qtos_torch.control.replan import RunnerConfig
from qtos_torch.sim.engine import SimState, foot_kinematics
from qtos_torch.solver import default_spec, sample_trajectory, solve
from qtos_torch.solver.spec import map_tensors
from qtos_torch.terrain import make_terrain
from qtos_torch.terrain.heightfield import height_at

START_X, GOAL_DX = 3.1, 0.55
RISER_X = 3.4          # step_2's first x-jump: the cell boundary at column 88
THRESHOLD = 1e-6       # a leaf has parted where the two devices differ by more
# Leaves in the order the report names them.  "contact" is a flag per foot;
# the rest are float leaves compared by their largest absolute difference.
LEAVES = ("contact", "anchor", "foot_h", "q", "qd", "pos", "quat", "v", "w")
# The leaves of position and contact.  The velocities part first and early:
# the desired joint velocity is a difference of two IK results over dt, which
# turns a 1e-7 rad rounding difference into 1e-4 rad/s at the first tick.
POSITION_LEAVES = ("contact", "anchor", "foot_h", "q", "pos", "quat")


def riser_window(device="cpu"):
    """(terrain, table (2501, 37), status, warmed-up start state) of the window
    over exp_2's first riser, solved, sampled and warmed up on `device`."""
    exp = get_experiment("exp_2")
    terrain = make_terrain(list(exp.maps), scale_factor=exp.mesh_scale, device=device)
    cfg = RunnerConfig()
    spec = default_spec(terrain, start_xy=(START_X, 0.0), goal_xy=(START_X + GOAL_DX, 0.0),
                        duration=cfg.window_duration, K=cfg.K, device=device)
    res = solve(spec, terrain, cfg.solver)
    table, _ = sample_trajectory(res.x, spec)
    params = gait_control_params(cfg.gait)
    s0 = stance_warmup(state_from_row(table[0], terrain, params), terrain, params,
                       cfg.stance_warmup_steps)
    return terrain, table, int(res.status), s0


def _probe(state: SimState, terrain):
    """The leaves of one tick's end state, each (T-less) on its device."""
    feet_w = foot_kinematics(state)[0]
    h = height_at(terrain, feet_w[..., 0], feet_w[..., 1])
    return dict(contact=(h - feet_w[..., 2] > 0.0).float(), anchor=state.anchor, foot_h=h,
                q=state.q, qd=state.qd, pos=state.pos, quat=state.quat, v=state.v, w=state.w)


def divergence(table, state0: SimState, terrain, device_b, ticks=None):
    """Play `table` from `state0` on its own device and, from bit-for-bit
    copies, on `device_b`, in lock step, with the runner's controller.  Returns a dict: for each leaf its
    first parting tick (None if it never parts) and its largest difference
    over the run, the first tick and leaf overall, the first tick of the
    position and contact leaves, and the final |dpos| and |dq|.  Ticks count
    from 0, the first row of the table."""
    params = gait_control_params(RunnerConfig().gait)
    T = table.shape[-2] if ticks is None else min(ticks, table.shape[-2])
    to_b = lambda t: t.to(device_b)                                      # noqa: E731
    terr_b = map_tensors(terrain, to_b)
    table_b = to_b(table)
    zeros = lambda dev, shape: torch.zeros(shape, dtype=table.dtype, device=dev)  # noqa: E731
    carries = []
    for tab, st, dev in ((table, state0, table.device), (table_b, map_tensors(state0, to_b), device_b)):
        q0, _ = plan_joint_targets(tab[0], params)
        carries.append([st, q0, zeros(dev, (4, 3)), zeros(dev, (3,)), zeros(dev, ())])
    traces = ({k: [] for k in LEAVES}, {k: [] for k in LEAVES})
    terrs, tabs = (terrain, terr_b), (table, table_b)
    for t in range(T):
        for side in (0, 1):
            carry, _ = _tick(tuple(carries[side]), tabs[side][t], terrs[side], params)
            carries[side] = list(carry)
            for k, v in _probe(carry[0], terrs[side]).items():
                traces[side][k].append(v)
    out = {"ticks": T, "threshold": THRESHOLD, "leaves": {}}
    first = (None, None)
    for k in LEAVES:
        a = torch.stack(traces[0][k]).cpu()
        b = torch.stack(traces[1][k]).cpu()
        d = (a - b).abs().reshape(T, -1).amax(dim=1)
        bad = torch.nonzero(d > THRESHOLD).flatten()
        tick = int(bad[0]) if bad.numel() else None
        out["leaves"][k] = {"first_tick": tick, "max_abs_diff": float(d.max())}
        if tick is not None and (first[0] is None or tick < first[0]):
            first = (tick, k)
    out["first_tick"], out["first_leaf"] = first
    ticks = [out["leaves"][k]["first_tick"] for k in POSITION_LEAVES if out["leaves"][k]["first_tick"] is not None]
    out["first_position_tick"] = min(ticks) if ticks else None
    fa, fb = carries[0][0], carries[1][0]
    out["final_dpos"] = float((fa.pos.cpu() - fb.pos.cpu()).abs().max())
    out["final_dq"] = float((fa.q.cpu() - fb.q.cpu()).abs().max())
    out["final_x"] = (float(fa.pos[0]), float(fb.pos.cpu()[0]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ticks", type=int, default=None, help="rows to play (default: the whole table)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("riser: this tool needs a CUDA card")
        return 1
    terrain, table, status, s0 = riser_window("cpu")
    rep = divergence(table, s0, terrain, torch.device("cuda"), ticks=args.ticks)
    rep["status"] = status
    print(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
