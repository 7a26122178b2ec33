#!/usr/bin/env python3
"""Measure trajectory deviation vs TOWR's golden window with qtos_torch: the
counterpart of `scripts/towr_deviation.py` for the PyTorch/CUDA port.

Solves the port's collocation NLP from the exact start state, contact
schedule, and goal of a golden 1 kHz trajectory table (37 columns: t, r, eul,
feet, v, omega, forces; the reference's checked-in TOWR/IPOPT solution by
default, `data/traj/towr.csv` as the reference project lays it out) and
reports CoM / foot deviation.

    python scripts/towr_deviation_torch.py                       # on the card
    python scripts/towr_deviation_torch.py --golden PATH --device cpu

It runs on CUDA unless `--device` (or `device=`) says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np

# Where the reference project keeps TOWR's golden window; this repository
# does not hold it, so pass `golden=` (or `--golden`) to name a table.
GOLDEN = os.path.join(ROOT, "data", "traj", "towr.csv")


def towr_window(duration: float = 2.5, K: int = 41, row0: int = 0, golden: str = GOLDEN, device=None):
    """Extract (spec, golden_slice) for a `duration`-second window of the
    golden trajectory starting at row `row0`, the spec's tensors on `device`
    (None: CUDA).

    The schedule is TOWR's own: contact masks sampled from the golden force
    profile (fz > 1 N) at the K knot times, with per-leg swing progress
    computed from the 1 kHz contact run-lengths.
    """
    import torch

    from qtos_torch.device import resolve_device
    from qtos_torch.solver.gait import GaitSchedule
    from qtos_torch.solver.spec import ProblemSpec, RobotState

    dev = resolve_device(device)
    tab = np.loadtxt(golden, delimiter=",")
    rows = int(round(duration * 1000))
    g = tab[row0 : row0 + rows + 1]
    assert len(g) == rows + 1, "golden window exceeds fixture length"

    r = g[:, 1:4]
    eul = g[:, 4:7]
    feet = g[:, 7:19].reshape(-1, 4, 3)
    v = g[:, 19:22]
    w = g[:, 22:25]
    f = g[:, 25:37].reshape(-1, 4, 3)

    contact_1k = (f[..., 2] > 1.0).astype(np.float32)  # (T, 4)
    dt = duration / (K - 1)
    knot_rows = np.round(np.arange(K) * dt * 1000).astype(int)
    contact = contact_1k[knot_rows]

    # swing progress at each knot: fraction elapsed of the enclosing 1 kHz
    # swing interval (0 in stance)
    prog = np.zeros((K, 4), np.float32)
    for leg in range(4):
        c = contact_1k[:, leg]
        # segment boundaries
        change = np.flatnonzero(np.diff(c) != 0) + 1
        bounds = np.concatenate([[0], change, [len(c)]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            if c[a] == 0:  # swing segment [a, b)
                for k, kr in enumerate(knot_rows):
                    if a <= kr < b:
                        prog[k, leg] = (kr - a) / max(b - a - 1, 1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    sched = GaitSchedule(contact=f32(contact), swing_progress=f32(prog))
    start = RobotState(r=f32(r[0]), eul=f32(eul[0]), v=f32(v[0]), omega=f32(w[0]), feet=f32(feet[0]))
    spec = ProblemSpec(
        start=start,
        goal_r=f32(r[rows]),
        goal_yaw=f32(eul[rows, 2]),
        duration=f32(duration),
        schedule=sched,
        dt=dt,
    )
    return spec, g


def measure(duration: float = 2.5, K: int = 41, max_iters: int = 120, row0: int = 0,
            golden: str = GOLDEN, device=None):
    """Solve the golden window with the port and return (figures, result,
    spec); the solve runs on `device` (None: CUDA)."""
    from qtos_torch.solver.sampler import sample_trajectory
    from qtos_torch.solver.solve import solve
    from qtos_torch.solver.spec import SolverConfig
    from qtos_torch.terrain import make_terrain

    terrain = make_terrain(["plane"] * 4, device=device)  # golden run is flat ground
    spec, g = towr_window(duration, K, row0, golden=golden, device=device)
    cfg = SolverConfig(max_iters=max_iters, tol=3e-3)
    res = solve(spec, terrain, cfg)
    table, _ = sample_trajectory(res.x, spec, hz=1000)
    ours = table.cpu().numpy()

    T = min(len(ours), len(g))
    com_dev = np.linalg.norm(ours[:T, 1:4] - g[:T, 1:4], axis=-1)
    feet_dev = np.linalg.norm(
        ours[:T, 7:19].reshape(-1, 4, 3) - g[:T, 7:19].reshape(-1, 4, 3), axis=-1
    )
    out = dict(
        status=int(res.status),
        max_violation=float(res.max_violation),
        com_rms=float(np.sqrt((com_dev**2).mean())),
        com_max=float(com_dev.max()),
        com_mean=float(com_dev.mean()),
        feet_rms=float(np.sqrt((feet_dev**2).mean())),
        feet_max=float(feet_dev.max()),
        end_dev=float(com_dev[-1]),
    )
    return out, res, spec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="qtos_torch deviation from a golden 1 kHz window")
    ap.add_argument("--golden", default=GOLDEN, help="37-column 1 kHz trajectory CSV")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    out, res, spec = measure(golden=args.golden, device=args.device)
    for k, v in out.items():
        print(f"{k:14s} {v:.6g}")
