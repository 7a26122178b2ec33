"""Knot solution -> dense 1 kHz trajectory table (port of
`qtos_tpu.solver.sampler`).

Produces the 37-column trajectory schema:

    [t, CoM pos(3), CoM euler(3), FL/FR/HL/HR foot pos(12),
     CoM lin vel(3), CoM ang vel(3), FL/FR/HL/HR force(12)]
"""

from __future__ import annotations

import numpy as np
import torch

from qtos_torch.ops.rotations import omega_to_euler_rate
from qtos_torch.ops.splines import hermite_eval
from qtos_torch.solver.spec import ProblemSpec, unpack_state

TRAJ_COLS = 37


def _knot_foot_velocities(p, contact, dt):
    """(..., K, 4, 3) central-difference foot velocities, zero in stance."""
    v_mid = (p[..., 2:, :, :] - p[..., :-2, :, :]) / (2 * dt)
    v0 = (p[..., 1:2, :, :] - p[..., 0:1, :, :]) / dt
    vK = (p[..., -1:, :, :] - p[..., -2:-1, :, :]) / dt
    v = torch.cat([v0, v_mid, vK], dim=-3)
    return v * (1.0 - contact[..., None])


def sample_trajectory(x: torch.Tensor, spec: ProblemSpec, hz: int = 1000, t0=0.0):
    """Sample solved knot trajectories to dense tables.

    Args:
      x: (..., K, NV) solver output: one scenario, or a batch of them (the
        counterpart of `jax.vmap` over `qtos_tpu`'s `sample_trajectory`).
      spec: the spec with the same leading axes: dt and the contact schedule.
      hz: output rate.
      t0: time stamped into column 0 of the first row: a float, or a (...)
        tensor with one time per scenario (never read back to the host).

    Returns:
      (table, contact): (..., T, 37) float32 table and (..., T, 4) contact
      mask, where T = round(duration * hz) + 1.
    """
    s = unpack_state(x)
    K = x.shape[-2]
    lead = x.shape[:-2]
    dt = spec.dt
    duration = dt * (K - 1)
    T = int(round(duration * hz)) + 1
    times = torch.arange(T, dtype=torch.float32, device=x.device) / hz

    seg = torch.clamp(torch.floor(times / dt).long(), 0, K - 2)
    tau = times / dt - seg.to(torch.float32)

    def seg_interp(knot_x, knot_v):
        pos, vel, _ = hermite_eval(
            knot_x[..., seg, :], knot_x[..., seg + 1, :],
            knot_v[..., seg, :], knot_v[..., seg + 1, :], dt, tau
        )
        return pos, vel

    def lerp(knot):
        return knot[..., seg, :] * (1 - tau)[:, None] + knot[..., seg + 1, :] * tau[:, None]

    rate = omega_to_euler_rate(s["th"], s["w"])
    r, v = seg_interp(s["r"], s["v"])
    th, _ = seg_interp(s["th"], rate)
    # angular velocity: interpolated linearly (consistent with trapezoidal defects)
    w = lerp(s["w"])

    contact_k = spec.schedule.contact
    pv = _knot_foot_velocities(s["p"], contact_k, dt)
    p, _ = seg_interp(s["p"].reshape(lead + (K, 12)), pv.reshape(lead + (K, 12)))

    f = lerp(s["f"].reshape(lead + (K, 12)))

    contact = contact_k[..., seg, :] * contact_k[..., seg + 1, :]

    stamp = times + (t0[..., None] if isinstance(t0, torch.Tensor) else t0)
    stamp = stamp.expand(lead + (T,))[..., None]
    table = torch.cat([stamp, r, th, p, v, w, f], dim=-1).to(torch.float32)
    return table, contact


def table_to_csv(path: str, table) -> None:
    """Write the reference CSV format (no header)."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    np.savetxt(path, np.asarray(table), delimiter=",", fmt="%.6g")


def csv_to_table(path: str):
    """Read a 37-column trajectory CSV as a numpy array."""
    return np.loadtxt(path, delimiter=",", dtype=np.float32)
