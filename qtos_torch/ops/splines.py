"""Cubic Hermite spline evaluation (port of the Hermite part of
`qtos_tpu.ops.splines`).  Everything broadcasts over leading batch dims."""

from __future__ import annotations

import torch


def hermite_eval(x0, x1, v0, v1, dt, tau):
    """Evaluate a cubic Hermite segment at normalized time tau in [0, 1].

    Args:
      x0, x1: (..., d) endpoint values.
      v0, v1: (..., d) endpoint derivatives (per unit real time, segment
        duration ``dt``).
      dt: scalar segment duration.
      tau: (...,) normalized time.

    Returns:
      (pos, vel, acc): each (..., d); vel/acc are per unit real time.
    """
    t = tau[..., None]
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    pos = h00 * x0 + h10 * dt * v0 + h01 * x1 + h11 * dt * v1

    d00 = 6 * t2 - 6 * t
    d10 = 3 * t2 - 4 * t + 1
    d01 = -6 * t2 + 6 * t
    d11 = 3 * t2 - 2 * t
    vel = (d00 * x0 + d10 * dt * v0 + d01 * x1 + d11 * dt * v1) / dt

    a00 = 12 * t - 6
    a10 = 6 * t - 4
    a01 = -12 * t + 6
    a11 = 6 * t - 2
    acc = (a00 * x0 + a10 * dt * v0 + a01 * x1 + a11 * dt * v1) / (dt * dt)
    return pos, vel, acc


def sample_knots(knot_x: torch.Tensor, knot_v: torch.Tensor, dt, times: torch.Tensor):
    """Sample a uniform-knot Hermite spline at arbitrary times.

    Args:
      knot_x: (K, d) knot values.
      knot_v: (K, d) knot derivatives.
      dt: knot spacing (real time).
      times: (T,) query times in [0, (K-1)*dt].

    Returns:
      (pos, vel, acc): each (T, d).
    """
    K = knot_x.shape[0]
    seg = torch.clamp(torch.floor(times / dt).long(), 0, K - 2)
    tau = times / dt - seg.to(times.dtype)
    return hermite_eval(knot_x[seg], knot_x[seg + 1], knot_v[seg], knot_v[seg + 1], dt, tau)
