"""Frozen copy of `qtos_torch/ops/splines.py` for the benchmark's plain reference: imports
rewritten to this package, nothing else changed unless a comment says so.

Spline kernels: cubic Hermite evaluation and natural cubic spline fitting
(port of `qtos_tpu.ops.splines`).

The solver interpolates base / end-effector motion on a uniform knot grid with
cubic Hermite segments; the global planner fits natural cubic splines through
its waypoints with a Thomas solve."""

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


def tridiag_solve(dl, d, du, b):
    """Solve a scalar tridiagonal system via the Thomas algorithm.

    Args:
      dl: (N,) sub-diagonal (dl[0] unused).
      d:  (N,) diagonal.
      du: (N,) super-diagonal (du[N-1] unused).
      b:  (N, ...) right-hand side.

    Returns:
      x: (N, ...) solution.
    """
    n = d.shape[0]
    cps, dps = [], []
    cp, dp = torch.zeros_like(d[0]), torch.zeros_like(b[0])
    for i in range(n):
        denom = d[i] - dl[i] * cp
        cp = du[i] / denom
        dp = (b[i] - dl[i] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    xs = [None] * n
    x = torch.zeros_like(b[0])
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=0)


def natural_cubic_coeffs(y: torch.Tensor, h):
    """Second derivatives of a natural cubic spline through uniform knots.

    Args:
      y: (N, ...) knot values at spacing ``h``.
    Returns:
      m: (N, ...) second derivatives (m[0] = m[-1] = 0).
    """
    n = y.shape[0]
    rhs = 6.0 * (y[2:] - 2.0 * y[1:-1] + y[:-2]) / (h * h)
    d = torch.full((n - 2,), 4.0, dtype=y.dtype, device=y.device)
    dl = torch.ones_like(d)
    du = torch.ones_like(d)
    dl[0] = 0.0
    du[-1] = 0.0
    m_inner = tridiag_solve(dl, d, du, rhs)
    pad = torch.zeros_like(y[:1])
    return torch.cat([pad, m_inner, pad], dim=0)


def natural_cubic_eval(y: torch.Tensor, m: torch.Tensor, h, x0, xq: torch.Tensor):
    """Evaluate the natural cubic spline defined by values ``y`` and second
    derivatives ``m`` on a uniform grid starting at ``x0`` with spacing ``h``.

    Returns (val, deriv) at query points xq (T,).
    """
    n = y.shape[0]
    t = (xq - x0) / h
    seg = torch.clamp(torch.floor(t).long(), 0, n - 2)
    u = t - seg.to(t.dtype)
    if y.dim() > 1:
        u = u[..., None]
    y0, y1 = y[seg], y[seg + 1]
    m0, m1 = m[seg], m[seg + 1]
    a = y0
    b = (y1 - y0) / h - h * (2.0 * m0 + m1) / 6.0
    c = m0 / 2.0
    d = (m1 - m0) / (6.0 * h)
    du = u * h
    val = a + b * du + c * du * du + d * du * du * du
    deriv = b + 2.0 * c * du + 3.0 * d * du * du
    return val, deriv
