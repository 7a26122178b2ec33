"""Frozen copy of `qtos_torch/solver/jacobians.py` for the benchmark's plain reference: imports
rewritten to this package, nothing else changed unless a comment says so.

Residuals and their Jacobians in closed form, one knot and one interval
at a time, over any leading (B, K) axes (port of `qtos_tpu.solver.jacobians`).

Only the derivatives that the normal equations share are kept (the dense
`knot_system` / `interval_system` of the original are left out).  The two
Jacobians `qtos_tpu`
takes by forward-mode autodiff (the euler-rate and the world inertia's
dependence on the euler angles) are written in closed form from
dR/d(roll, pitch, yaw) (`euler_rate_jac`, `wdot_and_derivs`), which the
normal equations share.
"""

from __future__ import annotations

import torch

from .rotations import inv_cos_pitch, mat3, rx, ry, rz, skew
from .solo12 import Solo12

# column offsets in the per-knot state vector
C_R, C_TH, C_V, C_W, C_P, C_F = 0, 3, 6, 9, 12, 24


def rot_derivs(th):
    """R and dR/d(roll, pitch, yaw): (..., 3, 3) and (..., 3(j), 3, 3)."""
    roll, pitch, yaw = th[..., 0], th[..., 1], th[..., 2]
    Rz_, Ry_, Rx_ = rz(yaw), ry(pitch), rx(roll)
    z = torch.zeros_like(roll)
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    dRx = mat3([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    dRy = mat3([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRz = mat3([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    ZY = Rz_ @ Ry_
    R = ZY @ Rx_
    dR = torch.stack([ZY @ dRx, Rz_ @ dRy @ Rx_, dRz @ Ry_ @ Rx_], dim=-3)
    return R, dR


def euler_rate_jac(th, w):
    """d/d(th) of omega_to_euler_rate(th, w): (..., 3(out), 3(j)).

    rate = [a/cp, -sy w0 + cy w1, a sp/cp + w2] with a = cy w0 + sy w1; the
    1/cp factor is held at |cp| >= 1e-6 as in `euler_rate_matrix_inv`, and
    where it is held its derivative is zero (as autodiff of the clamp)."""
    pitch, yaw = th[..., 1], th[..., 2]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    ic = inv_cos_pitch(cp)
    dic = torch.where(torch.abs(cp) < 1e-6, torch.zeros_like(cp), sp * ic * ic)  # d(1/cp)/dpitch
    a = cy * w[..., 0] + sy * w[..., 1]
    a_y = -sy * w[..., 0] + cy * w[..., 1]
    z = torch.zeros_like(a)
    return mat3(
        [
            [z, a * dic, a_y * ic],
            [z, z, -a],
            [z, a * (cp * ic + sp * dic), a_y * sp * ic],
        ]
    )


def wdot_and_derivs(r, th, w, p, f):
    """omega_dot and its derivatives wrt (r, th, p, f, w), all closed form.

    Shapes: r/th/w (..., 3), p/f (..., 4, 3).  Returns wd (..., 3),
    dwd_dr (..., 3, 3), dwd_dth (..., 3, 3), dwd_dp (..., 4, 3, 3),
    dwd_df (..., 4, 3, 3), dwd_dw (..., 3, 3)."""
    consts = Solo12.tensors(th.device)
    R, dR = rot_derivs(th)
    RT = R.transpose(-1, -2)
    Ib, Ibinv = consts.inertia, consts.inertia_inv
    I_w = R @ Ib @ RT
    I_winv = R @ Ibinv @ RT
    pr = p - r[..., None, :]
    tau = torch.cross(pr, f, dim=-1).sum(-2)
    Iww = (I_w @ w[..., None])[..., 0]
    rhs = tau - torch.cross(w, Iww, dim=-1)
    wd = (I_winv @ rhs[..., None])[..., 0]

    dwd_dr = I_winv @ skew(f.sum(-2))
    dwd_dp = -I_winv[..., None, :, :] @ skew(f)
    dwd_df = I_winv[..., None, :, :] @ skew(pr)
    dwd_dw = -I_winv @ (skew(w) @ I_w - skew(Iww))

    # theta part: d(I R)/dth_j = dR_j I R^T + (dR_j I R^T)^T for I symmetric
    RTj = RT[..., None, :, :]
    dIw = dR @ Ib @ RTj
    dIw = dIw + dIw.transpose(-1, -2)                                  # (..., j, 3, 3)
    dIinv = dR @ Ibinv @ RTj
    dIinv = dIinv + dIinv.transpose(-1, -2)
    w_j = w[..., None, :]
    t1 = (dIinv @ rhs[..., None, :, None])[..., 0]                      # (..., j, 3)
    t2 = torch.cross(w_j.expand(t1.shape), (dIw @ w_j[..., None])[..., 0], dim=-1)
    cols = t1 - (I_winv[..., None, :, :] @ t2[..., None])[..., 0]       # (..., j, 3)
    dwd_dth = cols.transpose(-1, -2)
    return wd, dwd_dr, dwd_dth, dwd_dp, dwd_df, dwd_dw
