"""Residuals and their Jacobians in closed form, one knot and one interval
at a time, over any leading (B, K) axes (port of `qtos_tpu.solver.jacobians`).

`knot_system` and `interval_system` return each residual family's rows and
the dense Jacobian rows over the 36-wide knot state, built by concatenating
small dense blocks in `qtos_tpu`'s row order.  J^T J and J^T rho of these
rows are the second derivation of the Gauss-Newton blocks that
`qtos_torch.solver.normal_eq` assembles directly; the tests hold the two
against each other and against `qtos_tpu`.  The two Jacobians `qtos_tpu`
takes by forward-mode autodiff (the euler-rate and the world inertia's
dependence on the euler angles) are written in closed form from
dR/d(roll, pitch, yaw) (`euler_rate_jac`, `wdot_and_derivs`), which the
normal equations share.
"""

from __future__ import annotations

import math

import torch

from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops.rotations import (
    euler_rate_matrix_inv,
    inv_cos_pitch,
    mat3,
    omega_to_euler_rate,
    rx,
    ry,
    rz,
    skew,
)
from qtos_torch.solver.spec import FORCE_SCALE, IDX_F, NV, ProblemSpec, SolverConfig, unpack_state
from qtos_torch.solver.transcription import GRAVITY_Z, KnotAux
from qtos_torch.terrain.heightfield import Terrain, grad_at, height_at, slope_grad_at

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


def _goal_pattern(like) -> torch.Tensor:
    """The goal rows' fixed sparsity: rows [r(3), yaw, 0.5 v(3), 0.5 w(3)]."""
    P = torch.zeros((10, NV), dtype=like.dtype, device=like.device)
    i3 = torch.arange(3, device=like.device)
    P[i3, C_R + i3] = 1.0
    P[3, C_TH + 2] = 1.0
    P[4 + i3, C_V + i3] = 0.5
    P[7 + i3, C_W + i3] = 0.5
    return P


def _embed_feet(vals):
    """Per-foot row values (..., 4, c) -> (..., 4, 4c) block-diagonal rows:
    foot i's row touches only its own column block."""
    eye4 = torch.eye(4, dtype=vals.dtype, device=vals.device)
    return (vals[..., :, None, :] * eye4[:, :, None]).reshape(vals.shape[:-2] + (4, 4 * vals.shape[-1]))


def _lift_p(vals):
    """Foot-local p-column rows (..., 4, 3) -> (..., 4, NV)."""
    z = vals.new_zeros(vals.shape[:-2] + (4, 12))
    return torch.cat([z, _embed_feet(vals), z], dim=-1)


def knot_system(x, aux: KnotAux, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig):
    """Knot residuals and their Jacobian: x (B, K, NV) -> rho (B, K, m1),
    J (B, K, m1, NV), rows in `qtos_tpu`'s order (terrain, clearance,
    no-penetration, swing force, friction, RoM, posture, slope, body, init,
    goal)."""
    W = cfg.weights
    s = unpack_state(x)
    r, th, v, w, p = s["r"], s["th"], s["v"], s["w"], s["p"]
    lead = x.shape[:-1]
    c = aux.contact
    swing = 1.0 - c
    fs = x[..., IDX_F].reshape(lead + (4, 3))
    dt_, dev = x.dtype, x.device
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=dt_, device=dev)   # noqa: E731

    h = height_at(terrain, p[..., 0], p[..., 1])
    hx, hy = grad_at(terrain, p[..., 0], p[..., 1])
    a_dir = torch.stack([-hx, -hy, torch.ones_like(hx)], dim=-1)       # (..., 4, 3)

    # 1. terrain contact (target h + first-stance slack)
    res_terr = (p[..., 2] - h - aux.terr_slack) * c * W.terr
    J_terr = _lift_p(a_dir * (c * W.terr)[..., None])
    # 2. swing clearance shaping
    bell = torch.sin(math.pi * aux.swing_prog)
    res_clear = (p[..., 2] - (h + cfg.swing_clearance * bell)) * swing * W.clear
    J_clear = _lift_p(a_dir * (swing * W.clear)[..., None])
    # 3. no-penetration hinge
    gpen = h - 0.005 - p[..., 2]
    act = (gpen > 0.0).to(dt_)
    res_nopen = torch.clamp(gpen, min=0.0) * swing * W.terr
    J_nopen = _lift_p(-a_dir * (act * swing * W.terr)[..., None])

    # 4. swing force zero (stored-scale forces)
    res_fzero = (fs * swing[..., None]).reshape(lead + (12,)) * W.fzero
    J_fzero = torch.cat([zeros(12, 24), torch.diag_embed(swing.repeat_interleave(3, dim=-1) * W.fzero)], dim=-1)

    # 5. friction pyramid (6 rows per foot, stored-scale forces)
    mu_t = cfg.mu_friction / math.sqrt(2.0)
    fx, fy, fz = fs[..., 0], fs[..., 1], fs[..., 2]
    fr = torch.stack(
        [
            torch.clamp(fx - mu_t * fz, min=0.0),
            torch.clamp(-fx - mu_t * fz, min=0.0),
            torch.clamp(fy - mu_t * fz, min=0.0),
            torch.clamp(-fy - mu_t * fz, min=0.0),
            torch.clamp(-fz, min=0.0) * 2.0,
            torch.clamp(fz - cfg.f_max / FORCE_SCALE, min=0.0),
        ],
        dim=-1,
    )
    res_fric = (fr * c[..., None] * W.fric).reshape(lead + (24,))
    base_rows = torch.tensor(
        [[1.0, 0.0, -mu_t], [-1.0, 0.0, -mu_t], [0.0, 1.0, -mu_t], [0.0, -1.0, -mu_t],
         [0.0, 0.0, -2.0], [0.0, 0.0, 1.0]],
        dtype=dt_, device=dev,
    )
    fvals = ((fr > 0.0).to(dt_) * (c * W.fric)[..., None])[..., None] * base_rows    # (..., 4, 6, 3)
    eye4 = torch.eye(4, dtype=dt_, device=dev)
    J_fric_f = (fvals[..., :, :, None, :] * eye4[:, None, :, None]).reshape(lead + (24, 12))
    J_fric = torch.cat([zeros(24, 24), J_fric_f], dim=-1)

    # 6/7. RoM hinges + posture: d = R^T (p - r) - nominal; the row of
    # (foot i, component m) is u = [-R[:, m] on r, dd_dth[i, m] on th,
    # R[:, m] on p_i], shared by the hi/lo/posture rows up to a gate.
    R, dR = rot_derivs(th)
    pr = p - r[..., None, :]
    d = torch.einsum("...ji,...kj->...ki", R, pr) - Solo12.tensors(dev).nominal_feet
    box = torch.tensor(cfg.rom_box, dtype=dt_, device=dev) + aux.box_widen
    hi = torch.clamp(d - box, min=0.0)
    lo = torch.clamp(-d - box, min=0.0)
    res_rom = torch.cat([hi, lo], dim=-1).reshape(lead + (24,)) * W.rom
    res_post = d.reshape(lead + (12,)) * W.post_reg
    dd_dth = torch.einsum("...jam,...ka->...kmj", dR, pr)              # (..., 4, 3, 3)
    Rcols = R.transpose(-1, -2)                                         # row m = R[:, m]
    u_r = (-Rcols)[..., None, :, :].expand(lead + (4, 3, 3))
    u_p = (Rcols[..., None, :, None, :] * eye4[:, None, :, None]).reshape(lead + (4, 3, 12))
    u = torch.cat([u_r, dd_dth, zeros(4, 3, 6), u_p, zeros(4, 3, 12)], dim=-1)     # (..., 4, 3, NV)
    act_hi = (d - box > 0).to(dt_)
    act_lo = (-d - box > 0).to(dt_)
    J_hi = (act_hi * W.rom)[..., None] * u
    J_lo = -(act_lo * W.rom)[..., None] * u
    J_rom = torch.cat([J_hi, J_lo], dim=-2).reshape(lead + (24, NV))
    J_post = (W.post_reg * u).reshape(lead + (12, NV))

    # foothold slope hinge (first-stance feet exempt)
    sl, slx, sly = slope_grad_at(terrain, p[..., 0], p[..., 1], cfg.slope_probe_d)
    act_sl = (sl - cfg.slope_margin > 0.0).to(dt_)
    m_slope = c * (1.0 - aux.first_stance) * W.slope
    res_slope = torch.clamp(sl - cfg.slope_margin, min=0.0) * m_slope
    u_sl = torch.stack([slx, sly, torch.zeros_like(slx)], dim=-1)
    J_slope = _lift_p(u_sl * (act_sl * m_slope)[..., None])

    # 7b. base clearance hinge
    hb = height_at(terrain, r[..., 0], r[..., 1])
    hbx, hby = grad_at(terrain, r[..., 0], r[..., 1])
    gb = hb + cfg.body_clearance - r[..., 2]
    act_b = (gb > 0.0).to(dt_)
    res_body = torch.clamp(gb, min=0.0)[..., None] * W.body
    u_body = torch.cat([torch.stack([hbx, hby, -torch.ones_like(hbx)], dim=-1), zeros(NV - 3)], dim=-1)
    J_body = ((act_b * W.body)[..., None] * u_body)[..., None, :]

    # 8. init (first knot)
    st = spec.start
    m0 = aux.is_first * W.init                                          # (K,)
    res_init = torch.cat(
        [r - st.r[:, None], th - st.eul[:, None], v - st.v[:, None], w - st.omega[:, None],
         (p - st.feet[:, None]).reshape(lead + (12,))], dim=-1) * m0[:, None]
    J_init = (m0[:, None, None] * torch.eye(24, NV, dtype=dt_, device=dev)).expand(lead + (24, NV))

    # 9. goal (last knot)
    mG = aux.is_last * W.goal
    res_goal = torch.cat(
        [r - spec.goal_r[:, None], th[..., 2:] - spec.goal_yaw[:, None, None], v * 0.5, w * 0.5],
        dim=-1) * mG[:, None]
    J_goal = (mG[:, None, None] * _goal_pattern(x)).expand(lead + (10, NV))

    res = torch.cat([res_terr, res_clear, res_nopen, res_fzero, res_fric, res_rom, res_post, res_slope,
                     res_body, res_init, res_goal], dim=-1)
    J = torch.cat([J_terr, J_clear, J_nopen, J_fzero, J_fric, J_rom, J_post, J_slope, J_body, J_init,
                   J_goal], dim=-2)
    return res, J


def _hcat(lead, *blocks):
    """Blocks (..., rows, c_i), each broadcast to the leading axes, side by
    side."""
    rows = max(b.shape[-2] for b in blocks)
    return torch.cat([b.expand(lead + (rows, b.shape[-1])) for b in blocks], dim=-1)


def interval_system(xa, xb, ca, cb, spec: ProblemSpec, cfg: SolverConfig):
    """Interval residuals and their Jacobians for knot pairs (k, k+1):
    xa/xb (..., NV), ca/cb (..., 4) -> rho (..., m2), Ja and Jb (..., m2, NV)
    (Ja with respect to x_k, Jb to x_{k+1}), rows in `qtos_tpu`'s order
    (dynamics r, th, v, w; stationarity; foot velocity; accelerations; force
    rate)."""
    W = cfg.weights
    dt = spec.dt
    sa, sb = unpack_state(xa), unpack_state(xb)
    r0, th0, v0, w0, p0, f0 = sa["r"], sa["th"], sa["v"], sa["w"], sa["p"], sa["f"]
    r1, th1, v1, w1, p1, f1 = sb["r"], sb["th"], sb["v"], sb["w"], sb["p"], sb["f"]
    lead = xa.shape[:-1]
    dt_, dev = xa.dtype, xa.device
    I3 = torch.eye(3, dtype=dt_, device=dev)
    Z = lambda r_, c_: torch.zeros((r_, c_), dtype=dt_, device=dev)   # noqa: E731
    hcat = lambda *b: _hcat(lead, *b)                                  # noqa: E731

    # rows 0:3 dyn_r
    res_r = (r1 - r0 - 0.5 * dt * (v0 + v1)) * W.dyn_r
    vcoef = -0.5 * dt * W.dyn_r * I3
    Ja_r = hcat(-I3 * W.dyn_r, Z(3, 3), vcoef, Z(3, 27))
    Jb_r = hcat(I3 * W.dyn_r, Z(3, 3), vcoef, Z(3, 27))

    # rows 3:6 dyn_th; rate = C^-1(th) w
    rate0 = omega_to_euler_rate(th0, w0)
    rate1 = omega_to_euler_rate(th1, w1)
    res_th = (th1 - th0 - 0.5 * dt * (rate0 + rate1)) * W.dyn_th
    Ja_th = hcat(Z(3, 3), (-I3 - 0.5 * dt * euler_rate_jac(th0, w0)) * W.dyn_th, Z(3, 3),
                 -0.5 * dt * euler_rate_matrix_inv(th0) * W.dyn_th, Z(3, 24))
    Jb_th = hcat(Z(3, 3), (I3 - 0.5 * dt * euler_rate_jac(th1, w1)) * W.dyn_th, Z(3, 3),
                 -0.5 * dt * euler_rate_matrix_inv(th1) * W.dyn_th, Z(3, 24))

    # rows 6:9 dyn_v
    grav = torch.tensor([0.0, 0.0, GRAVITY_Z], dtype=dt_, device=dev)
    a_lin0 = f0.sum(-2) / Solo12.mass + grav
    a_lin1 = f1.sum(-2) / Solo12.mass + grav
    res_v = (v1 - v0 - 0.5 * dt * (a_lin0 + a_lin1)) * W.dyn_v
    fblk = (-0.5 * dt * FORCE_SCALE / Solo12.mass * W.dyn_v * I3).repeat(1, 4)
    Ja_v = hcat(Z(3, 6), -I3 * W.dyn_v, Z(3, 15), fblk)
    Jb_v = hcat(Z(3, 6), I3 * W.dyn_v, Z(3, 15), fblk)

    # rows 9:12 dyn_w
    wd0, dwr0, dwth0, dwp0, dwf0, dww0 = wdot_and_derivs(r0, th0, w0, p0, f0)
    wd1, dwr1, dwth1, dwp1, dwf1, dww1 = wdot_and_derivs(r1, th1, w1, p1, f1)
    res_w = (w1 - w0 - 0.5 * dt * (wd0 + wd1)) * W.dyn_w
    k = -0.5 * dt * W.dyn_w

    def feet_cols(blocks):
        """(..., 4, 3, 3) foot blocks -> (..., 3, 12)."""
        return blocks.transpose(-3, -2).reshape(blocks.shape[:-3] + (3, 12))

    Ja_w = hcat(k * dwr0, k * dwth0, Z(3, 3), -I3 * W.dyn_w + k * dww0, k * feet_cols(dwp0),
                k * FORCE_SCALE * feet_cols(dwf0))
    Jb_w = hcat(k * dwr1, k * dwth1, Z(3, 3), I3 * W.dyn_w + k * dww1, k * feet_cols(dwp1),
                k * FORCE_SCALE * feet_cols(dwf1))

    # rows 12:24 stationarity, 24:36 foot velocity
    both = ca * cb
    res_stat = ((p1 - p0) * both[..., None]).reshape(lead + (12,)) * W.stat
    res_fv = ((p1 - p0) * (1.0 - both[..., None])).reshape(lead + (12,)) * W.footvel_reg
    bmask = both.repeat_interleave(3, dim=-1)
    Ja_stat = hcat(Z(12, 12), torch.diag_embed(-bmask * W.stat), Z(12, 12))
    Jb_stat = hcat(Z(12, 12), torch.diag_embed(bmask * W.stat), Z(12, 12))
    Ja_fv = hcat(Z(12, 12), torch.diag_embed(-(1.0 - bmask) * W.footvel_reg), Z(12, 12))
    Jb_fv = hcat(Z(12, 12), torch.diag_embed((1.0 - bmask) * W.footvel_reg), Z(12, 12))

    # rows 36:42 acceleration regularizer, 42:54 force rate
    res_acc = torch.cat([(v1 - v0) * W.acc_reg, (w1 - w0) * W.acc_reg], dim=-1)
    res_fr = ((f1 - f0) / FORCE_SCALE).reshape(lead + (12,)) * W.f_reg
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    eye12 = torch.eye(12, dtype=dt_, device=dev)
    Ja_acc = hcat(Z(6, 6), -W.acc_reg * eye6, Z(6, 24))
    Jb_acc = hcat(Z(6, 6), W.acc_reg * eye6, Z(6, 24))
    Ja_fr = hcat(Z(12, 24), -W.f_reg * eye12)
    Jb_fr = hcat(Z(12, 24), W.f_reg * eye12)

    res = torch.cat([res_r, res_th, res_v, res_w, res_stat, res_fv, res_acc, res_fr], dim=-1)
    Ja = torch.cat([Ja_r, Ja_th, Ja_v, Ja_w, Ja_stat, Ja_fv, Ja_acc, Ja_fr], dim=-2)
    Jb = torch.cat([Jb_r, Jb_th, Jb_v, Jb_w, Jb_stat, Jb_fv, Jb_acc, Jb_fr], dim=-2)
    return res, Ja, Jb
