"""Residual transcription of the gait NLP on a uniform knot grid (port of
`qtos_tpu.solver.transcription`).

Every function here takes a batch: a trajectory is (B, K, NV) and the spec's
tensors carry the same leading B.  Where `qtos_tpu` maps a per-knot function
with `jax.vmap`, the batch and knot axes are written out.

Every residual couples at most knots (k, k+1), so the Gauss-Newton normal
equations assemble into the block-tridiagonal system solved by
`qtos_torch.ops.btd`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from qtos_torch.device import constant
from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops.rotations import euler_to_rot, omega_to_euler_rate
from qtos_torch.solver.spec import (
    FORCE_SCALE,
    ProblemSpec,
    SolverConfig,
    pack_state,
    unpack_state,
)
from qtos_torch.terrain.heightfield import Terrain, height_at, slope_at

GRAVITY_Z = -9.81


@dataclasses.dataclass(frozen=True)
class KnotAux:
    """Per-knot data derived from the spec (see `qtos_tpu`'s KnotAux for why
    each boundary accommodation exists)."""

    contact: torch.Tensor        # (B, K, 4)
    swing_prog: torch.Tensor     # (B, K, 4)
    is_first: torch.Tensor       # (K,)
    is_last: torch.Tensor        # (K,)
    # start-state hover above the surface, held while a foot's first stance lasts
    terr_slack: torch.Tensor     # (B, K, 4)
    # start-state out-of-box RoM overshoot, held during each foot's first stance
    box_widen: torch.Tensor      # (B, K, 4, 3)
    # 1.0 while the foot is still in its first stance phase
    first_stance: torch.Tensor   # (B, K, 4)


def knot_aux(spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig) -> KnotAux:
    """Counterpart of `qtos_tpu.solver.solve._aux` for a batched spec."""
    K = spec.num_knots
    st = spec.start
    dev = st.r.device
    idx = torch.arange(K, device=dev)
    R0 = euler_to_rot(st.eul)                                          # (B, 3, 3)
    nominal = Solo12.tensors(dev).nominal_feet
    d0 = torch.einsum("bji,bkj->bki", R0, st.feet - st.r[:, None, :]) - nominal
    rom_box = constant(cfg.rom_box, st.r.dtype, dev)
    over = torch.clamp(torch.abs(d0) - rom_box, min=0.0)               # (B, 4, 3)
    h0 = height_at(terrain, st.feet[..., 0], st.feet[..., 1])
    hover0 = torch.clamp(st.feet[..., 2] - h0, min=0.0)                # (B, 4)
    contact = spec.schedule.contact
    first_stance = torch.cumprod(contact, dim=1)                       # (B, K, 4)
    return KnotAux(
        contact=contact,
        swing_prog=spec.schedule.swing_progress,
        is_first=(idx == 0).to(torch.float32),
        is_last=(idx == K - 1).to(torch.float32),
        terr_slack=first_stance * hover0[:, None, :],
        box_widen=first_stance[..., None] * over[:, None, :, :],
        first_stance=first_stance,
    )


def srb_accels(r, th, w, f_feet, p_feet):
    """Single-rigid-body accelerations (world frame); broadcasts over leading
    dims: r/th/w (..., 3), f_feet/p_feet (..., 4, 3)."""
    a_lin = f_feet.sum(-2) / Solo12.mass
    a_lin = torch.cat([a_lin[..., :2], a_lin[..., 2:] + GRAVITY_Z], -1)
    consts = Solo12.tensors(r.device)
    R = euler_to_rot(th)
    RT = R.transpose(-1, -2)
    I_w = R @ consts.inertia @ RT
    tau = torch.cross(p_feet - r[..., None, :], f_feet, dim=-1).sum(-2)
    # I_w^-1 = R I^-1 R^T exactly (diagonal body inertia)
    I_w_inv = R @ consts.inertia_inv @ RT
    Iw_w = (I_w @ w[..., None])[..., 0]
    w_dot = (I_w_inv @ (tau - torch.cross(w, Iw_w, dim=-1))[..., None])[..., 0]
    return a_lin, w_dot


def _bk(t):
    """Per-scenario (B, ...) tensor -> broadcastable against (B, K, ...)."""
    return t.unsqueeze(1)


def knot_residuals(x, aux: KnotAux, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig):
    """Residuals involving a single knot: x (B, K, NV) -> (B, K, m1)."""
    W = cfg.weights
    s = unpack_state(x)
    r, th, v, w, p, f = s["r"], s["th"], s["v"], s["w"], s["p"], s["f"]
    c = aux.contact
    swing = 1.0 - c
    fs = f / FORCE_SCALE
    lead = x.shape[:-1]

    h = height_at(terrain, p[..., 0], p[..., 1])
    res_terr = (p[..., 2] - h - aux.terr_slack) * c * W.terr

    bell = torch.sin(math.pi * aux.swing_prog)
    res_clear = (p[..., 2] - (h + cfg.swing_clearance * bell)) * swing * W.clear
    res_nopen = torch.clamp(h - 0.005 - p[..., 2], min=0.0) * swing * W.terr

    res_fzero = (fs * swing[..., None]).reshape(lead + (12,)) * W.fzero

    mu_t = cfg.mu_friction / math.sqrt(2.0)
    fx, fy, fz = fs[..., 0], fs[..., 1], fs[..., 2]
    fzN = fz * FORCE_SCALE
    res_fric = torch.stack(
        [
            torch.clamp(fx - mu_t * fz, min=0.0),
            torch.clamp(-fx - mu_t * fz, min=0.0),
            torch.clamp(fy - mu_t * fz, min=0.0),
            torch.clamp(-fy - mu_t * fz, min=0.0),
            torch.clamp(-fz, min=0.0) * 2.0,
            torch.clamp((fzN - cfg.f_max) / FORCE_SCALE, min=0.0),
        ],
        dim=-1,
    ) * c[..., None] * W.fric

    R = euler_to_rot(th)
    p_base = torch.einsum("...ji,...kj->...ki", R, p - r[..., None, :])
    d = p_base - Solo12.tensors(x.device).nominal_feet
    box = constant(cfg.rom_box, x.dtype, x.device) + aux.box_widen
    res_rom = torch.cat(
        [torch.clamp(d - box, min=0.0), torch.clamp(-d - box, min=0.0)], dim=-1
    ).reshape(lead + (24,)) * W.rom

    res_post = d.reshape(lead + (12,)) * W.post_reg

    sl = slope_at(terrain, p[..., 0], p[..., 1], cfg.slope_probe_d)
    res_slope = (torch.clamp(sl - cfg.slope_margin, min=0.0)
                 * c * (1.0 - aux.first_stance) * W.slope)

    h_body = height_at(terrain, r[..., 0], r[..., 1])
    res_body = torch.clamp(h_body + cfg.body_clearance - r[..., 2], min=0.0)[..., None] * W.body

    st = spec.start
    res_init = (
        torch.cat(
            [
                r - _bk(st.r),
                th - _bk(st.eul),
                v - _bk(st.v),
                w - _bk(st.omega),
                (p - _bk(st.feet)).reshape(lead + (12,)),
            ],
            dim=-1,
        )
        * aux.is_first[:, None]
        * W.init
    )
    res_goal = (
        torch.cat(
            [
                r - _bk(spec.goal_r),
                th[..., 2:] - spec.goal_yaw[:, None, None],
                v * 0.5,
                w * 0.5,
            ],
            dim=-1,
        )
        * aux.is_last[:, None]
        * W.goal
    )

    return torch.cat(
        [
            res_terr,
            res_clear,
            res_nopen,
            res_fzero,
            res_fric.reshape(lead + (24,)),
            res_rom,
            res_post,
            res_slope,
            res_body,
            res_init,
            res_goal,
        ],
        dim=-1,
    )


def interval_residuals(xa, xb, ca, cb, spec: ProblemSpec, cfg: SolverConfig):
    """Residuals coupling knots (k, k+1): xa/xb (..., NV), ca/cb (..., 4)
    -> (..., m2)."""
    W = cfg.weights
    dt = spec.dt
    sa, sb = unpack_state(xa), unpack_state(xb)
    r0, th0, v0, w0, p0, f0 = sa["r"], sa["th"], sa["v"], sa["w"], sa["p"], sa["f"]
    r1, th1, v1, w1, p1, f1 = sb["r"], sb["th"], sb["v"], sb["w"], sb["p"], sb["f"]
    lead = xa.shape[:-1]

    a0, wd0 = srb_accels(r0, th0, w0, f0, p0)
    a1, wd1 = srb_accels(r1, th1, w1, f1, p1)
    rate0 = omega_to_euler_rate(th0, w0)
    rate1 = omega_to_euler_rate(th1, w1)

    res_dyn = torch.cat(
        [
            (r1 - r0 - 0.5 * dt * (v0 + v1)) * W.dyn_r,
            (th1 - th0 - 0.5 * dt * (rate0 + rate1)) * W.dyn_th,
            (v1 - v0 - 0.5 * dt * (a0 + a1)) * W.dyn_v,
            (w1 - w0 - 0.5 * dt * (wd0 + wd1)) * W.dyn_w,
        ],
        dim=-1,
    )

    both = ca * cb
    res_stat = ((p1 - p0) * both[..., None]).reshape(lead + (12,)) * W.stat
    res_footvel = ((p1 - p0) * (1.0 - both[..., None])).reshape(lead + (12,)) * W.footvel_reg

    res_acc = torch.cat([(v1 - v0) * W.acc_reg, (w1 - w0) * W.acc_reg], dim=-1)
    res_frate = ((f1 - f0) / FORCE_SCALE).reshape(lead + (12,)) * W.f_reg

    return torch.cat([res_dyn, res_stat, res_footvel, res_acc, res_frate], dim=-1)


# ---------------------------------------------------------------------------
# Physical-violation metrics (unweighted, for convergence status)
# ---------------------------------------------------------------------------

def violations(x, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig):
    """Max physical constraint violations of candidate trajectories
    x (B, K, NV).  Returns a dict of (B,) tensors."""
    s = unpack_state(x)
    r, th, v, w, p, f = s["r"], s["th"], s["v"], s["w"], s["p"], s["f"]
    dt = spec.dt
    c = spec.schedule.contact

    a, wd = srb_accels(r, th, w, f, p)
    rate = omega_to_euler_rate(th, w)
    d_r = r[:, 1:] - r[:, :-1] - 0.5 * dt * (v[:, 1:] + v[:, :-1])
    d_th = th[:, 1:] - th[:, :-1] - 0.5 * dt * (rate[:, 1:] + rate[:, :-1])
    d_v = v[:, 1:] - v[:, :-1] - 0.5 * dt * (a[:, 1:] + a[:, :-1])
    d_w = w[:, 1:] - w[:, :-1] - 0.5 * dt * (wd[:, 1:] + wd[:, :-1])

    both = c[:, 1:] * c[:, :-1]
    stat = torch.abs(p[:, 1:] - p[:, :-1]) * both[..., None]

    h = height_at(terrain, p[..., 0], p[..., 1])
    st = spec.start
    h0 = height_at(terrain, st.feet[..., 0], st.feet[..., 1])
    hover0 = torch.clamp(st.feet[..., 2] - h0, min=0.0)
    slack = torch.cumprod(c, dim=1) * hover0[:, None, :]
    terr = torch.abs(p[..., 2] - h - slack) * c

    mu_t = cfg.mu_friction / math.sqrt(2.0)
    fric = torch.clamp(
        torch.maximum(torch.abs(f[..., 0]), torch.abs(f[..., 1])) - mu_t * f[..., 2], min=0.0
    ) * c
    funi = torch.clamp(-f[..., 2], min=0.0) * c
    fswing = torch.abs(f) * (1.0 - c[..., None])

    h_body = height_at(terrain, r[..., 0], r[..., 1])
    body = torch.clamp(h_body + cfg.body_clearance - r[..., 2], min=0.0)

    init = torch.cat(
        [
            torch.abs(r[:, 0] - st.r),
            torch.abs(th[:, 0] - st.eul),
            torch.abs(v[:, 0] - st.v),
            torch.abs(w[:, 0] - st.omega),
            torch.abs(p[:, 0] - st.feet).flatten(1),
        ],
        dim=-1,
    ).amax(-1)
    goal = torch.abs(r[:, -1] - spec.goal_r).amax(-1)

    def bmax(t):
        return t.flatten(1).amax(-1)

    dyn = torch.cat(
        [torch.abs(d_r), torch.abs(d_th), torch.abs(d_v) * 0.1, torch.abs(d_w) * 0.1], dim=-1
    )
    return dict(
        dynamics=bmax(dyn),
        stationarity=bmax(stat),
        terrain=bmax(terr),
        friction=bmax(fric) + bmax(funi),
        swing_force=bmax(fswing),
        body=bmax(body),
        init=init,
        goal=goal,
    )


def max_violation(viol: dict) -> torch.Tensor:
    """Max over the violation families (keys in sorted order, as `qtos_tpu`)."""
    return torch.stack([viol[k] for k in sorted(viol)], -1).amax(-1)


# ---------------------------------------------------------------------------
# Initial guess
# ---------------------------------------------------------------------------

def initial_guess(spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig) -> torch.Tensor:
    """Schedule-aware warm start (B, K, NV): linear base interpolation,
    nominal feet under the base held during stance, gravity-balancing
    vertical forces."""
    K = spec.num_knots
    c = spec.schedule.contact
    swing = spec.schedule.swing_progress
    st = spec.start
    dev = st.r.device
    B = st.r.shape[0]

    tau = torch.linspace(0.0, 1.0, K, device=dev)[:, None]
    motion_phase = torch.clamp((tau - 0.08) / 0.84, 0.0, 1.0)         # (K, 1)
    r = _bk(st.r) + _bk(spec.goal_r - st.r) * motion_phase[None]
    hz = height_at(terrain, r[..., 0], r[..., 1])
    r = torch.cat(
        [r[..., :2], torch.maximum(r[..., 2], hz + Solo12.stand_height - 0.02)[..., None]], -1
    )
    yaw = st.eul[:, 2:3] + (spec.goal_yaw - st.eul[:, 2])[:, None] * motion_phase[None, :, 0]
    zK = torch.zeros_like(yaw)
    th = torch.stack([zK, zK, yaw], dim=-1)
    v = torch.gradient(r, dim=1)[0] / spec.dt
    w = torch.zeros((B, K, 3), device=dev)

    cy, sy = torch.cos(yaw), torch.sin(yaw)
    nom = Solo12.tensors(dev).nominal_feet[:, :2]
    nx = cy[..., None] * nom[:, 0] - sy[..., None] * nom[:, 1]          # (B, K, 4)
    ny = sy[..., None] * nom[:, 0] + cy[..., None] * nom[:, 1]
    px = r[..., 0:1] + nx
    py = r[..., 1:2] + ny
    ph = height_at(terrain, px, py)
    pz = ph + cfg.swing_clearance * torch.sin(math.pi * swing) * (1.0 - c)
    p = torch.stack([px, py, pz], dim=-1)
    p[:, 0] = st.feet

    n_contact = torch.clamp(c.sum(-1, keepdim=True), min=1.0)
    fz = Solo12.mass * 9.81 / n_contact * c
    f = torch.cat([torch.zeros((B, K, 4, 2), device=dev), fz[..., None]], dim=-1)

    return pack_state(r, th, v, w, p, f)
