"""Gauss-Newton normal equations assembled directly in block space, one
residual family at a time, over any leading (B, K) axes (port of
`qtos_tpu.solver.normal_eq`).

Every residual family touches only a few of the twelve 3-wide column groups
[r, th, v, w, p0..p3, f0..f3] of the 36-wide knot state, so D = J^T J,
g = J^T rho and the sub-diagonal block L assemble from closed-form (3, 3)
contributions without a dense per-knot Jacobian; `qtos_torch.solver.
jacobians` is the dense derivation they are held against in the tests.
`qtos_torch.solver.assemble.assemble` sums these into the block-tridiagonal
system of a batch.
"""

from __future__ import annotations

import math

import torch

from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops.rotations import euler_rate_matrix_inv, omega_to_euler_rate
from qtos_torch.solver.jacobians import euler_rate_jac, rot_derivs, wdot_and_derivs
from qtos_torch.solver.spec import FORCE_SCALE, IDX_F, ProblemSpec, SolverConfig, unpack_state
from qtos_torch.solver.transcription import GRAVITY_Z, KnotAux
from qtos_torch.terrain.heightfield import Terrain, grad_at, height_at, slope_terrain

_G_R, _G_TH, _G_V, _G_W = 0, 1, 2, 3  # block-group ids; p_i = 4+i, f_i = 8+i


class _BlockGrid:
    """12x12 grid of (..., 3, 3) blocks, emitted as one two-level cat."""

    def __init__(self, lead, like):
        self.blocks = {}
        self.lead = tuple(lead)
        self.zero = torch.zeros((), dtype=like.dtype, device=like.device)

    def add(self, gi, gj, blk):
        key = (gi, gj)
        self.blocks[key] = blk if key not in self.blocks else self.blocks[key] + blk

    def add_sym(self, gi, gj, blk):
        """Add blk at (gi, gj) and blk^T at (gj, gi)."""
        self.add(gi, gj, blk)
        self.add(gj, gi, blk.transpose(-1, -2))

    def to_mat(self):
        shape = self.lead + (3, 3)

        def get(gi, gj):
            return self.blocks.get((gi, gj), self.zero).expand(shape)

        rows = [torch.cat([get(gi, gj) for gj in range(12)], dim=-1) for gi in range(12)]
        return torch.cat(rows, dim=-2)


class _BlockVec:
    """12-entry vector of (..., 3) blocks, emitted as one cat."""

    def __init__(self, lead, like):
        self.blocks = {}
        self.lead = tuple(lead)
        self.zero = torch.zeros((), dtype=like.dtype, device=like.device)

    def add(self, gi, blk):
        self.blocks[gi] = blk if gi not in self.blocks else self.blocks[gi] + blk

    def to_vec(self):
        shape = self.lead + (3,)
        return torch.cat([self.blocks.get(gi, self.zero).expand(shape) for gi in range(12)], dim=-1)


def _sq(t, nd=1):
    """Sum of squares over the last `nd` dims."""
    return (t * t).sum(dim=tuple(range(-nd, 0)))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def knot_normal(x, aux: KnotAux, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig,
                slope: Terrain | None = None):
    """Knot-family normal equations: x (B, K, NV) -> D (B, K, NV, NV),
    g (B, K, NV), sq (B, K).  `slope` is `slope_terrain(terrain,
    cfg.slope_probe_d)`, built here when not given."""
    W = cfg.weights
    s = unpack_state(x)
    r, th, v, w, p = s["r"], s["th"], s["v"], s["w"], s["p"]
    lead = x.shape[:-1]
    c = aux.contact
    swing = 1.0 - c
    fs = x[..., IDX_F].reshape(lead + (4, 3))
    dt_ = x.dtype
    dev = x.device
    I3 = _eye3(x)

    G = _BlockGrid(lead, x)
    gv = _BlockVec(lead, x)

    h = height_at(terrain, p[..., 0], p[..., 1])
    hx, hy = grad_at(terrain, p[..., 0], p[..., 1])
    a_dir = torch.stack([-hx, -hy, torch.ones_like(hx)], dim=-1)       # (..., 4, 3)

    # --- terrain / clearance / no-penetration: share direction a_dir on p_i --
    mT = c * W.terr
    res_terr = (p[..., 2] - h - aux.terr_slack) * mT
    bell = torch.sin(math.pi * aux.swing_prog)
    mC = swing * W.clear
    res_clear = (p[..., 2] - (h + cfg.swing_clearance * bell)) * mC
    gpen = h - 0.005 - p[..., 2]
    mN = (gpen > 0.0).to(dt_) * swing * W.terr
    res_nopen = torch.clamp(gpen, min=0.0) * swing * W.terr

    A = a_dir[..., :, None] * a_dir[..., None, :]                       # (..., 4, 3, 3)
    coef_p = mT**2 + mC**2 + mN**2
    gcoef_p = mT * res_terr + mC * res_clear - mN * res_nopen
    sq = _sq(res_terr) + _sq(res_clear) + _sq(res_nopen)

    # --- swing force zero + friction pyramid: f_i diagonal blocks ----------
    mF = swing * W.fzero
    res_fzero = fs * mF[..., None]
    sq = sq + _sq(res_fzero, 2)

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
    res_fric = fr * (c * W.fric)[..., None]                             # (..., 4, 6)
    sq = sq + _sq(res_fric, 2)
    base_rows = torch.tensor(
        [
            [1.0, 0.0, -mu_t],
            [-1.0, 0.0, -mu_t],
            [0.0, 1.0, -mu_t],
            [0.0, -1.0, -mu_t],
            [0.0, 0.0, -2.0],
            [0.0, 0.0, 1.0],
        ],
        dtype=dt_,
        device=dev,
    )
    fvals = ((fr > 0.0).to(dt_) * (c * W.fric)[..., None])[..., None] * base_rows
    FtF = fvals.transpose(-1, -2) @ fvals                               # (..., 4, 3, 3)
    gfr = (fvals * res_fric[..., None]).sum(-2)                         # (..., 4, 3)

    # --- RoM hinges + posture: rank-1 directions over (r, th, p_i) ---------
    R, dR = rot_derivs(th)
    pr = p - r[..., None, :]
    d = torch.einsum("...ji,...kj->...ki", R, pr) - Solo12.tensors(dev).nominal_feet
    box = torch.tensor(cfg.rom_box, dtype=dt_, device=dev) + aux.box_widen
    hi = torch.clamp(d - box, min=0.0) * W.rom
    lo = torch.clamp(-d - box, min=0.0) * W.rom
    res_post = d * W.post_reg
    sq = sq + _sq(hi, 2) + _sq(lo, 2) + _sq(res_post, 2)

    dd_dth = torch.einsum("...jam,...ka->...kmj", dR, pr)              # (..., 4, m, 3)
    act_hi = (d - box > 0).to(dt_) * W.rom
    act_lo = (-d - box > 0).to(dt_) * W.rom
    coef_rom = act_hi**2 + act_lo**2 + W.post_reg**2                    # (..., 4, m)
    gc = act_hi * hi - act_lo * lo + W.post_reg * res_post              # (..., 4, m)

    RR = torch.einsum("...im,...am,...bm->...iab", coef_rom, R, R)     # (..., 4, 3, 3)
    RT = torch.einsum("...im,...am,...imb->...iab", coef_rom, R, dd_dth)
    TT = torch.einsum("...im,...ima,...imb->...ab", coef_rom, dd_dth, dd_dth)
    TP = torch.einsum("...im,...ima,...bm->...iab", coef_rom, dd_dth, R)

    G.add(_G_R, _G_R, RR.sum(-3))
    G.add_sym(_G_R, _G_TH, -RT.sum(-3))
    G.add(_G_TH, _G_TH, TT)
    gv.add(_G_R, -torch.einsum("...im,...am->...a", gc, R))
    gv.add(_G_TH, torch.einsum("...im,...ima->...a", gc, dd_dth))
    g_p_rom = torch.einsum("...im,...am->...ia", gc, R)                # (..., 4, 3)

    # --- foothold slope hinge: rank-1 on each p_i (xy only) ----------------
    if slope is None:
        slope = slope_terrain(terrain, cfg.slope_probe_d)
    sl = height_at(slope, p[..., 0], p[..., 1])                        # slope_grad_at's lookups
    slx, sly = grad_at(slope, p[..., 0], p[..., 1])
    w_sl = c * (1.0 - aux.first_stance) * W.slope
    m_sl = (sl - cfg.slope_margin > 0.0).to(dt_) * w_sl
    res_sl = torch.clamp(sl - cfg.slope_margin, min=0.0) * w_sl
    u_sl = torch.stack([slx, sly, torch.zeros_like(slx)], dim=-1)      # (..., 4, 3)
    S_blk = (m_sl**2)[..., None, None] * (u_sl[..., :, None] * u_sl[..., None, :])
    g_sl = (m_sl * res_sl)[..., None] * u_sl
    sq = sq + _sq(res_sl)

    for i in range(4):
        G.add(4 + i, 4 + i, coef_p[..., i, None, None] * A[..., i, :, :] + RR[..., i, :, :]
              + S_blk[..., i, :, :])
        G.add_sym(_G_R, 4 + i, -RR[..., i, :, :])
        G.add_sym(_G_TH, 4 + i, TP[..., i, :, :])
        gv.add(4 + i, gcoef_p[..., i, None] * a_dir[..., i, :] + g_p_rom[..., i, :]
               + g_sl[..., i, :])
        G.add(8 + i, 8 + i, (mF[..., i] ** 2)[..., None, None] * I3 + FtF[..., i, :, :])
        gv.add(8 + i, mF[..., i, None] * res_fzero[..., i, :] + gfr[..., i, :])

    # --- base clearance hinge: rank-1 on the r group -----------------------
    hb = height_at(terrain, r[..., 0], r[..., 1])
    hbx, hby = grad_at(terrain, r[..., 0], r[..., 1])
    gb = hb + cfg.body_clearance - r[..., 2]
    act_b = (gb > 0.0).to(dt_) * W.body
    res_b = torch.clamp(gb, min=0.0) * W.body
    u_b = torch.stack([hbx, hby, -torch.ones_like(hbx)], dim=-1)       # (..., 3)
    G.add(_G_R, _G_R, (act_b**2)[..., None, None] * (u_b[..., :, None] * u_b[..., None, :]))
    gv.add(_G_R, (act_b * res_b)[..., None] * u_b)
    sq = sq + res_b * res_b

    # --- init (first knot): diagonal on first 8 groups ---------------------
    st = spec.start
    m0 = (aux.is_first * W.init)[:, None]                               # (K, 1)
    init_blocks = [
        r - st.r[:, None],
        th - st.eul[:, None],
        v - st.v[:, None],
        w - st.omega[:, None],
    ] + [p[..., i, :] - st.feet[:, None, i, :] for i in range(4)]
    for gi, blk in enumerate(init_blocks):
        G.add(gi, gi, (m0**2)[..., None] * I3)
        gv.add(gi, m0**2 * blk)
        sq = sq + _sq(m0 * blk)

    # --- goal (last knot) ---------------------------------------------------
    mG = (aux.is_last * W.goal)[:, None]                                # (K, 1)
    mG2 = (mG**2)[..., None]                                            # (K, 1, 1)
    ez = torch.zeros(3, dtype=dt_, device=dev)
    ez[2] = 1.0
    G.add(_G_R, _G_R, mG2 * I3)
    G.add(_G_TH, _G_TH, mG2 * (ez[:, None] * ez[None, :]))
    G.add(_G_V, _G_V, 0.25 * mG2 * I3)
    G.add(_G_W, _G_W, 0.25 * mG2 * I3)
    dgr = r - spec.goal_r[:, None]
    dyaw = th[..., 2] - spec.goal_yaw[:, None]                          # (B, K)
    gv.add(_G_R, mG**2 * dgr)
    gv.add(_G_TH, mG**2 * dyaw[..., None] * ez)
    gv.add(_G_V, 0.25 * mG**2 * v)
    gv.add(_G_W, 0.25 * mG**2 * w)
    sq = sq + _sq(mG * dgr) + (mG[:, 0] * dyaw) ** 2
    sq = sq + _sq(0.5 * mG * v) + _sq(0.5 * mG * w)

    return G.to_mat(), gv.to_vec(), sq


def interval_normal(xa, xb, ca, cb, spec: ProblemSpec, cfg: SolverConfig):
    """Interval-family normal equations for knot pairs (k, k+1).

    xa/xb (..., NV), ca/cb (..., 4).  Returns (Daa, Dbb, Lba, ga, gb, sq):
    Daa = Ja^T Ja (adds to D_k), Dbb = Jb^T Jb (adds to D_{k+1}),
    Lba = Jb^T Ja (the (k+1, k) block), ga = Ja^T rho, gb = Jb^T rho,
    sq = sum(rho^2) over the interval's rows."""
    W = cfg.weights
    dt = spec.dt
    sa, sb = unpack_state(xa), unpack_state(xb)
    r0, th0, v0, w0, p0, f0 = sa["r"], sa["th"], sa["v"], sa["w"], sa["p"], sa["f"]
    r1, th1, v1, w1, p1, f1 = sb["r"], sb["th"], sb["v"], sb["w"], sb["p"], sb["f"]
    lead = xa.shape[:-1]
    dt_ = xa.dtype
    I3 = _eye3(xa)
    zero = torch.zeros((), dtype=dt_, device=xa.device)

    def _rowmat(blocks):
        """dict {group: (..., 3, 3)} -> (..., 3, 36) block-row."""
        shape = lead + (3, 3)
        return torch.cat([blocks.get(gi, zero).expand(shape) for gi in range(12)], dim=-1)

    # dyn_r
    res_dr = (r1 - r0 - 0.5 * dt * (v0 + v1)) * W.dyn_r
    vblk = -0.5 * dt * W.dyn_r * I3
    Wa_r = _rowmat({_G_R: -W.dyn_r * I3, _G_V: vblk})
    Wb_r = _rowmat({_G_R: W.dyn_r * I3, _G_V: vblk})

    # dyn_th
    rate0 = omega_to_euler_rate(th0, w0)
    rate1 = omega_to_euler_rate(th1, w1)
    res_dth = (th1 - th0 - 0.5 * dt * (rate0 + rate1)) * W.dyn_th
    drate0 = euler_rate_jac(th0, w0)
    drate1 = euler_rate_jac(th1, w1)
    Wa_th = _rowmat(
        {
            _G_TH: (-I3 - 0.5 * dt * drate0) * W.dyn_th,
            _G_W: -0.5 * dt * euler_rate_matrix_inv(th0) * W.dyn_th,
        }
    )
    Wb_th = _rowmat(
        {
            _G_TH: (I3 - 0.5 * dt * drate1) * W.dyn_th,
            _G_W: -0.5 * dt * euler_rate_matrix_inv(th1) * W.dyn_th,
        }
    )

    # dyn_v
    a0 = f0.sum(-2) / Solo12.mass
    a1 = f1.sum(-2) / Solo12.mass
    a0 = torch.cat([a0[..., :2], a0[..., 2:] + GRAVITY_Z], -1)
    a1 = torch.cat([a1[..., :2], a1[..., 2:] + GRAVITY_Z], -1)
    res_dv = (v1 - v0 - 0.5 * dt * (a0 + a1)) * W.dyn_v
    fcoef = -0.5 * dt * FORCE_SCALE / Solo12.mass * W.dyn_v
    fblocks = {8 + i: fcoef * I3 for i in range(4)}
    Wa_v = _rowmat({_G_V: -W.dyn_v * I3, **fblocks})
    Wb_v = _rowmat({_G_V: W.dyn_v * I3, **fblocks})

    # dyn_w
    wd0, dwr0, dwth0, dwp0, dwf0, dww0 = wdot_and_derivs(r0, th0, w0, p0, f0)
    wd1, dwr1, dwth1, dwp1, dwf1, dww1 = wdot_and_derivs(r1, th1, w1, p1, f1)
    res_dw = (w1 - w0 - 0.5 * dt * (wd0 + wd1)) * W.dyn_w
    k = -0.5 * dt * W.dyn_w

    def _w_rowmat(dwr, dwth, dww, dwp, dwf, sgn):
        blocks = {
            _G_R: k * dwr,
            _G_TH: k * dwth,
            _G_W: sgn * W.dyn_w * I3 + k * dww,
        }
        for i in range(4):
            blocks[4 + i] = k * dwp[..., i, :, :]
            blocks[8 + i] = k * FORCE_SCALE * dwf[..., i, :, :]
        return _rowmat(blocks)

    Wa_w = _w_rowmat(dwr0, dwth0, dww0, dwp0, dwf0, -1.0)
    Wb_w = _w_rowmat(dwr1, dwth1, dww1, dwp1, dwf1, 1.0)

    Wa = torch.cat([Wa_r, Wa_th, Wa_v, Wa_w], dim=-2)                  # (..., 12, 36)
    Wb = torch.cat([Wb_r, Wb_th, Wb_v, Wb_w], dim=-2)
    res_dyn = torch.cat([res_dr, res_dth, res_dv, res_dw], dim=-1)     # (..., 12)

    WaT, WbT = Wa.transpose(-1, -2), Wb.transpose(-1, -2)
    Daa = WaT @ Wa
    Dbb = WbT @ Wb
    Lba = WbT @ Wa
    ga = (WaT @ res_dyn[..., None])[..., 0]
    gb = (WbT @ res_dyn[..., None])[..., 0]
    sq = _sq(res_dyn)

    # ---- diagonal families: stationarity/footvel (p), acc reg, force rate --
    both = ca * cb
    ms = both * W.stat
    mv = (1.0 - both) * W.footvel_reg
    dp = p1 - p0
    res_stat = dp * ms[..., None]
    res_fv = dp * mv[..., None]
    sq = sq + _sq(res_stat, 2) + _sq(res_fv, 2)
    cpp = ms**2 + mv**2                                                 # (..., 4)
    gp = ms[..., None] * res_stat + mv[..., None] * res_fv             # (..., 4, 3)

    res_av = (v1 - v0) * W.acc_reg
    res_aw = (w1 - w0) * W.acc_reg
    sq = sq + _sq(res_av) + _sq(res_aw)
    w2 = W.acc_reg**2

    df = (f1 - f0) / FORCE_SCALE * W.f_reg
    sq = sq + _sq(df, 2)

    # diag layout: [r(3), th(3), v(3), w(3), p(12), f(12)]
    full = lambda n, val: torch.full(lead + (n,), val, dtype=dt_, device=xa.device)  # noqa: E731
    diag_coef = torch.cat(
        [full(6, 0.0), full(6, w2), cpp.repeat_interleave(3, dim=-1), full(12, W.f_reg**2)],
        dim=-1,
    )
    gdiag = torch.cat(
        [
            full(6, 0.0),
            W.acc_reg * res_av,
            W.acc_reg * res_aw,
            gp.reshape(lead + (12,)),
            (W.f_reg * df).reshape(lead + (12,)),
        ],
        dim=-1,
    )
    dmat = torch.diag_embed(diag_coef)
    return Daa + dmat, Dbb + dmat, Lba - dmat, ga - gdiag, gb + gdiag, sq
