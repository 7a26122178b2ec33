"""Frozen copy of `qtos_torch/control/loop.py` for the benchmark's plain reference: imports
rewritten to this package, nothing else changed unless a comment says so.

The 1 kHz control loop (port of `qtos_tpu.control.loop`).

Per tick: take the next trajectory row, re-express the planned feet in the
live base frame (including the ``ee_shift`` z offset), run IK, the PD motor
model, and step the physics.

Every function takes any leading batch shape: a table is ``(..., T, 37)`` and
is stepped along its T axis, the state's leaves carry the same leading axes.

Only the plain loops are kept: `_scan_ticks` and `_hold_ticks` over `_tick`
and `sim_step` (the port's `playback`, `playback_recorded` and
`stance_warmup`, which launch its tick kernel, and the CSV writer are left
out).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .solo12 import Solo12
from .rotations import euler_to_rot, rot_to_euler
from .engine import (
    SimParams,
    SimState,
    foot_kinematics,
    init_state,
    sim_step,
    step_from_kinematics,
)
from .motor import MotorParams, pd_torque
from .heightfield import Terrain


@dataclasses.dataclass(frozen=True)
class ControlParams:
    motor: MotorParams = dataclasses.field(default_factory=MotorParams)
    sim: SimParams = dataclasses.field(default_factory=SimParams)
    # z offset applied to planned feet in the base frame; this engine has
    # point feet, so the default is 0.
    ee_shift: float = 0.0
    use_force_ff: bool = True
    # "live": re-express planned feet in the live base frame (tolerates base
    # lag, never corrects it).
    # "hybrid" (default): live-frame targets PLUS a clipped proportional
    # correction of the world-frame base error: the live conveyor keeps
    # driving the gait while drift is steered out through foot placement.
    # "plan": track planned world-frame feet against the live base pose;
    # removes the live-frame drive entirely and diverges; kept for study.
    frame: str = "hybrid"
    # Proportional gain on the world-frame base error in "hybrid"/"plan"
    # modes (fraction of the error fed back into foot targets per tick);
    # >= 2.0 destabilizes.
    base_corr: float = 0.5
    # Per-axis cap on the hybrid correction shift [m]: the stabilizer that
    # keeps corrected targets inside the leg workspace no matter the drift.
    max_corr: float = 0.04
    # Time constant [s] of the low-pass filter on the per-foot correction:
    # the stance/swing split flips each foot's correction sign at contact
    # transitions, and feeding that step change straight into the joint
    # targets excites slip/oscillation; filtering it removes the chatter.
    corr_tau: float = 0.05
    # Capture-point velocity feedback [s] on swing-foot touchdown: swing
    # targets shift by vel_corr * low-passed (v_live - v_plan) in xy, landing
    # "ahead of the fall" to arrest drift RATE (Raibert/capture-point
    # heuristic, sqrt(h/g) ~ 0.156 s for a 0.24 m stand height).  The
    # low-pass (vel_tau) keeps the gait's own cyclic sway out of the
    # touchdown placement: only sustained drift feeds back.  0 for trot (its
    # cyclic sway couples badly into touchdown placement even low-passed);
    # 0.15 for the slower gaits.
    vel_corr: float = 0.0
    vel_tau: float = 0.3
    # Heading feedback: fraction of the (wrapped) live-vs-plan yaw error fed
    # into the foot targets per tick: planted feet get their base-frame
    # targets rotated by +yawc about z (levering the base heading back onto
    # the plan), swing feet by -yawc (touching down at the absolute planned
    # bearings).  Without it the controller does not observe the yaw
    # direction at all.  Default 0: tick-level yaw feedback degrades
    # short-window tracking because foot-placement yaw torques interfere with
    # the gait, so it is kept only as an option.
    yaw_corr: float = 0.0
    # Cap on the applied yaw correction [rad].
    max_yaw_corr: float = 0.2
    # Low-pass time constant [s] on the yaw error: the trot's own cyclic yaw
    # sway (~0.5 s period) must not feed back into foot placement; only
    # sustained heading drift does (same reasoning as vel_tau).
    yaw_tau: float = 0.4


@dataclasses.dataclass(frozen=True)
class TrackingMetrics:
    """Per-episode tracking series, with the realized CoM/feet trajectories
    so the host can render the tracking plots."""

    com_err: torch.Tensor        # (..., T) per-tick CoM L2 error vs plan
    ee_err: torch.Tensor         # (..., T) mean foot L2 error vs plan
    cum_com_err: torch.Tensor    # (...) cumulative CoM error
    avg_com_err_per_s: torch.Tensor  # (...) the headline metric (x1000 scale)
    pos: torch.Tensor            # (..., T, 3) realized CoM positions
    feet: torch.Tensor           # (..., T, 4, 3) realized world foot positions
    yaw: torch.Tensor            # (..., T) realized base yaw (heading-drift estimation)


def gait_control_params(gait: str) -> ControlParams:
    """Per-gait controller tuning.

    Trot runs the light-damping set.  The slower lateral-sequence gaits need
    heavier joint damping plus capture-point touchdown feedback: at the trot
    settings the walk gait pumps a growing bounce across stitched windows."""
    if gait in ("walk", "pace", "bound", "stand"):
        return ControlParams(
            motor=MotorParams(kd=2.0),
            sim=SimParams(joint_damping=0.5),
            vel_corr=0.15,
        )
    # trot: heading feedback
    return ControlParams(yaw_corr=0.3, yaw_tau=0.4)


def control_profile(name: str) -> ControlParams:
    """Named controller profiles selectable per experiment preset, on top of
    the per-gait defaults (gait_control_params).

    "stairs": the riser-crossing set: heavy joint damping kills the bounce
    the trot pumps against a step face, yaw feedback holds heading through
    the asymmetric-support phases."""
    profiles = {
        "stairs": ControlParams(
            motor=MotorParams(kd=2.0),
            sim=SimParams(joint_damping=0.5),
            yaw_corr=0.3,
            yaw_tau=0.4,
        ),
    }
    try:
        return profiles[name]
    except KeyError as e:
        raise KeyError(f"unknown control profile {name!r}; known: {sorted(profiles)}") from e


def decode_row(row: torch.Tensor):
    """Decode 37-col rows (..., 37)."""
    lead = row.shape[:-1]
    return dict(
        t=row[..., 0],
        r=row[..., 1:4],
        eul=row[..., 4:7],
        feet=row[..., 7:19].reshape(lead + (4, 3)),
        v=row[..., 19:22],
        w=row[..., 22:25],
        f=row[..., 25:37].reshape(lead + (4, 3)),
    )


@functools.lru_cache(maxsize=None)
def _xy_mask(device: str) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 0.0], dtype=torch.float32, device=device)


def _shift_z(feet_b: torch.Tensor, ee_shift: float) -> torch.Tensor:
    """feet_b with `ee_shift` added to z, out of place."""
    if ee_shift == 0.0:
        return feet_b
    return torch.cat([feet_b[..., :2], feet_b[..., 2:] + ee_shift], dim=-1)


def _plan_feet_base(cmd):
    """Planned feet in the planned base frame: R^T (p - r), rows."""
    return (cmd["feet"] - cmd["r"][..., None, :]) @ euler_to_rot(cmd["eul"])


def plan_joint_targets(row, params: ControlParams):
    """Planned joints for rows (..., 37): planned feet in the planned base
    frame, then IK (the hot per-tick math of the loop)."""
    cmd = decode_row(row)
    return Solo12.ik(_shift_z(_plan_feet_base(cmd), params.ee_shift)), cmd


def _rotz_delta(p, a):
    """(Rz(a) - I) p for feet p (..., 4, 3) and angles a (...)."""
    ca, sa = (torch.cos(a) - 1.0)[..., None], torch.sin(a)[..., None]
    return torch.stack(
        [ca * p[..., 0] - sa * p[..., 1],
         sa * p[..., 0] + ca * p[..., 1],
         torch.zeros_like(p[..., 0])], dim=-1)


def _vec_mat(v, M):
    """Row vector (..., 3) times matrix (..., 3, 3)."""
    return (v[..., None, :] @ M)[..., 0, :]


def _tick(carry, row, terrain: Terrain, params: ControlParams):
    state, q_des_prev, corr_filt, verr_filt, yerr_filt = carry
    cmd = decode_row(row)
    feet_plan_b = _plan_feet_base(cmd)
    q_des_plan = Solo12.ik(_shift_z(feet_plan_b, params.ee_shift))
    dt = params.sim.dt
    qd_des = (q_des_plan - q_des_prev) / dt
    # One evaluation of the live kinematics serves the controller and the
    # physics step.
    kin = foot_kinematics(state)
    J, R_live = kin[3], kin[4]
    eul_live = rot_to_euler(R_live)

    if params.frame == "live":
        q_des = q_des_plan
    elif params.frame == "hybrid":
        # Clipped world-error steering, split by contact role: planted feet
        # get +err (their base-frame targets shift toward the drift, levering
        # the base back onto the plan), swing feet get -err in xy (so they
        # touch down at the ABSOLUTE planned spots instead of the drifted
        # ones).  The cap keeps corrected targets inside the leg workspace
        # under any drift; the per-foot low-pass removes the sign-flip step
        # at contact transitions.
        #
        # The correction is a WORLD-frame intent applied through base-frame
        # IK targets, so it must be projected with the LIVE rotation: the
        # planned one misdirects it under heading error (at 90 deg yaw error
        # an x-correction pushes y, a positive-feedback veer).
        xy = _xy_mask(str(row.device))
        err_w = state.pos - cmd["r"]
        corr_w = torch.clamp(params.base_corr * err_w, -params.max_corr, params.max_corr)
        corr_b = _vec_mat(corr_w, R_live)                     # (..., 3)
        # capture-point velocity term: land swing feet AHEAD of the drift
        verr_w = (state.v - cmd["v"]) * xy
        beta = dt / max(params.vel_tau, dt)
        verr_filt = verr_filt + beta * (verr_w - verr_filt)
        cp_b = _vec_mat(
            torch.clamp(params.vel_corr * verr_filt, -params.max_corr, params.max_corr), R_live
        )
        stance = (cmd["f"][..., 2] > 1.0)[..., None]          # planned contact
        # heading feedback: rotate base-frame targets about z by +-yawc
        yaw_diff = eul_live[..., 2] - cmd["eul"][..., 2]
        yaw_err = torch.atan2(torch.sin(yaw_diff), torch.cos(yaw_diff))
        gamma = dt / max(params.yaw_tau, dt)
        yerr_filt = yerr_filt + gamma * (yaw_err - yerr_filt)
        yawc = torch.clamp(params.yaw_corr * yerr_filt, -params.max_yaw_corr, params.max_yaw_corr)
        swing_delta = (-corr_b + cp_b)[..., None, :] * xy
        delta = torch.where(
            stance,
            corr_b[..., None, :] + _rotz_delta(feet_plan_b, yawc),
            swing_delta + _rotz_delta(feet_plan_b, -yawc),
        )
        alpha = dt / max(params.corr_tau, dt)
        corr_filt = corr_filt + alpha * (delta - corr_filt)
        q_des = Solo12.ik(_shift_z(feet_plan_b + corr_filt, params.ee_shift))
    else:
        # world-frame tracking: place feet at (lag-corrected) planned world
        # positions relative to the live base pose
        shift = (state.pos - cmd["r"]) * (1.0 - params.base_corr)
        feet_t = cmd["feet"] + shift[..., None, :]
        feet_b = (feet_t - state.pos[..., None, :]) @ R_live
        q_des = Solo12.ik(_shift_z(feet_b, params.ee_shift))

    tau_ff = None
    if params.use_force_ff:
        # feedforward: tau = -J^T R^T f  (reaction to planned contact force)
        f_b = cmd["f"] @ euler_to_rot(eul_live)
        tau_ff = -(f_b[..., None, :] @ J)[..., 0, :].reshape(state.q.shape)

    tau = pd_torque(params.motor, q_des, qd_des, state.q, state.qd, tau_ff)
    new_state = step_from_kinematics(state, tau, terrain, params.sim, kin)

    com_err = torch.linalg.norm(new_state.pos - cmd["r"], dim=-1)
    new_eul = new_state.eul
    feet_w = Solo12.fk_world(new_state.q, new_state.pos, new_eul)
    ee_err = torch.linalg.norm(feet_w - cmd["feet"], dim=-1).mean(dim=-1)
    out = dict(
        com_err=com_err,
        ee_err=ee_err,
        pos=new_state.pos,
        feet=feet_w,
        q=new_state.q,
        qd=new_state.qd,
        tau=tau,
        eul=new_eul,
    )
    return (new_state, q_des_plan, corr_filt, verr_filt, yerr_filt), out


def _select(active: torch.Tensor, new, old, lead: int):
    """Per-episode choice between two carries: `active` is (...) with `lead`
    axes, every tensor leaf (..., *leaf)."""
    if isinstance(new, torch.Tensor):
        return torch.where(active.reshape(active.shape + (1,) * (new.dim() - lead)), new, old)
    if isinstance(new, tuple):
        return tuple(_select(active, n, o, lead) for n, o in zip(new, old))
    return dataclasses.replace(
        new, **{f.name: _select(active, getattr(new, f.name), getattr(old, f.name), lead)
                for f in dataclasses.fields(new)}
    )


def _scan_ticks(table, state0, terrain, params, n_valid=None):
    """The plain version of the tick kernel's playback: `_tick` over the
    table's rows, one Python iteration per tick.  Ticks at index >= `n_valid` are
    no-ops (state carried through unchanged): the receding-horizon runner's
    exec chunk is a FIXED slice of the trajectory buffer, but in steady state
    only part of its rows are final; without the mask the tail ticks would
    execute all-zero rows (CoM commanded to the origin -> IK clamped to the
    workspace boundary -> a max-torque kick at every stitch boundary,
    corrupting the carried sim state).

    `n_valid` is a Python int, or a (...) tensor with one count per episode;
    a tensor is applied with `torch.where` on the carry, never read back.
    Returns (final state, traces dict with a T axis after the batch axes)."""
    lead = table.dim() - 2
    batch = table.shape[:-2]
    f32 = dict(dtype=table.dtype, device=table.device)
    q_des0, _ = plan_joint_targets(table[..., 0, :], params)
    carry = (state0, q_des0, torch.zeros(batch + (4, 3), **f32),
             torch.zeros(batch + (3,), **f32), torch.zeros(batch, **f32))
    outs = []
    for t in range(table.shape[-2]):
        new_carry, out = _tick(carry, table[..., t, :], terrain, params)
        if n_valid is None:
            carry = new_carry
        elif isinstance(n_valid, torch.Tensor):
            carry = _select(t < n_valid, new_carry, carry, lead)
        elif t < n_valid:
            carry = new_carry
        outs.append(out)
    traces = {k: torch.stack([o[k] for o in outs], dim=lead) for k in outs[0]}
    return carry[0], traces


def _metrics(traces, n) -> TrackingMetrics:
    """`n`: ticks that count, a Python int or a (...) tensor."""
    com_err = traces["com_err"]
    T = com_err.shape[-1]
    if isinstance(n, torch.Tensor):
        mask = torch.arange(T, device=com_err.device) < n[..., None]
        denom = torch.clamp(n, min=1)
    else:
        mask = torch.arange(T, device=com_err.device) < n
        denom = max(n, 1)
    cum = torch.where(mask, com_err, 0.0).sum(dim=-1)
    return TrackingMetrics(
        com_err=com_err, ee_err=traces["ee_err"], cum_com_err=cum,
        # cumulative error / elapsed seconds, x1000
        avg_com_err_per_s=cum / denom * 1000.0,
        pos=traces["pos"], feet=traces["feet"], yaw=traces["eul"][..., 2],
    )


def _hold_ticks(state: SimState, terrain: Terrain, params: ControlParams, n_steps: int) -> SimState:
    """The plain version of the tick kernel's hold: one Python iteration per
    step."""
    q_hold = state.q
    qd_des = torch.zeros_like(q_hold)
    for _ in range(n_steps):
        tau = pd_torque(params.motor, q_hold, qd_des, state.q, state.qd)
        state = sim_step(state, tau, terrain, params.sim)
    return state


def state_from_row(row, terrain: Terrain, params: ControlParams = ControlParams(),
                   drop: float = 0.0) -> SimState:
    """Initialize the sim at trajectory rows (..., 37) (teleport-start).  Uses
    the same ee_shift as the loop so tick 0 starts with zero joint error."""
    q, cmd = plan_joint_targets(row, params)
    lift = torch.tensor([0.0, 0.0, drop], dtype=row.dtype, device=row.device)
    return init_state(cmd["r"] + lift, cmd["eul"], q)
