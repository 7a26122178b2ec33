"""Soft-contact rigid-body dynamics for SOLO12 (port of `qtos_tpu.sim.engine`).

Model: 6-DOF base (SRB mass/inertia) + 12 torque-driven joints with reflected
leg inertia; penalty contact (spring-damper normal + smooth Coulomb friction)
between feet and the heightfield.

Every function takes any leading batch shape: `SimState` leaves are
``(..., 3)``, ``(..., 4)``, ``(..., 12)`` and ``(..., 4, 2)``, torques
``(..., 12)``.  One episode is a chain of small tensor operations per tick; a
batch of episodes is the same chain over more rows.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import torch

from qtos_torch.device import resolve_device
from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops.rotations import euler_to_quat, quat_integrate, quat_to_euler, quat_to_rot
from qtos_torch.terrain.heightfield import Terrain, height_at


@dataclasses.dataclass(frozen=True)
class SimParams:
    dt: float = 0.001
    contact_kp: float = 5000.0
    contact_kd: float = 80.0
    friction: float = 1.0
    tangent_kp: float = 2500.0  # anchor-spring (stiction) stiffness
    tangent_kd: float = 40.0
    joint_inertia: float = 0.012
    joint_damping: float = 0.3   # trot-tuned; walk/pace use 0.5 (gait_control_params)
    # Whole-robot rotational inertia multiplier over the base-only SRB values
    # (the legs' masses at the hips dominate roll inertia; base-only inertia
    # makes contact damping unstable through the roll lever arms at dt=1ms).
    inertia_scale: float = 5.0
    # Base collision sphere radius (keeps a collapsed robot from sinking
    # through the terrain).
    base_radius: float = 0.05


# Penetration [m] over which the contact's normal damping ramps in.
CONTACT_DAMP_DEPTH = 0.003


@dataclasses.dataclass(frozen=True)
class SimState:
    pos: torch.Tensor      # (..., 3) base CoM world position
    quat: torch.Tensor     # (..., 4) base orientation (x, y, z, w)
    v: torch.Tensor        # (..., 3) base linear velocity
    w: torch.Tensor        # (..., 3) base angular velocity (world)
    q: torch.Tensor        # (..., 12) joint angles
    qd: torch.Tensor       # (..., 12) joint velocities
    anchor: torch.Tensor   # (..., 4, 2) stiction anchor xy per foot (world)

    @property
    def eul(self) -> torch.Tensor:
        return quat_to_euler(self.quat)


@functools.lru_cache(maxsize=None)
def _constants(device: str) -> SimpleNamespace:
    f32 = dict(dtype=torch.float32, device=device)
    return SimpleNamespace(
        weight=Solo12.mass * torch.tensor([0.0, 0.0, -9.81], **f32),
        ez=torch.tensor([0.0, 0.0, 1.0], **f32),
    )


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_state(base_pos, base_eul, q, device=None) -> SimState:
    """State at rest at a base pose and joint configuration.  The device is
    that of `q` when it is a tensor, else `device` (None: CUDA)."""
    dev = q.device if isinstance(q, torch.Tensor) else resolve_device(device)
    base_pos, base_eul, q = _f32(base_pos, dev), _f32(base_eul, dev), _f32(q, dev)
    feet_w = Solo12.fk_world(q, base_pos, base_eul)
    return SimState(
        pos=base_pos,
        quat=euler_to_quat(base_eul),
        v=torch.zeros_like(base_pos),
        w=torch.zeros_like(base_pos),
        q=q,
        qd=torch.zeros_like(q),
        anchor=feet_w[..., :2],
    )


def foot_kinematics(state: SimState):
    """World positions and velocities of the 4 feet, plus leg Jacobians."""
    R = quat_to_rot(state.quat)
    RT = R.transpose(-1, -2)
    feet_b = Solo12.fk(state.q)                     # (..., 4, 3)
    J = Solo12.jacobians(state.q)                   # (..., 4, 3, 3)
    arm_w = feet_b @ RT                             # world lever arms
    feet_w = state.pos[..., None, :] + arm_w
    qd_legs = state.qd.reshape(state.qd.shape[:-1] + (4, 3))
    v_joint = (J @ qd_legs[..., None])[..., 0]      # foot vel in base frame
    feet_vw = (
        state.v[..., None, :]
        + torch.linalg.cross(state.w[..., None, :], arm_w)
        + v_joint @ RT
    )
    return feet_w, feet_vw, arm_w, J, R


def contact_forces(params: SimParams, terrain: Terrain, feet_w, feet_vw, anchor):
    """Penalty contact with stiction.

    Normal: spring-damper on penetration, Hunt-Crossley-style damping ramp so
    touchdown is not impulsive.  Tangential: spring to a per-foot anchor point
    (true static friction) saturated at the Coulomb cone; the anchor is
    projected back to the cone edge while sliding and reset out of contact.

    Returns (forces (..., 4, 3) world, new anchors (..., 4, 2)).
    """
    feet_xy = feet_w[..., :2]
    h = height_at(terrain, feet_w[..., 0], feet_w[..., 1])
    pen = h - feet_w[..., 2]
    active = pen > 0.0
    damp_gate = torch.clamp(pen / CONTACT_DAMP_DEPTH, 0.0, 1.0)
    fn = torch.where(
        active,
        params.contact_kp * pen - params.contact_kd * damp_gate * feet_vw[..., 2],
        0.0,
    )
    fn = torch.clamp(fn, 0.0, 200.0)

    vt = feet_vw[..., :2]
    ft_raw = -params.tangent_kp * (feet_xy - anchor) - params.tangent_kd * vt
    ft_raw = torch.where(active[..., None], ft_raw, 0.0)
    ft_mag = torch.linalg.norm(ft_raw, dim=-1, keepdim=True)
    limit = params.friction * fn[..., None]
    scale = torch.clamp(limit / torch.clamp(ft_mag, min=1e-9), max=1.0)
    ft = ft_raw * scale

    # anchor update: track foot when airborne; creep to cone edge when sliding
    sliding = (ft_mag > limit + 1e-9) & active[..., None]
    anchor_slide = feet_xy + (ft + params.tangent_kd * vt) / params.tangent_kp
    new_anchor = torch.where(
        active[..., None],
        torch.where(sliding, anchor_slide, anchor),
        feet_xy,
    )
    return torch.cat([ft, fn[..., None]], dim=-1), new_anchor


def step_from_kinematics(state: SimState, tau: torch.Tensor, terrain: Terrain, params: SimParams,
                         kin) -> SimState:
    """`sim_step` given `kin = foot_kinematics(state)`, for a caller that
    needs the kinematics itself."""
    feet_w, feet_vw, arm_w, J, R = kin
    c = _constants(str(state.pos.device))
    model = Solo12.tensors(state.pos.device)
    f_c, new_anchor = contact_forces(params, terrain, feet_w, feet_vw, state.anchor)

    # Base wrench (feet contact + gravity + base collision sphere).
    h_base = height_at(terrain, state.pos[..., 0], state.pos[..., 1])
    pen_base = h_base + params.base_radius - state.pos[..., 2]
    f_base_z = torch.clamp(
        torch.where(
            pen_base > 0.0,
            params.contact_kp * pen_base - params.contact_kd * state.v[..., 2],
            0.0,
        ),
        0.0,
        200.0,
    )
    F = f_c.sum(dim=-2) + c.weight + c.ez * f_base_z[..., None]
    T = torch.linalg.cross(arm_w, f_c).sum(dim=-2)
    RT = R.transpose(-1, -2)
    I_w = params.inertia_scale * (R @ model.inertia @ RT)
    I_w_inv = (R @ model.inertia_inv @ RT) / params.inertia_scale
    a = F / Solo12.mass
    Iw_w = (I_w @ state.w[..., None])[..., 0]
    wd = (I_w_inv @ (T - torch.linalg.cross(state.w, Iw_w))[..., None])[..., 0]

    # Joint dynamics: motor + contact reaction through the leg Jacobian.
    f_b = f_c @ R                                           # world -> base frame
    tau_c = (f_b[..., None, :] @ J)[..., 0, :].reshape(tau.shape)   # J^T f per leg
    qdd = (tau + tau_c - params.joint_damping * state.qd) / params.joint_inertia

    dt = params.dt
    v_new = state.v + dt * a
    w_new = state.w + dt * wd
    qd_new = state.qd + dt * qdd
    return SimState(
        pos=state.pos + dt * v_new,
        quat=quat_integrate(state.quat, w_new, dt),
        v=v_new,
        w=w_new,
        q=state.q + dt * qd_new,
        qd=qd_new,
        anchor=new_anchor,
    )


def sim_step(state: SimState, tau: torch.Tensor, terrain: Terrain, params: SimParams) -> SimState:
    """One semi-implicit Euler step at params.dt under motor torques tau (..., 12)."""
    return step_from_kinematics(state, tau, terrain, params, foot_kinematics(state))


def rollout(state: SimState, tau_seq: torch.Tensor, terrain: Terrain, params: SimParams, n_steps: int):
    """`n_steps` steps under a fixed torque sequence (..., T, 12), stepped
    along its T axis.  Returns the final state and the CoM trace
    (..., n_steps, 3)."""
    trace = []
    for t in range(min(n_steps, tau_seq.shape[-2])):
        state = sim_step(state, tau_seq[..., t, :], terrain, params)
        trace.append(state.pos)
    return state, torch.stack(trace, dim=-2)
