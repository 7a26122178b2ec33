"""Frozen copy of `qtos_torch/models/solo12.py` for the benchmark's plain reference: imports
rewritten to this package, nothing else changed unless a comment says so.

Analytic SOLO12 kinematics + single-rigid-body constants (port of
`qtos_tpu.models.solo12`).

Closed-form FK/IK and closed-form foot Jacobians.  Every function takes any
leading batch shape: joints are ``(..., 12)``, feet ``(..., 4, 3)``; the four
legs are computed in one broadcast over a leg axis.

Kinematic parameters from the SOLO12 URDF:
  base -> HAA   : (+-0.1946, +-0.0875, 0), axis x
  HAA  -> HFE   : (0, +-0.014, 0), axis y
  HFE  -> KFE   : (0, +-0.03745, -0.16), axis y
  KFE  -> FOOT  : (0, +-0.008, -0.16) (fixed ankle)

Leg order everywhere: [FL, FR, HL, HR], matching the 37-column trajectory
schema.

The constants are kept as Python numbers; `Solo12.tensors(device)` returns
them as float32 tensors on a device, built once per device.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from .device import resolve_device
from .rotations import euler_to_rot

LEG_NAMES = ("FL", "FR", "HL", "HR")

_INERTIA_DIAG = (0.00578574, 0.01938108, 0.02476124)

_HIP_X = 0.1946
_HIP_Y = 0.0875
_Y1 = 0.014
_Y2 = 0.03745
_Y3 = 0.008
_L_UP = 0.16
_L_LOW = 0.16

# Per-leg signs: x (front/hind), y (left/right).
_FH = (1.0, 1.0, -1.0, -1.0)
_LR = (1.0, -1.0, 1.0, -1.0)
# Knee bend direction matching q_init (front knees flex negative, hind
# positive).
_KNEE_SIGN = (-1.0, -1.0, 1.0, 1.0)


def _fk_terms(q0, q1, q2, y):
    """Foot position relative to the HAA origin, and the terms the Jacobian
    shares with it.  `y` is the leg's lateral offset (a float, or a tensor
    that broadcasts against the angles)."""
    s1, s12 = torch.sin(q1), torch.sin(q1 + q2)
    c1, c12 = torch.cos(q1), torch.cos(q1 + q2)
    # Chain in the sagittal (x, z) plane driven by q1, q2.
    x = -_L_UP * s1 - _L_LOW * s12
    z = -_L_UP * c1 - _L_LOW * c12
    yy = y * torch.ones_like(x)
    # Roll about x by q0.
    c0, s0 = torch.cos(q0), torch.sin(q0)
    yb = c0 * yy - s0 * z
    zb = s0 * yy + c0 * z
    return x, yb, zb, (c0, s0, s1, s12, c1, c12)


def _jacobian(q0, q1, q2, y):
    """d(foot position)/d(q0, q1, q2) in closed form: (..., 3, 3)."""
    x, yb, zb, (c0, s0, s1, s12, c1, c12) = _fk_terms(q0, q1, q2, y)
    dx1 = -_L_UP * c1 - _L_LOW * c12
    dx2 = -_L_LOW * c12
    dz1 = _L_UP * s1 + _L_LOW * s12
    dz2 = _L_LOW * s12
    rows = [
        torch.stack([torch.zeros_like(x), dx1, dx2], -1),
        torch.stack([-zb, -s0 * dz1, -s0 * dz2], -1),
        torch.stack([yb, c0 * dz1, c0 * dz2], -1),
    ]
    return torch.stack(rows, -2)


def _ik_terms(v, d, knee):
    """Closed-form IK from the HAA origin: `v` (..., 3) hip-to-foot vector,
    `d` the lateral offset and `knee` the knee sign (floats, or tensors that
    broadcast against v[..., 0])."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    r2 = vy * vy + vz * vz
    zeta = torch.sqrt(torch.clamp(r2 - d * d, min=1e-10))
    alpha = torch.atan2(vz, vy)
    beta = torch.atan2(-zeta, d * torch.ones_like(zeta))
    q0 = alpha - beta
    # Wrap to [-pi, pi].
    q0 = torch.atan2(torch.sin(q0), torch.cos(q0))

    # Planar 2R in sagittal plane: target (vx, -zeta).
    px, pz = vx, -zeta
    l1, l2 = _L_UP, _L_LOW
    c2 = (px * px + pz * pz - l1 * l1 - l2 * l2) / (2 * l1 * l2)
    c2 = torch.clamp(c2, -1.0, 1.0)
    q2 = knee * torch.acos(c2)
    k1 = l1 + l2 * torch.cos(q2)
    k2 = l2 * torch.sin(q2)
    q1 = torch.atan2(-px, -pz) - torch.atan2(k2, k1)
    q1 = torch.atan2(torch.sin(q1), torch.cos(q1))
    return torch.stack([q0, q1, q2], -1)


class Solo12:
    """Stateless model namespace."""

    n_legs = 4
    n_joints = 12
    # TOWR's effective single-rigid-body mass (see qtos_tpu.models.solo12).
    mass = 3.0
    inertia_diag = _INERTIA_DIAG
    stand_height = 0.24
    # Nominal stance feet in base frame, leg order [FL, FR, HL, HR].
    nominal_feet = (
        (0.21, 0.19, -0.24),
        (0.21, -0.19, -0.24),
        (-0.21, 0.19, -0.24),
        (-0.21, -0.19, -0.24),
    )
    q_init = (0.008, 0.38, -0.845, -0.008, 0.38, -0.845,
              0.0082, -0.38, 0.845, -0.0082, -0.38, 0.845)

    @staticmethod
    def tensors(device) -> SimpleNamespace:
        """The constants as float32 tensors on `device`: `inertia`,
        `inertia_inv` (3, 3), `nominal_feet`, `hips` (4, 3), `q_init` (12,),
        and the per-leg `lateral` offsets and `knee` signs (4,)."""
        return _tensors(str(torch.device(device)))

    @staticmethod
    def hip_positions(device=None) -> torch.Tensor:
        """(4, 3) HAA joint origins in base frame."""
        return Solo12.tensors(resolve_device(device)).hips

    # ------------------------------------------------------------------
    # Forward kinematics
    # ------------------------------------------------------------------

    @staticmethod
    def leg_fk(q_leg: torch.Tensor, leg: int) -> torch.Tensor:
        """Foot position in base frame for one leg.

        Args:
          q_leg: (..., 3) joint angles (HAA, HFE, KFE).
          leg: leg index (a Python int).
        Returns:
          (..., 3) foot position in base frame.
        """
        x, yb, zb, _ = _fk_terms(
            q_leg[..., 0], q_leg[..., 1], q_leg[..., 2], _LR[leg] * (_Y1 + _Y2 + _Y3)
        )
        return Solo12.tensors(q_leg.device).hips[leg] + torch.stack([x, yb, zb], -1)

    @staticmethod
    def fk(q: torch.Tensor) -> torch.Tensor:
        """(..., 12) joints -> (..., 4, 3) feet in base frame."""
        c = Solo12.tensors(q.device)
        qs = q.reshape(q.shape[:-1] + (4, 3))
        x, yb, zb, _ = _fk_terms(qs[..., 0], qs[..., 1], qs[..., 2], c.lateral)
        return c.hips + torch.stack([x, yb, zb], -1)

    @staticmethod
    def fk_world(q: torch.Tensor, base_pos: torch.Tensor, base_eul: torch.Tensor) -> torch.Tensor:
        """Feet in world frame given base pose (euler orientation)."""
        R = euler_to_rot(base_eul)
        return base_pos[..., None, :] + Solo12.fk(q) @ R.transpose(-1, -2)

    # ------------------------------------------------------------------
    # Inverse kinematics (closed form)
    # ------------------------------------------------------------------

    @staticmethod
    def leg_ik(p_base: torch.Tensor, leg: int) -> torch.Tensor:
        """Closed-form IK for one leg.

        Args:
          p_base: (..., 3) desired foot position in base frame.
          leg: leg index (a Python int).
        Returns:
          (..., 3) joint angles (HAA, HFE, KFE); clips unreachable targets to
          the workspace boundary rather than returning NaN.
        """
        v = p_base - Solo12.tensors(p_base.device).hips[leg]
        return _ik_terms(v, _LR[leg] * (_Y1 + _Y2 + _Y3), _KNEE_SIGN[leg])

    @staticmethod
    def ik(feet_base: torch.Tensor) -> torch.Tensor:
        """(..., 4, 3) feet in base frame -> (..., 12) joint angles."""
        c = Solo12.tensors(feet_base.device)
        qs = _ik_terms(feet_base - c.hips, c.lateral, c.knee)
        return qs.reshape(qs.shape[:-2] + (12,))

    @staticmethod
    def ik_world(feet_world: torch.Tensor, base_pos: torch.Tensor, base_eul: torch.Tensor) -> torch.Tensor:
        """World-frame feet targets -> joints, via the live base pose."""
        R = euler_to_rot(base_eul)
        return Solo12.ik((feet_world - base_pos[..., None, :]) @ R)

    # ------------------------------------------------------------------
    # Jacobians / differential IK
    # ------------------------------------------------------------------

    @staticmethod
    def leg_jacobian(q_leg: torch.Tensor, leg: int) -> torch.Tensor:
        """(..., 3) -> (..., 3, 3) foot Jacobian d p_base / d q_leg."""
        return _jacobian(q_leg[..., 0], q_leg[..., 1], q_leg[..., 2], _LR[leg] * (_Y1 + _Y2 + _Y3))

    @staticmethod
    def jacobians(q: torch.Tensor) -> torch.Tensor:
        """(..., 12) -> (..., 4, 3, 3) per-leg foot Jacobians."""
        qs = q.reshape(q.shape[:-1] + (4, 3))
        return _jacobian(qs[..., 0], qs[..., 1], qs[..., 2], Solo12.tensors(q.device).lateral)

    @staticmethod
    def ik_dls(feet_base: torch.Tensor, q0: torch.Tensor, iters: int = 6,
               damping: float = 1e-4) -> torch.Tensor:
        """Damped-least-squares iterative IK, a cross-check of the closed form.

        Args:
          feet_base: (..., 4, 3) targets in base frame.
          q0: (..., 12) initial joints.
        """
        eye = damping * torch.eye(3, dtype=q0.dtype, device=q0.device)
        q = q0
        for _ in range(iters):
            err = feet_base - Solo12.fk(q)            # (..., 4, 3)
            J = Solo12.jacobians(q)                    # (..., 4, 3, 3)
            JT = J.transpose(-1, -2)
            dq = JT @ torch.linalg.solve(J @ JT + eye, err[..., None])
            q = q + dq.reshape(q.shape)
        return q


@functools.lru_cache(maxsize=None)
def _tensors(device: str) -> SimpleNamespace:
    f32 = dict(dtype=torch.float32, device=device)
    diag = torch.tensor(Solo12.inertia_diag, **f32)
    fh, lr = torch.tensor(_FH, **f32), torch.tensor(_LR, **f32)
    return SimpleNamespace(
        inertia=torch.diag(diag),
        inertia_inv=torch.diag(1.0 / diag),
        nominal_feet=torch.tensor(Solo12.nominal_feet, **f32),
        hips=torch.stack([fh * _HIP_X, lr * _HIP_Y, torch.zeros(4, **f32)], -1),
        q_init=torch.tensor(Solo12.q_init, **f32),
        lateral=lr * (_Y1 + _Y2 + _Y3),
        knee=torch.tensor(_KNEE_SIGN, **f32),
    )
