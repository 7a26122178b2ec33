"""Frozen copy of `qtos_torch/ops/rotations.py` for the benchmark's plain reference: imports
rewritten to this package, nothing else changed unless a comment says so.

SO(3) utilities, batched-first (port of `qtos_tpu.ops.rotations`).

Conventions
-----------
Euler angles are ``(roll, pitch, yaw)`` with the world-frame rotation

    R = Rz(yaw) @ Ry(pitch) @ Rx(roll)

Quaternions are ``(x, y, z, w)`` (scalar last).

All functions broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch


def mat3(rows):
    """Nested 3x3 list of (...) tensors -> (..., 3, 3)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rx(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return mat3([[o, z, z], [z, c, -s], [z, s, c]])


def ry(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rz(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return mat3([[c, -s, z], [s, c, z], [z, z, o]])


def euler_to_rot(eul: torch.Tensor) -> torch.Tensor:
    """(..., 3) euler (roll, pitch, yaw) -> (..., 3, 3) rotation matrix."""
    roll, pitch, yaw = eul[..., 0], eul[..., 1], eul[..., 2]
    return rz(yaw) @ ry(pitch) @ rx(roll)


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) euler (roll, pitch, yaw). Safe near gimbal lock."""
    sy = -R[..., 2, 0]
    cy = torch.sqrt(torch.clamp(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2, min=1e-12))
    pitch = torch.atan2(sy, cy)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], -1)


def euler_rate_matrix(eul: torch.Tensor) -> torch.Tensor:
    """C(eul) with world angular velocity  w = C @ eul_dot."""
    roll, pitch, yaw = eul[..., 0], eul[..., 1], eul[..., 2]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(roll)
    o = torch.ones_like(roll)
    return mat3([[cy * cp, -sy, z], [sy * cp, cy, z], [-sp, z, o]])


def inv_cos_pitch(cp: torch.Tensor) -> torch.Tensor:
    """1 / cos(pitch), with |cos(pitch)| held at >= 1e-6 (gimbal lock)."""
    small = torch.sign(cp) * 1e-6 + (cp == 0).to(cp.dtype) * 1e-6
    return 1.0 / torch.where(torch.abs(cp) < 1e-6, small, cp)


def euler_rate_matrix_inv(eul: torch.Tensor) -> torch.Tensor:
    """Closed-form C(eul)^-1."""
    pitch, yaw = eul[..., 1], eul[..., 2]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(cp)
    ic = inv_cos_pitch(cp)
    return mat3(
        [
            [cy * ic, sy * ic, z],
            [-sy, cy, z],
            [cy * sp * ic, sy * sp * ic, torch.ones_like(cp)],
        ]
    )


def omega_to_euler_rate(eul: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """World angular velocity -> euler rates: eul_dot = C(eul)^-1 @ w."""
    return (euler_rate_matrix_inv(eul) @ omega[..., None])[..., 0]


def euler_rate_to_omega(eul: torch.Tensor, eul_dot: torch.Tensor) -> torch.Tensor:
    """Euler rates -> world angular velocity."""
    return (euler_rate_matrix(eul) @ eul_dot[..., None])[..., 0]


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return mat3([[o, -z, y], [z, o, -x], [-y, x, o]])


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        -1,
    )


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 1e-12, 2.0 / n, torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    o = torch.ones_like(x)
    return mat3(
        [
            [o - (yy + zz), xy - wz, xz + wy],
            [xy + wz, o - (xx + zz), yz - wx],
            [xz - wy, yz + wx, o - (xx + yy)],
        ]
    )


def euler_to_quat(eul: torch.Tensor) -> torch.Tensor:
    r, p, y = eul[..., 0] * 0.5, eul[..., 1] * 0.5, eul[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        -1,
    )


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    return rot_to_euler(quat_to_rot(q))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate unit quaternion by world angular velocity over dt (exact map)."""
    ang = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * ang * dt
    axis = omega_world / torch.clamp(ang, min=1e-9)
    dq = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
    out = quat_mul(dq, q)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)
