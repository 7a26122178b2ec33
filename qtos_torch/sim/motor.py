"""PD-to-torque motor model (port of `qtos_tpu.sim.motor`).

Per-joint PD with hip/knee/ankle gain scaling and a hard clip at the observed
torque limit (t_max = 8.0).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from qtos_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MotorParams:
    # Defaults tuned for this engine's explicit joint model, for the trot;
    # slower gaits use heavier damping via control.loop.gait_control_params.
    kp: float = 60.0
    kd: float = 1.2
    t_max: float = 8.0
    hip_scale: float = 1.0
    knee_scale: float = 1.0
    ankle_scale: float = 1.0

    def gain_vector(self, device=None) -> torch.Tensor:
        """(12,) per-joint gain scale on `device` (None: CUDA), built once
        per device and scale set."""
        return _gain_vector(self.hip_scale, self.knee_scale, self.ankle_scale,
                            str(resolve_device(device)))


@functools.lru_cache(maxsize=None)
def _gain_vector(hip: float, knee: float, ankle: float, device: str) -> torch.Tensor:
    return torch.tensor([hip, knee, ankle], dtype=torch.float32, device=device).repeat(4)


def pd_torque(
    params: MotorParams,
    q_des: torch.Tensor,
    qd_des: torch.Tensor,
    q: torch.Tensor,
    qd: torch.Tensor,
    tau_ff: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., 12) desired/actual joints -> clipped motor torques."""
    scale = params.gain_vector(q.device)
    tau = params.kp * scale * (q_des - q) + params.kd * scale * (qd_des - qd)
    if tau_ff is not None:
        tau = tau + tau_ff
    return torch.clamp(tau, -params.t_max, params.t_max)
