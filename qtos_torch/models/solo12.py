"""SOLO12 single-rigid-body constants (port of the constants the solver reads
from `qtos_tpu.models.solo12`).

The constants are kept as Python numbers; `Solo12.tensors(device)` returns
them as float32 tensors on a device, built once per device.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

LEG_NAMES = ("FL", "FR", "HL", "HR")

_INERTIA_DIAG = (0.00578574, 0.01938108, 0.02476124)


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

    @staticmethod
    def tensors(device) -> SimpleNamespace:
        """`inertia`, `inertia_inv` (3, 3) and `nominal_feet` (4, 3) as
        float32 tensors on `device`."""
        return _tensors(str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _tensors(device: str) -> SimpleNamespace:
    f32 = dict(dtype=torch.float32, device=device)
    diag = torch.tensor(Solo12.inertia_diag, **f32)
    return SimpleNamespace(
        inertia=torch.diag(diag),
        inertia_inv=torch.diag(1.0 / diag),
        nominal_feet=torch.tensor(Solo12.nominal_feet, **f32),
    )
