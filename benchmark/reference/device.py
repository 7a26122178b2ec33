"""The device rule of the reference's frozen copies: ``None`` means CUDA."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)
