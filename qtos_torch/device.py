"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "qtos_torch: CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # "cuda" and "cuda:<current>" name one device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
