"""Device selection shared by the port's entry points, and the device
constants its solver builds once."""

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


_CONSTANTS: dict = {}


def constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, built once per
    (values, dtype, device) and kept for the life of the process: a per-call
    host-to-device copy of a constant costs a pageable copy and cannot be
    captured in a CUDA graph, and a captured graph reads the tensor at its
    address, so it is never freed.  `values` is a number or a tuple (of
    tuples) of numbers, told apart by their `repr` (so -0.0 is not 0.0).
    The tensor is read only: callers never write into it."""
    key = (repr(values), dtype, torch.device(device))
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return out
