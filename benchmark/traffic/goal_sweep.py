"""Traffic kind `goal_sweep`: `pool` batches of `batch` windows from the
configuration's standing start at the origin, goals spread evenly over the
configuration's `goal_x` range (one goal in each of `batch` equal bins, at a
seeded point of its bin, in a seeded order) at `goal_y`.  Every seed gives
the same set of sizes and the same spread of goals."""

from __future__ import annotations

import torch


def make(mix: dict, cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    """(pool, batch, 2) goal xy."""
    P, B = mix["pool"], mix["batch"]
    lo, hi = cfg["goal_x"]
    order = torch.argsort(torch.rand((P, B), generator=g, device=device), dim=1)
    at = torch.rand((P, B), generator=g, device=device)
    gx = lo + (hi - lo) * (order.float() + at) / B
    return torch.stack([gx, torch.full_like(gx, cfg["goal_y"])], -1)
