"""The general traffic generator: every cell's inputs, made on the device
from the seed and from two data files, the cell's traffic mix
(`traffic/<name>.json`) and its configuration (`configs/<name>.json`).

A mix's `kind` names the form of its inputs, and the form is made by
`traffic/<kind>.py` (its `make(mix, cfg, g, device)`), found by name as the
drivers and metric readers are, so a new form is a new file:

- `goal_sweep`: batches of windows from the configuration's standing start,
  goals spread evenly over its `goal_x` range;
- `replans`: replans of the configuration's candidate start rows, standing
  on its terrain along its path;
- `solved_tables`: batches of 1 kHz tables, the plain reference's solves of
  `goal_sweep` batches.

Every random number comes from one `torch.Generator` on the device seeded
with the run's seed, drawn in a few large calls.
"""

from __future__ import annotations

import torch

G = 9.81


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def kind(name: str):
    """The module `traffic/<name>.py` that makes a mix of that kind."""
    from benchmark import harness

    return harness.load_module("traffic", name)


def make(mix: dict, cfg: dict, seed: int, device):
    """The inputs of a traffic mix, from the seed."""
    return kind(mix["kind"]).make(mix, cfg, generator(seed, device), device)
