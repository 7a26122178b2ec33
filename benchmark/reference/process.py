"""The reference's plans in a process of their own, for a driver that starts
them beside the program's window: the reference's LM iterations over long
windows are some ten thousand small operations each, which the host's CPU
runs faster with no autograd records and one thread."""

from __future__ import annotations

import torch

from . import solver


def solve_batches(specs, terrain, cfgs) -> list:
    """`solver.solve_batch` of the same specs under each `SolverConfig` of
    `cfgs`, in order, in inference mode on one CPU thread."""
    torch.set_num_threads(1)
    with torch.inference_mode():
        return [solver.solve_batch(specs, terrain, cfg) for cfg in cfgs]
