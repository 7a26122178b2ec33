"""Traffic kind `solved_tables`: `pool` batches of `batch` 1 kHz tables (the
37-column rows), each the plain reference's solve of a `goal_sweep` batch
(the configuration's solver, float32) sampled at 1 kHz: solved windows of
the sweep, made by the benchmark itself."""

from __future__ import annotations

import torch

from benchmark import harness, traffic
from benchmark.reference import sampler, solver, spec


def make(mix: dict, cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    """(pool, batch, T, 37) tables."""
    terr = solver.terrain(harness.terrain_grid(cfg, device), cfg)
    scfg = solver.solver_config(cfg["solver"])
    out = []
    for goals in traffic.kind("goal_sweep").make(mix, cfg, g, device):
        specs = spec.default_spec(terr, goal_xy=(goals[:, 0], goals[:, 1]), duration=cfg["duration_s"], K=cfg["K"],
                                  device=device)
        with solver.precision("float32"):
            x = solver.solve_batch(specs, terr, scfg).x
        out.append(sampler.sample_trajectory(x, specs)[0])
    return torch.stack(out).contiguous()
