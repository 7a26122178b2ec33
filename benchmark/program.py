"""The benchmark's side of the system under test: `qtos_torch` objects built
from a configuration's data, and the program's own launch counters.

Only this module and the drivers import `qtos_torch`; the reference under
`reference/` imports none of it.
"""

from __future__ import annotations

import torch


def terrain(grid: torch.Tensor, cfg: dict):
    """The program's terrain over the benchmark's own height grid."""
    from qtos_torch.terrain.heightfield import Terrain

    return Terrain(height=grid, resolution=cfg["terrain_resolution"], origin=tuple(cfg["terrain_origin"]))


def solver_config(d: dict):
    """`qtos_torch.solver.SolverConfig` with every field as the
    configuration states it."""
    from qtos_torch.solver.spec import SolverConfig, Weights

    return SolverConfig(**{**d, "rom_box": tuple(d["rom_box"]), "weights": Weights(**d["weights"])})


def runner_config(cfg: dict):
    """`qtos_torch.control.replan.RunnerConfig` of a replanner configuration
    (the fields a replan reads)."""
    from qtos_torch.control.replan import RunnerConfig

    return RunnerConfig(K=cfg["K"], window_duration=cfg["window_duration"], gait=cfg["gait"],
                        n_candidates=cfg["n_candidates"], candidate_stride=cfg["candidate_stride"],
                        candidate_goal_backoff=cfg["candidate_goal_backoff"], avg_speed=cfg["avg_speed"],
                        usable_viol=cfg["usable_viol"], solver=solver_config(cfg["solver"]))


def counters() -> dict:
    """The program's launch counters of its hand-written kernels."""
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.ops.tick import tick_scan

    return dict(btd=btd_solve.launches, btd_small=btd_solve.small_launches,
                assemble=assemble_kernel.launches, tick=tick_scan.launches)


def reset_counters() -> None:
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.ops.tick import tick_scan

    btd_solve.launches = btd_solve.small_launches = assemble_kernel.launches = tick_scan.launches = 0

