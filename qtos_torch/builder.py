"""One-call experiment assembly (port of `qtos_tpu.builder`; reference:
QTOS/builder.py:16-53).

Everything is constructed from an experiment preset:

    from qtos_torch.builder import build
    bundle = build("exp_1")
    report = bundle.runner.run()

The feasibility bool map is probed with one batched solve when the preset
asks for it (reference bool_map_search / 32-process Docker sweep).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from qtos_torch.config import ExperimentConfig, get_experiment
from qtos_torch.control.replan import RecedingHorizonRunner, RunnerConfig
from qtos_torch.device import resolve_device
from qtos_torch.models.solo12 import Solo12
from qtos_torch.terrain import Terrain, make_terrain


@dataclass
class Bundle:
    """Everything a run needs (typed analog of the reference args dict)."""

    exp: ExperimentConfig
    terrain: Terrain
    robot: type[Solo12]
    runner: RecedingHorizonRunner
    blocked: np.ndarray | None = None

    @property
    def planner(self):
        return self.runner.planner


def build(
    exp: str | ExperimentConfig = "exp_1",
    goal_xy=None,
    runner_cfg: RunnerConfig | None = None,
    seed: int = 0,
    probe_feasibility: bool | None = None,
    device=None,
) -> Bundle:
    """Assemble terrain + planner + receding-horizon runner for a preset.

    Args:
      exp: preset name ("exp_1".."exp_10", "test") or an ExperimentConfig.
      goal_xy: optional goal override (reference -g flag).
      runner_cfg: optional RunnerConfig override.
      seed: rng seed for randomized environments (reference random_env).
      probe_feasibility: force the batched feasibility probe on/off
        (defaults to the preset's bool_map_search).
      device: where everything lives; None means CUDA.
    """
    dev = resolve_device(device)
    cfg = exp if isinstance(exp, ExperimentConfig) else get_experiment(exp)
    goal = tuple(goal_xy[:2]) if goal_xy is not None else cfg.goal_xy
    rng = np.random.default_rng(seed)
    terrain = make_terrain(
        list(cfg.maps), scale_factor=cfg.mesh_scale, randomize=cfg.random_env, rng=rng, device=dev
    )

    blocked = None
    do_probe = cfg.bool_map_search if probe_feasibility is None else probe_feasibility
    if do_probe:
        from qtos_torch.planner.feasibility import feasibility_map

        blocked = feasibility_map(terrain)

    rcfg = runner_cfg or RunnerConfig(avg_speed=cfg.avg_speed, gait=cfg.gait)
    runner = RecedingHorizonRunner(terrain, goal, cfg=rcfg, blocked=blocked, device=dev)
    return Bundle(exp=cfg, terrain=terrain, robot=Solo12, runner=runner, blocked=blocked)
