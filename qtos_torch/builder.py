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

import dataclasses
from dataclasses import dataclass

import numpy as np

from qtos_torch.config import ExperimentConfig, get_experiment
from qtos_torch.control.replan import RecedingHorizonRunner, RunnerConfig
from qtos_torch.device import resolve_device
from qtos_torch.models.solo12 import Solo12
from qtos_torch.solver.spec import SolverConfig
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


def preset_runner_config(exp: ExperimentConfig, realtime: bool = False) -> RunnerConfig:
    """The RunnerConfig `scripts/main_torch.py` runs a preset with (as
    `scripts/main.py` builds it for `qtos_tpu`): the preset's speed and gait,
    its raised swing apex over rough segments, its terrain-aware pacing,
    controller profile and friction, and exp_8's obstacle spawns."""
    from qtos_torch.control.loop import control_profile, gait_control_params

    cfg = RunnerConfig(avg_speed=exp.avg_speed, gait=exp.gait, realtime=realtime)
    if exp.swing_clearance > cfg.solver.swing_clearance:
        # terrain-adaptive: only windows crossing a height discontinuity
        # solve with the raised apex (see RunnerConfig.rough_clearance)
        cfg.rough_clearance = exp.swing_clearance
    cfg.rough_pace = exp.rough_pace
    if exp.control_profile:
        cfg.control = control_profile(exp.control_profile)
    if exp.friction != 1.0:
        base = cfg.control if cfg.control is not None else gait_control_params(exp.gait)
        cfg.control = dataclasses.replace(base, sim=dataclasses.replace(base.sim, friction=exp.friction))
    if exp.dynamic_terrain:
        # exp_8: spawn a box obstacle mid-run (reference QTOS/simulation.py:
        # 102-115 update -> GEOM_BOX at (1.0 + idx, 0, 0.24)); the solver and
        # sim take terrain as data.  Spawn cadence: ~1 m of reaction distance
        # ahead of the robot, like the reference's fixed (1.0 + idx, 0) spawn
        # line; a box dropped nearly underfoot is a crash in any stack.
        from qtos_torch.terrain.heightfield import add_box_obstacle

        def terrain_update(window, terr):
            if window in (2, 4):
                x = 2.0 + 1.0 * (window // 2 - 1)
                print(f"[dynamic terrain] spawning obstacle at x={x:.1f}")
                return add_box_obstacle(terr, x, 0.0)
            return terr

        cfg.terrain_update = terrain_update
    return cfg


@dataclass(frozen=True)
class OneshotPlan:
    """The sizes and solver settings of the one-shot mode's whole-path plan."""

    duration: float
    K: int
    solver: SolverConfig


ONESHOT_KNOT_DT = 0.0625


def oneshot_plan(goal_xy, avg_speed: float) -> OneshotPlan:
    """The one-shot mode's single plan of the whole path from a standing
    start at the origin (reference `-t` run_default, main.py:105-137, which
    takes 4.0 s a tile): the time to walk to the goal at `avg_speed`, at
    least 2.5 s, knots ONESHOT_KNOT_DT apart, 80 LM iterations to a
    violation of 5e-3."""
    duration = max(2.5, float(np.hypot(goal_xy[0], goal_xy[1])) / avg_speed)
    K = int(round(duration / ONESHOT_KNOT_DT)) + 1
    return OneshotPlan(duration=duration, K=K, solver=SolverConfig(max_iters=80, tol=5e-3))
