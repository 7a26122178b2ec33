"""Experiment presets (own copy of `qtos_tpu.config.experiments`), mirroring data/config/experiment_*.yml of the reference.

Map vocabulary and per-experiment terrain lists match the reference files
(see each preset's comment).  `mesh_scale` upsamples tiles like the
reference's scale_map (generateHeightField.py:39-56); large scales mainly
matter for visual fidelity, so presets cap it where the reference used 10-11
purely for rendering.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ExperimentConfig:
    name: str
    maps: tuple                     # tile names composed along +x
    goal_xy: tuple                  # world goal
    mesh_scale: int = 1
    random_env: bool = False
    bool_map_search: bool = False   # probe feasibility map with batched solves
    avg_speed: float = 0.22
    gait: str = "trot"              # key into solver.gait.GAIT_REGISTRY
    dynamic_terrain: bool = False   # exp_8: spawn obstacles mid-run
    sim_steps: int = 31000          # reference SIM_STEPS
    # Swing apex clearance [m] fed into the window solver.  The flat/gentle
    # presets keep the default 0.06; the stair presets need 0.14: a sharp
    # 0.11 m riser spans one heightfield cell, and at 0.06 the swing toe
    # clips the riser face (measured on the exp_6 crossing window: err/s 231
    # and a 0.47 m stall at 0.06 vs err/s 73 and -0.11 m at 0.14).
    swing_clearance: float = 0.06
    # Terrain-aware pacing gain (RunnerConfig.rough_pace): window advance is
    # scaled down by the upcoming segment's height span.  Off by default
    # (it regressed exp_2's gentle bands); the stair presets need it — the
    # 0.11 m riser is crossed reliably at ~half-length windows (measured:
    # pace 8 reaches the plateau with one reset; unpaced bounces off the
    # riser and falls within 4 windows).
    rough_pace: float = 0.0
    # Named controller profile (control.loop.control_profile); "" = the
    # per-gait default set.
    control_profile: str = ""
    # Ground friction coefficient for the sim, mirroring the reference's
    # per-experiment `friction` key (data/config/experiment_*.yml: 1.0 for
    # most, 2.0 on rough terrain, 0.99/0.90 on the stair/bridge climbs).
    friction: float = 1.0
    description: str = ""


EXPERIMENTS: dict[str, ExperimentConfig] = {
    # reference: experiment_1_straight_line.yml (['plane','plane'], goal 2.1)
    "exp_1": ExperimentConfig(
        "exp_1", ("plane", "plane"), (2.1, 0.0), mesh_scale=1,
        description="straight line walk on flat ground",
    ),
    # reference: experiment_2_climbing.yml (['step','step_1','step_2','plane'], scale 5)
    "exp_2": ExperimentConfig(
        "exp_2", ("step", "step_1", "step_2", "plane"), (5.6, 0.0), mesh_scale=2,
        sim_steps=21000, description="climbing over steps",
    ),
    # reference: experiment_3_collision_avoidance.yml (feasibility maps, bool_map_search)
    "exp_3": ExperimentConfig(
        "exp_3", ("feasibility", "feasibility_1", "plane"), (3.6, 0.0),
        bool_map_search=True, sim_steps=61000,
        description="collision avoidance around pillars",
    ),
    # reference: experiment_4_rough_terrain.yml (random_terrain x3, scale 5).
    # friction: the reference YAML sets 2.0 (Bullet lateralFriction), but our
    # penalty-contact stiction anchors are a different model — at mu=2.0 a
    # misplaced foot on a bump face sticks hard and levers the body over
    # (measured: 3-seed sweeps 0-1/3 reach the goal at 2.0; at 1.0 the foot
    # slides to relief and the crossing is reliable).  Slow pace + the
    # heavy-damping stairs profile for the 2-7 cm bump field.
    "exp_4": ExperimentConfig(
        "exp_4", ("random_terrain_1", "random_terrain_1", "random_terrain_1"), (3.8, 0.0),
        mesh_scale=2, sim_steps=60000, friction=1.0, avg_speed=0.15,
        control_profile="stairs",
        description="rough random terrain",
    ),
    # reference: experiment_5_extreme_climbing.yml (climb_2, climb_1, scale 11)
    "exp_5": ExperimentConfig(
        "exp_5", ("climb_2", "climb_1"), (2.2, 0.0), mesh_scale=2,
        sim_steps=33000, description="extreme climbing",
    ),
    # reference: experiment_6_stairs.yml (stairs, stairs_1, stairs_1, plane).
    # Slower pace than flat-ground presets: the 0.2 m descent off the last
    # staircase tips the robot at 0.22 m/s (deterministic fall at x=5.2);
    # the reference likewise tunes solver duration/speed per experiment YAML.
    "exp_6": ExperimentConfig(
        "exp_6", ("stair", "stair_1", "stair_1", "plane"), (5.5, 0.0),
        mesh_scale=2, sim_steps=21000, avg_speed=0.15, rough_pace=12.0,
        control_profile="stairs", friction=0.99,
        description="staircases",
    ),
    # reference: experiment_7_climb_obstacle.yml (stairs, bridge).  Slow pace:
    # the 0.25 m bridge climb is the hardest structure in the tile set and
    # the A* approach path bends between the stair bands.  KNOWN LIMITATION
    # (round 5): the route must climb a 0.10 m platform edge right out of a
    # turn, 0.15 m from the 0.25 m wall; 3-seed sweeps across 8 config
    # families (trot/walk gaits, clearance 0.06-0.12, friction 0.90-1.0,
    # pace 12-30, speeds 0.10-0.15) all end with the robot either cutting
    # the curve onto the wall or overshooting north onto the stepped bands —
    # the tracking controller's curve-following error (~±0.3 m) exceeds the
    # corridor width.  The run aborts gracefully via the sim-health watchdog.
    "exp_7": ExperimentConfig(
        "exp_7", ("stair", "bridge"), (2.4, 0.0), mesh_scale=2,
        sim_steps=33000, avg_speed=0.15, rough_pace=12.0,
        control_profile="stairs", friction=0.90,
        description="climb onto a bridge obstacle",
    ),
    # reference: experiment_8_dynamic_terrain.yml (plane, obstacle, plane)
    # Slower pace: mid-run spawns force sharp lateral detours of the spine,
    # which the tracking controller takes reliably at walk-like speeds.
    "exp_8": ExperimentConfig(
        "exp_8", ("plane", "obstacle", "plane"), (3.8, 0.0),
        random_env=True, bool_map_search=True, sim_steps=61000,
        dynamic_terrain=True, avg_speed=0.15,
        description="obstacle field with randomized environment and "
                    "mid-run obstacle spawns (reference simulation.update)",
    ),
    # reference: experiment_9_continous_walking.yml (plane x7)
    "exp_9": ExperimentConfig(
        "exp_9", ("plane",) * 7, (11.5, 0.0), sim_steps=100000,
        description="continuous long-distance walking",
    ),
    # reference: experiment_10_continous_climbing.yml (climb_2/climb_1 x5)
    "exp_10": ExperimentConfig(
        "exp_10", ("climb_2", "climb_1", "climb_2", "climb_1", "climb_2"), (7.5, 0.0),
        mesh_scale=2, sim_steps=100000, description="continuous climbing",
    ),
    # reference: simulation_QTOS_test.yml — headless canned smoke config (-T)
    "test": ExperimentConfig(
        "test", ("plane", "plane"), (1.0, 0.0), sim_steps=5000,
        description="headless smoke test replaying a canned trajectory",
    ),
}


def get_experiment(name: str) -> ExperimentConfig:
    key = name if name in EXPERIMENTS else f"exp_{name}"
    try:
        return EXPERIMENTS[key]
    except KeyError as e:
        raise KeyError(f"unknown experiment {name!r}; known: {sorted(EXPERIMENTS)}") from e
