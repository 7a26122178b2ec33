"""Carry `qtos_tpu` objects across to the port, and results back.

The inputs are `qtos_tpu`'s `ProblemSpec`, `Terrain`, `SolverConfig`,
`SimState`, `MotorParams`, `SimParams`, `ControlParams` and `RunnerConfig`
with numpy leaves (e.g. after ``jax.tree_util.tree_map(np.asarray, obj)``),
and the dict its runner's ``state_dict()`` returns; they are read by
attribute or key, so this module needs neither JAX nor `qtos_tpu`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qtos_torch.control.loop import ControlParams
from qtos_torch.control.replan import SIM_LEAVES, RunnerConfig
from qtos_torch.device import resolve_device
from qtos_torch.sim.engine import SimParams, SimState
from qtos_torch.sim.motor import MotorParams
from qtos_torch.solver.gait import GaitSchedule
from qtos_torch.solver.spec import ProblemSpec, RobotState, SolverConfig, Weights
from qtos_torch.terrain.heightfield import Terrain


def _t(a, dev):
    return torch.tensor(np.array(a, dtype=np.float32), device=dev)


def terrain_from_reference(terrain, device=None) -> Terrain:
    dev = resolve_device(device)
    return Terrain(
        height=_t(terrain.height, dev),
        resolution=float(terrain.resolution),
        origin=tuple(float(o) for o in terrain.origin),
    )


def spec_from_reference(spec, device=None) -> ProblemSpec:
    """A `qtos_tpu` ProblemSpec (batched or not) with numpy leaves."""
    dev = resolve_device(device)
    st = spec.start
    return ProblemSpec(
        start=RobotState(
            r=_t(st.r, dev), eul=_t(st.eul, dev), v=_t(st.v, dev),
            omega=_t(st.omega, dev), feet=_t(st.feet, dev),
        ),
        goal_r=_t(spec.goal_r, dev),
        goal_yaw=_t(spec.goal_yaw, dev),
        duration=_t(spec.duration, dev),
        schedule=GaitSchedule(
            contact=_t(spec.schedule.contact, dev),
            swing_progress=_t(spec.schedule.swing_progress, dev),
        ),
        dt=float(spec.dt),
    )


def config_from_reference(cfg) -> SolverConfig:
    """A `qtos_tpu` SolverConfig (its numeric fields may be 0-d arrays)."""
    ints = {"max_iters", "rescue_iters", "rescue_frac"}
    kw = {}
    for f in dataclasses.fields(SolverConfig):
        val = getattr(cfg, f.name)
        if f.name == "weights":
            val = Weights(**{w.name: float(getattr(val, w.name)) for w in dataclasses.fields(Weights)})
        elif f.name == "rom_box":
            val = tuple(float(v) for v in np.asarray(val).reshape(-1))
        else:
            val = int(val) if f.name in ints else float(val)
        kw[f.name] = val
    return SolverConfig(**kw)


def sim_state_from_reference(state, device=None) -> SimState:
    """A `qtos_tpu` SimState (batched or not) with numpy leaves."""
    dev = resolve_device(device)
    return SimState(**{f.name: _t(getattr(state, f.name), dev) for f in dataclasses.fields(SimState)})


def _floats_from(cls, obj):
    return cls(**{f.name: float(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def motor_params_from_reference(params) -> MotorParams:
    return _floats_from(MotorParams, params)


def sim_params_from_reference(params) -> SimParams:
    return _floats_from(SimParams, params)


def control_params_from_reference(params) -> ControlParams:
    """A `qtos_tpu` ControlParams, static fields (`sim.dt`, `use_force_ff`,
    `frame`) included."""
    kw = {}
    for f in dataclasses.fields(ControlParams):
        val = getattr(params, f.name)
        if f.name == "motor":
            kw[f.name] = motor_params_from_reference(val)
        elif f.name == "sim":
            kw[f.name] = sim_params_from_reference(val)
        elif f.name == "use_force_ff":
            kw[f.name] = bool(val)
        elif f.name == "frame":
            kw[f.name] = str(val)
        else:
            kw[f.name] = float(val)
    return ControlParams(**kw)


def runner_config_from_reference(cfg) -> RunnerConfig:
    """A `qtos_tpu` RunnerConfig.  `terrain_update` is carried as it is: a
    hook written for `qtos_tpu` terrains must be replaced by the caller."""
    kw = {}
    for f in dataclasses.fields(RunnerConfig):
        val = getattr(cfg, f.name)
        if f.name == "solver":
            val = config_from_reference(val)
        elif f.name == "control":
            val = None if val is None else control_params_from_reference(val)
        elif f.name not in ("terrain_update", "gait", "checkpoint_path"):
            val = type(f.default)(val)          # int, float or bool, as declared
        kw[f.name] = val
    return RunnerConfig(**kw)


_RUNNER_STATE_KEYS = (
    "buffer", "contact_buf", "buffer_end", "exec_idx", "window", "planning_done", "prev_x",
    "row_shift", "com_errs", "ee_errs", "sim_pos", "sim_feet", "solve_times", "statuses",
    "consec_failures", "consec_diverged", "stance_holds", "archive",
)


def runner_state_from_reference(d: dict) -> dict:
    """The dict of `qtos_tpu`'s ``RecedingHorizonRunner.state_dict()`` (numpy
    arrays, as its ``save_checkpoint`` writes them) as the dict the port's
    ``load_state_dict`` takes: a checkpoint written by `qtos_tpu` resumes in
    `qtos_torch`.

    The two packages use the same keys.  `qtos_tpu` numbers the simulator's
    leaves ``sim_<i>`` in the order JAX flattens its SimState, which is
    `SIM_LEAVES`; this checks that every leaf is there with its shape, copies
    every array (so the result shares no memory with the source) and drops
    nothing else.
    """
    leaf_shapes = dict(pos=(3,), quat=(4,), v=(3,), w=(3,), q=(12,), qd=(12,), anchor=(4, 2))
    out = {}
    for key in _RUNNER_STATE_KEYS:
        if key not in d:
            raise KeyError(f"runner state lacks {key!r}")
        out[key] = np.array(d[key])
    for i, name in enumerate(SIM_LEAVES):
        key = f"sim_{i}"
        if key not in d:
            raise KeyError(f"runner state lacks {key!r} (SimState.{name})")
        leaf = np.array(d[key], dtype=np.float32)
        if leaf.shape != leaf_shapes[name]:
            raise ValueError(f"{key} should be SimState.{name} of shape {leaf_shapes[name]}, got {leaf.shape}")
        out[key] = leaf
    if f"sim_{len(SIM_LEAVES)}" in d:
        raise ValueError(f"runner state has more than {len(SIM_LEAVES)} simulator leaves")
    for key in ("buffer", "contact_buf", "prev_x", "row_shift", "archive"):
        out[key] = out[key].astype(np.float32)
    return out


def to_numpy(obj):
    """Tensors -> numpy arrays through dataclasses and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    return obj
