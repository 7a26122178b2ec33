"""Carry `qtos_tpu` objects across to the port, and results back.

The inputs are `qtos_tpu`'s `ProblemSpec`, `Terrain` and `SolverConfig` with
numpy leaves (e.g. after ``jax.tree_util.tree_map(np.asarray, obj)``); they
are read by attribute, so this module needs neither JAX nor `qtos_tpu`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qtos_torch.device import resolve_device
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
