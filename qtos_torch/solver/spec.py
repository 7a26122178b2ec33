"""Problem specification for one gait-optimization window (port of
`qtos_tpu.solver.spec`).

A batch of windows is one `ProblemSpec` whose tensors carry a leading batch
axis (B): `start.r` is (B, 3), `schedule.contact` is (B, K, 4), and so on.
`dt` is a plain float shared by the batch.
"""

from __future__ import annotations

import dataclasses

import torch

from qtos_torch.device import resolve_device
from qtos_torch.models.solo12 import Solo12
from qtos_torch.solver.gait import GaitSchedule, trot_schedule
from qtos_torch.terrain.heightfield import Terrain, height_at

# State layout per knot: [r(3), eul(3), v(3), omega(3), feet(12), forces(12)]
NV = 36
IDX_R = slice(0, 3)
IDX_TH = slice(3, 6)
IDX_V = slice(6, 9)
IDX_W = slice(9, 12)
IDX_P = slice(12, 24)
IDX_F = slice(24, 36)
FORCE_SCALE = 5.0  # forces stored as f / FORCE_SCALE to condition the KKT blocks


@dataclasses.dataclass(frozen=True)
class RobotState:
    """Boundary state of the base + feet (world frame)."""

    r: torch.Tensor        # (..., 3) CoM position
    eul: torch.Tensor      # (..., 3) roll, pitch, yaw
    v: torch.Tensor        # (..., 3) CoM linear velocity
    omega: torch.Tensor    # (..., 3) world angular velocity
    feet: torch.Tensor     # (..., 4, 3) foot positions

    @staticmethod
    def standing(xy=(0.0, 0.0), yaw=0.0, terrain: Terrain | None = None,
                 height: float = Solo12.stand_height, device=None):
        """Canonical start: feet at nominal xy on the ground, base `height` above.

        `xy`'s components and `yaw` may be tensors or arrays of one shape
        (...): the state's leaves then carry those leading axes."""
        dev = _device_for(terrain, device)
        f32 = dict(dtype=torch.float32, device=dev)
        x, y, yaw = torch.broadcast_tensors(
            torch.as_tensor(xy[0], **f32), torch.as_tensor(xy[1], **f32), torch.as_tensor(yaw, **f32)
        )
        nominal = Solo12.tensors(dev).nominal_feet
        fx = nominal[:, 0] + x[..., None]
        fy = nominal[:, 1] + y[..., None]
        if terrain is not None:
            fz = height_at(terrain, fx, fy)
            base_z = height_at(terrain, x, y) + height
        else:
            fz = torch.zeros_like(fx)
            base_z = torch.full_like(x, height)
        zero = torch.zeros_like(x)
        return RobotState(
            r=torch.stack([x, y, base_z], -1),
            eul=torch.stack([zero, zero, yaw], -1),
            v=torch.zeros(x.shape + (3,), **f32),
            omega=torch.zeros(x.shape + (3,), **f32),
            feet=torch.stack([fx, fy, fz], -1),
        )


@dataclasses.dataclass(frozen=True)
class Weights:
    """Residual weights (static hyperparameters)."""

    dyn_r: float = 20.0
    dyn_th: float = 20.0
    dyn_v: float = 4.0
    dyn_w: float = 2.0
    stat: float = 40.0          # stance feet do not move
    terr: float = 60.0          # stance feet on terrain surface
    fzero: float = 20.0         # swing feet carry no force (scaled force units)
    init: float = 60.0
    goal: float = 8.0
    fric: float = 10.0          # friction pyramid hinge
    rom: float = 25.0           # kinematic box hinge
    clear: float = 15.0         # swing apex shaping
    body: float = 30.0          # base clearance over terrain under the body
    acc_reg: float = 0.05
    f_reg: float = 0.03
    footvel_reg: float = 0.5
    post_reg: float = 0.15      # keep feet near nominal under base
    slope: float = 25.0         # stance feet off steep terrain (riser edges)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver hyperparameters; the defaults are those of `qtos_tpu`, whose
    docstrings record how each was measured."""

    max_iters: int = 30
    # Compacted second pass over the unconverged scenarios, warm-started from
    # their pass-1 iterate, `rescue_iters` more LM iterations (0 disables).
    rescue_iters: int = 0
    # Kept for configuration parity; the port gathers exactly the failed
    # scenarios, so it sets no cap (see solve.solve_batch).
    rescue_frac: int = 8
    tol: float = 2e-3           # max unweighted constraint violation for "converged"
    lm_init: float = 1e-4
    lm_min: float = 1e-7
    lm_max: float = 1e3
    lm_down: float = 0.75
    lm_up: float = 2.0
    swing_clearance: float = 0.06
    body_clearance: float = 0.12
    mu_friction: float = 0.7
    slope_margin: float = 1.6
    slope_probe_d: float = 0.06
    f_max: float = 30.0         # N, per-leg normal force cap
    rom_box: tuple = (0.14, 0.08, 0.10)
    weights: Weights = dataclasses.field(default_factory=Weights)

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """One window of the receding-horizon problem, or a batch of them."""

    start: RobotState
    goal_r: torch.Tensor           # (..., 3) target CoM position
    goal_yaw: torch.Tensor         # (...,) target yaw
    duration: torch.Tensor         # (...,) window length in seconds
    schedule: GaitSchedule         # (..., K, 4) masks
    dt: float = 0.0625

    @property
    def num_knots(self):
        return self.schedule.contact.shape[-2]


def map_tensors(obj, fn):
    """Apply `fn` to every tensor leaf of a (nested) dataclass or dict."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: map_tensors(getattr(obj, f.name), fn) for f in dataclasses.fields(obj)}
        )
    return obj


def index_spec(specs: ProblemSpec, idx) -> ProblemSpec:
    """Select scenarios of a batched spec (`idx` an int or an index tensor)."""
    return map_tensors(specs, lambda t: t[idx])


def _device_for(terrain: Terrain | None, device) -> torch.device:
    dev = resolve_device(device)
    if terrain is not None and terrain.device != dev:
        raise ValueError(f"terrain lives on {terrain.device}, spec asked for {dev}")
    return dev


def default_spec(
    terrain: Terrain | None = None,
    start_xy=(0.0, 0.0),
    goal_xy=(0.6, 0.0),
    duration: float = 2.5,
    K: int = 41,
    yaw: float = 0.0,
    goal_yaw: float = 0.0,
    schedule: GaitSchedule | None = None,
    device=None,
) -> ProblemSpec:
    """A trot window from a standing start to a goal.

    The components of `start_xy` and `goal_xy`, `yaw` and `goal_yaw` may be
    1-D tensors or arrays of length B: the spec is then a batch of B windows
    sharing the schedule, the counterpart of `jax.vmap` over `qtos_tpu`'s
    `default_spec`.
    """
    dev = _device_for(terrain, device)
    f32 = dict(dtype=torch.float32, device=dev)
    dt = duration / (K - 1)
    sched = schedule if schedule is not None else trot_schedule(K, dt, device=dev)
    sx, sy, syaw, gx, gy, gyaw = torch.broadcast_tensors(
        *(torch.as_tensor(v, **f32)
          for v in (start_xy[0], start_xy[1], yaw, goal_xy[0], goal_xy[1], goal_yaw))
    )
    start = RobotState.standing((sx, sy), yaw=syaw, terrain=terrain, device=dev)
    if terrain is not None:
        gz = height_at(terrain, gx, gy) + Solo12.stand_height
    else:
        gz = torch.full_like(gx, Solo12.stand_height)
    batch = gx.shape
    if batch:
        sched = map_tensors(sched, lambda t: t.expand(batch + t.shape[-2:]).contiguous())
    return ProblemSpec(
        start=start,
        goal_r=torch.stack([gx, gy, gz], -1),
        goal_yaw=gyaw.contiguous(),
        duration=torch.full_like(gx, duration),
        schedule=sched,
        dt=dt,
    )


def pack_state(r, th, v, w, p, f):
    """Assemble a (..., K, NV) decision trajectory from components (forces in N)."""
    return torch.cat(
        [r, th, v, w, p.reshape(p.shape[:-2] + (12,)), f.reshape(f.shape[:-2] + (12,)) / FORCE_SCALE],
        dim=-1,
    )


def unpack_state(x):
    """(..., NV) -> dict of physical components (forces in N)."""
    return dict(
        r=x[..., IDX_R],
        th=x[..., IDX_TH],
        v=x[..., IDX_V],
        w=x[..., IDX_W],
        p=x[..., IDX_P].reshape(x.shape[:-1] + (4, 3)),
        f=x[..., IDX_F].reshape(x.shape[:-1] + (4, 3)) * FORCE_SCALE,
    )
