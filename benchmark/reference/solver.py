"""The plain reference of the gait solver, the replan core and the sampler.

The Levenberg-Marquardt loop, the rescue pass and the final selection follow
`qtos_torch/solver/solve.py` (`_solve_pass`, `solve_batch`) and the replan
core follows `qtos_torch/control/replan.py` (`_plan_batch_core`,
`spec_from_row`) and `qtos_torch/control/loop.py` (`decode_row`), all at
commit 89ed971, written here in plain PyTorch:

- the Gauss-Newton system is the frozen copy of the port's closed-form
  blocks (`normal_eq.knot_normal` + `normal_eq.interval_normal`), summed as
  the port's `assemble_plain` sums them;
- each damped system is solved by block Thomas: each pivot block factored
  column by column (pivots clamped at 1e-12, the port's rule), triangular
  solves by the library (`torch.linalg.solve_triangular`), the Schur
  complements and right-hand sides by matrix products;
- violations, initial guess and sampler are the frozen copies beside this
  file.

Everything is float32.  `precision("tf32")` runs the same code with the
matrix products in TF32: the benchmark's control, the nearest precision
below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .gait import make_schedule
from .heightfield import Terrain, height_at, slope_terrain
from .normal_eq import interval_normal, knot_normal
from .sampler import sample_trajectory
from .spec import NV, ProblemSpec, RobotState, SolverConfig, Weights, index_spec
from .transcription import initial_guess, knot_aux, max_violation, violations

STATUS_CONVERGED = 0
STATUS_MAX_ITERS = 1


PRODUCTS = {"matmul", "__matmul__", "__rmatmul__", "bmm", "mm", "mv", "einsum", "addmm", "baddbmm", "linear",
            "tensordot"}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit significand (to nearest, ties to
    even), as the tensor cores round a product's operands."""
    bits = x.view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Products(torch.overrides.TorchFunctionMode):
    """Every matrix product's float32 operands rounded to TF32 first, its
    sums in float32: TF32 whatever kernel the library picks (at small
    batches it picks kernels that do not use TF32 at all)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in PRODUCTS:
            def r(a):
                if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
                    return round_tf32(a)
                if isinstance(a, (list, tuple)):
                    return type(a)(r(b) for b in a)
                return a
            args = tuple(r(a) for a in args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def precision(name: str):
    """``"float32"``: matrix products in full float32 (TF32 off), as the
    configuration states; ``"tf32"``: every matrix product in TF32, the
    control."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        if name == "tf32":
            with _TF32Products():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def terrain(grid: torch.Tensor, cfg: dict) -> Terrain:
    """The reference's terrain over the benchmark's height grid, placed as
    the configuration states."""
    return Terrain(height=grid, resolution=cfg["terrain_resolution"], origin=tuple(cfg["terrain_origin"]))


def solver_config(d: dict) -> SolverConfig:
    """The reference's `SolverConfig` with every field as the configuration
    file states it."""
    return SolverConfig(**{**d, "rom_box": tuple(d["rom_box"]), "weights": Weights(**d["weights"])})


@dataclasses.dataclass(frozen=True)
class Result:
    x: torch.Tensor              # (B, K, NV)
    status: torch.Tensor         # (B,) int32
    max_violation: torch.Tensor  # (B,)
    viol: dict                   # family -> (B,)


def assemble(x, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig, aux, slope):
    """The batch's block-tridiagonal Gauss-Newton system and merit."""
    D, g, sq_k = knot_normal(x, aux, spec, terrain, cfg, slope)
    c = spec.schedule.contact
    Daa, Dbb, L, ga, gb, sq_i = interval_normal(x[:, :-1], x[:, 1:], c[:, :-1], c[:, 1:], spec, cfg)
    D[:, :-1] += Daa
    D[:, 1:] += Dbb
    g[:, :-1] += ga
    g[:, 1:] += gb
    return D, L, g, 0.5 * (sq_k.sum(-1) + sq_i.sum(-1))


def cholesky(A):
    """Lower Cholesky factor of each SPD block of A (B, n, n), column by
    column, each pivot clamped at 1e-12 before its square root (the pivot
    rule of the port's block solve)."""
    n = A.shape[-1]
    A = A.clone()
    factor = torch.zeros_like(A)
    for j in range(n):
        col = A[:, j:, j] / torch.sqrt(torch.clamp(A[:, j, j], min=1e-12))[:, None]
        factor[:, j:, j] = col
        A[:, j:, j:] -= col[:, :, None] * col[:, None, :]
    return factor


def _spd_solve(factor, R):
    """S^-1 R from S's lower factor."""
    y = torch.linalg.solve_triangular(factor, R, upper=False)
    return torch.linalg.solve_triangular(factor.transpose(-1, -2), y, upper=True)


def btd_solve(D, L, b):
    """x of H x = b, H the SPD block-tridiagonal matrix with diagonal blocks
    D (B, K, n, n) and sub-diagonal blocks L (B, K-1, n, n): block Thomas,
    the Schur complements and right-hand sides updated by matrix products."""
    K = D.shape[1]
    factors, ys = [cholesky(D[:, 0])], [b[:, 0, :, None]]
    for k in range(1, K):
        Lk = L[:, k - 1]
        factors.append(cholesky(D[:, k] - Lk @ _spd_solve(factors[-1], Lk.transpose(-1, -2))))
        ys.append(b[:, k, :, None] - Lk @ _spd_solve(factors[-2], ys[-1]))
    xs = [_spd_solve(factors[-1], ys[-1])]
    for k in range(K - 2, -1, -1):
        xs.append(_spd_solve(factors[k], ys[k] - L[:, k].transpose(-1, -2) @ xs[-1]))
    return torch.stack(xs[::-1], dim=1)[..., 0]


def _finite(x) -> None:
    """Raise on knots that are not finite: the terrain lookups index by them."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError("reference: the LM iterate is not finite")


def solve_pass(specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig, x0=None) -> Result:
    """`cfg.max_iters` LM iterations, each candidate step judged by the next
    iteration's merit, then the final choice between the best accepted
    point and the last trial point by max violation."""
    if x0 is None:
        x0 = initial_guess(specs, terrain, cfg)
    B, K, _ = x0.shape
    dev, dt_ = x0.device, x0.dtype
    aux = knot_aux(specs, terrain, cfg)
    slope = slope_terrain(terrain, cfg.slope_probe_d)
    x, x_best = x0, x0
    D_b = torch.zeros((B, K, NV, NV), dtype=dt_, device=dev)
    L_b = torch.zeros((B, K - 1, NV, NV), dtype=dt_, device=dev)
    g_b = torch.zeros((B, K, NV), dtype=dt_, device=dev)
    merit_b = torch.full((B,), float("inf"), dtype=dt_, device=dev)
    lm = torch.full((B,), cfg.lm_init, dtype=dt_, device=dev)
    for _ in range(cfg.max_iters):
        _finite(x)
        D, L, g, merit = assemble(x, specs, terrain, cfg, aux, slope)
        accept = merit < merit_b
        a3, a4 = accept[:, None, None], accept[:, None, None, None]
        x_best = torch.where(a3, x, x_best)
        D_b = torch.where(a4, D, D_b)
        L_b = torch.where(a4, L, L_b)
        g_b = torch.where(a3, g, g_b)
        merit_b = torch.where(accept, merit, merit_b)
        lm = torch.clamp(torch.where(accept, lm * cfg.lm_down, lm * cfg.lm_up), cfg.lm_min, cfg.lm_max)
        damp = lm[:, None, None] * torch.diagonal(D_b, dim1=-2, dim2=-1) + 1e-8
        x = x_best + btd_solve(D_b + torch.diag_embed(damp), L_b, -g_b)

    _finite(x)
    viol_b = violations(x_best, specs, terrain, cfg)
    viol_t = violations(x, specs, terrain, cfg)
    mv_b, mv_t = max_violation(viol_b), max_violation(viol_t)
    take_t = mv_t < mv_b
    max_v = torch.minimum(mv_b, mv_t)
    return Result(
        x=torch.where(take_t[:, None, None], x, x_best),
        status=torch.where(max_v < cfg.tol, STATUS_CONVERGED, STATUS_MAX_ITERS).to(torch.int32),
        max_violation=max_v,
        viol={k: torch.where(take_t, viol_t[k], viol_b[k]) for k in viol_b},
    )


def solve_batch(specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig) -> Result:
    """A pass of `cfg.max_iters`; with ``cfg.rescue_iters > 0`` the
    unconverged windows then run that many more iterations from their
    pass-1 point and keep the result where the violation improved."""
    res = solve_pass(specs, terrain, cfg.replace(rescue_iters=0))
    bad = torch.nonzero(res.status != STATUS_CONVERGED).flatten()
    if cfg.rescue_iters <= 0 or bad.numel() == 0:
        return res
    res2 = solve_pass(index_spec(specs, bad), terrain,
                      cfg.replace(max_iters=cfg.rescue_iters, rescue_iters=0), res.x[bad])
    keep = res2.max_violation < res.max_violation[bad]
    upd = bad[keep]

    def merge(old, new):
        out = old.clone()
        out[upd] = new[keep]
        return out

    return Result(x=merge(res.x, res2.x), status=merge(res.status, res2.status),
                  max_violation=merge(res.max_violation, res2.max_violation),
                  viol={k: merge(res.viol[k], res2.viol[k]) for k in res.viol})


def spec_from_rows(rows, goal_r, goal_yaw, K: int, duration: float, gait: str) -> ProblemSpec:
    """A batched spec from 37-column start rows (k, 37):
    [t, r(3), euler(3), feet(12), v(3), omega(3), forces(12)]."""
    k = rows.shape[0]
    start = RobotState(r=rows[:, 1:4], eul=rows[:, 4:7], v=rows[:, 19:22], omega=rows[:, 22:25],
                       feet=rows[:, 7:19].reshape(k, 4, 3))
    dt = duration / (K - 1)
    sched = make_schedule(gait, K, dt, device=rows.device)
    sched = dataclasses.replace(
        sched, **{f.name: getattr(sched, f.name).expand((k,) + getattr(sched, f.name).shape[-2:]).contiguous()
                  for f in dataclasses.fields(sched)})
    return ProblemSpec(start=start, goal_r=goal_r, goal_yaw=goal_yaw,
                       duration=torch.full((k,), duration, dtype=rows.dtype, device=rows.device),
                       schedule=sched, dt=dt)


def _rot_xy(v, ca, sa):
    return torch.stack([ca * v[..., 0] - sa * v[..., 1], sa * v[..., 0] + ca * v[..., 1]], dim=-1)


def replan_specs(rows, goals_r, goals_yaw, terrain: Terrain, K: int, duration: float, gait: str,
                 drift3=None, dyaw=None) -> ProblemSpec:
    """The specs of one replan's k candidate windows: the start rows (k, 37)
    shifted by `drift3` and turned by `dyaw` (zero when not given), z
    re-seated on the terrain."""
    k = rows.shape[0]
    f32 = dict(dtype=rows.dtype, device=rows.device)
    drift3 = torch.zeros(3, **f32) if drift3 is None else drift3
    dyaw = torch.zeros((), **f32) if dyaw is None else dyaw
    feet_pre = rows[:, 7:19].reshape(k, 4, 3)
    r_pre = rows[:, 1:4]
    r = r_pre + drift3
    yaw = rows[:, 6] + dyaw
    feet = feet_pre + drift3
    ca, sa = torch.cos(dyaw), torch.sin(dyaw)
    feet_xy = r[:, None, :2] + _rot_xy(feet[:, :, :2] - r[:, None, :2], ca, sa)
    h_pre = height_at(terrain, feet_pre[..., 0], feet_pre[..., 1])
    h_post = height_at(terrain, feet_xy[..., 0], feet_xy[..., 1])
    feet_z = feet[..., 2] + (h_post - h_pre)
    r_z = r[:, 2] + (height_at(terrain, r[:, 0], r[:, 1]) - height_at(terrain, r_pre[:, 0], r_pre[:, 1]))
    feet = torch.cat([feet_xy, feet_z[..., None]], dim=-1)
    rows = torch.cat([rows[:, 0:1], r[:, :2], r_z[:, None], rows[:, 4:6], yaw[:, None],
                      feet.reshape(k, 12), _rot_xy(rows[:, 19:21], ca, sa), rows[:, 21:]], dim=-1)
    return spec_from_rows(rows, goals_r, goals_yaw, K, duration, gait)


def plan_windows(specs: ProblemSpec, t0s, terrain: Terrain, cfg: SolverConfig):
    """One replan: one LM pass over the candidates' specs, and the 1 kHz
    tables and contacts of its knots."""
    res = solve_pass(specs, terrain, cfg.replace(rescue_iters=0))
    tables, contacts = sample_trajectory(res.x, specs, hz=1000, t0=t0s)
    return res, tables, contacts


def merit(x, specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig) -> torch.Tensor:
    """(B,) the LM loop's merit of given knots: half the sum of squares of
    the weighted residuals."""
    aux = knot_aux(specs, terrain, cfg)
    return assemble(x, specs, terrain, cfg, aux, slope_terrain(terrain, cfg.slope_probe_d))[3]


def evaluate(x, specs: ProblemSpec, t0s, terrain: Terrain, cfg: SolverConfig):
    """What a replan reports of given knots: their violations, and their
    1 kHz tables and contacts."""
    tables, contacts = sample_trajectory(x, specs, hz=1000, t0=t0s)
    return violations(x, specs, terrain, cfg), tables, contacts
