"""Batched Gauss-Newton / Levenberg-Marquardt gait solver (port of
`qtos_tpu.solver.solve`).

Per iteration: batch-major assembly of the block-tridiagonal normal
equations (`solver.assemble`, the CUDA kernel on the card) -> diagonal damping -> one batched BTD solve
(`ops.btd.btd_solve`, the CUDA kernel on the card) -> per-scenario
accept/reject.  A fixed iteration count keeps every scenario on the same
instruction stream.
"""

from __future__ import annotations

import dataclasses

import torch

from qtos_torch.ops.btd import btd_solve
from qtos_torch.ops.lm_restore import restore_rejected
from qtos_torch.solver.assemble import assemble
from qtos_torch.solver.spec import ProblemSpec, SolverConfig, index_spec, map_tensors
from qtos_torch.solver.transcription import initial_guess, knot_aux, max_violation, violations
from qtos_torch.terrain.heightfield import Terrain, slope_terrain
from qtos_torch.utils.profiling import annotate

STATUS_CONVERGED = 0
STATUS_MAX_ITERS = 1


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor              # (B, K, NV) optimized knot trajectories
    status: torch.Tensor         # (B,) int32: 0 converged, 1 hit max iters
    merit: torch.Tensor          # (B,) best accepted 0.5*||rho||^2 (diagnostic)
    max_violation: torch.Tensor  # (B,) max physical constraint violation
    viol: dict                   # per-family violations, each (B,)
    iters: torch.Tensor          # (B,) int32 iterations run


def _check_batch(specs: ProblemSpec, terrain: Terrain):
    if specs.goal_r.dim() != 2:
        raise ValueError("solve_batch takes a batched ProblemSpec (goal_r of shape (B, 3))")
    if specs.goal_r.device != terrain.device:
        raise ValueError(f"specs on {specs.goal_r.device}, terrain on {terrain.device}")


def _solve_pass(specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig,
                x0: torch.Tensor | None = None) -> SolveResult:
    """`cfg.max_iters` delayed-gratification LM iterations, then the final
    selection by max violation.

    The best accepted point's system is kept by reference: each iteration's
    freshly assembled D, L, g are updated in place, where the step was
    rejected, to the kept system (`ops.lm_restore.restore_rejected`, one
    launch of the restore kernel on the card) and are then kept themselves.
    `qtos_tpu`'s loop is pure and selects whole arrays by `jnp.where`; the
    values are the same bit for bit, without the full-size copies."""
    B = specs.goal_r.shape[0]
    with annotate("qtos::solve.pass", B):
        with annotate("qtos::solve.presolve", B):
            if x0 is None:
                x0 = initial_guess(specs, terrain, cfg)
            dev, dt_ = x0.device, x0.dtype
            aux = knot_aux(specs, terrain, cfg)
            slope = slope_terrain(terrain, cfg.slope_probe_d)   # the slope grid, once per pass

            # One residual/Jacobian evaluation per iteration: the candidate step is
            # evaluated by the NEXT iteration's assembly; on rejection the solver
            # reverts to the stored system of the last accepted point.
            x, x_best = x0, x0
            kept = None   # (D, L, g) of each window's best accepted point
            merit_b = torch.full((B,), float("inf"), dtype=dt_, device=dev)
            lm = torch.full((B,), cfg.lm_init, dtype=dt_, device=dev)
        for _ in range(cfg.max_iters):
            with annotate("qtos::lm.iter", B) as span:
                D, L, g, merit = assemble(x, specs, terrain, cfg, aux, slope)
                accept = merit < merit_b                                       # (B,)
                span.set(accepted=accept)
                # rejected windows take the kept system back (zeros before any is kept),
                # in place; the fresh tensors then are the kept ones
                restore_rejected(accept, (D, L, g), kept)
                kept = (D, L, g)
                x_best = torch.where(accept[:, None, None], x, x_best)
                merit_b = torch.where(accept, merit, merit_b)
                lm = torch.clamp(torch.where(accept, lm * cfg.lm_down, lm * cfg.lm_up),
                                 cfg.lm_min, cfg.lm_max)
                damp = lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8
                dx = btd_solve(D + torch.diag_embed(damp), L, -g)
                x = x_best + dx

        # Final selection between the best ACCEPTED point and the last trial
        # point is by max constraint VIOLATION, not merit: merit trades the
        # constraint families against goal/regularization terms, so a
        # lower-merit iterate can carry a higher dynamics defect.
        with annotate("qtos::solve.select", B):
            viol_b = violations(x_best, specs, terrain, cfg)
            viol_t = violations(x, specs, terrain, cfg)
            mv_b, mv_t = max_violation(viol_b), max_violation(viol_t)
            take_t = mv_t < mv_b
            x_out = torch.where(take_t[:, None, None], x, x_best)
            viol = {k: torch.where(take_t, viol_t[k], viol_b[k]) for k in viol_b}
            max_v = torch.minimum(mv_b, mv_t)
            status = torch.where(max_v < cfg.tol, STATUS_CONVERGED, STATUS_MAX_ITERS).to(torch.int32)
            return SolveResult(
                x=x_out,
                status=status,
                # diagnostics only: the best ACCEPTED merit, as qtos_tpu's lanes path
                merit=merit_b,
                max_violation=max_v,
                viol=viol,
                iters=torch.full((B,), cfg.max_iters, dtype=torch.int32, device=dev),
            )


def solve_batch(specs: ProblemSpec, terrain: Terrain,
                cfg: SolverConfig = SolverConfig()) -> SolveResult:
    """Solve a batch of specs (leading axis B) on one terrain.

    With ``cfg.rescue_iters > 0`` a second pass re-solves the scenarios the
    first left unconverged: they are gathered, warm-started from their pass-1
    iterate, run ``rescue_iters`` more LM iterations, and written back only
    where the violation improved.

    `qtos_tpu` pads the gathered set to a power-of-two cap of at least
    ``B // rescue_frac`` (and at least the number of failures) so that XLA
    compiles few program shapes; the padding slots are dropped on scatter.
    Scenarios are independent, so gathering exactly the failed indices gives
    the same result; PyTorch runs eagerly and needs no shape buckets.
    """
    _check_batch(specs, terrain)
    with annotate("qtos::solve_batch", specs.goal_r.shape[0]):
        pass1_cfg = cfg.replace(rescue_iters=0) if cfg.rescue_iters > 0 else cfg
        res = _solve_pass(specs, terrain, pass1_cfg)
        if cfg.rescue_iters <= 0:
            return res
        bad = torch.nonzero(res.status != STATUS_CONVERGED).flatten()
        if bad.numel() == 0:
            return res

        cfg2 = cfg.replace(max_iters=cfg.rescue_iters, rescue_iters=0)
        res2 = _solve_pass(index_spec(specs, bad), terrain, cfg2, res.x[bad])
        improved = res2.max_violation < res.max_violation[bad]
        upd = bad[improved]

        def merge(old, new):
            out = old.clone()
            out[upd] = new[improved]
            return out

        return SolveResult(
            x=merge(res.x, res2.x),
            status=merge(res.status, res2.status),
            merit=merge(res.merit, res2.merit),
            max_violation=merge(res.max_violation, res2.max_violation),
            viol={k: merge(res.viol[k], res2.viol[k]) for k in res.viol},
            iters=merge(res.iters, res.iters[bad] + res2.iters),
        )


def solve(spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig = SolverConfig()) -> SolveResult:
    """Solve one (unbatched) gait window: `solve_batch` with B = 1, results
    without the batch axis."""
    res = solve_batch(map_tensors(spec, lambda t: t[None]), terrain, cfg)
    return map_tensors(res, lambda t: t[0])
