"""Batch-major Gauss-Newton assembly: (B, K, ...) counterpart of
`qtos_tpu.solver.assemble_lanes`, with the semantics of
`qtos_tpu.solver.normal_eq`.

The knot and interval blocks come from `qtos_torch.solver.normal_eq`, which
assembles D = J^T J, L and g = J^T rho directly from closed-form (3, 3)
block contributions with leading (B, K) axes; here they are summed into the
block-tridiagonal system of the batch.
"""

from __future__ import annotations

from qtos_torch.ops import assemble as assemble_ops
from qtos_torch.solver.normal_eq import interval_normal, knot_normal
from qtos_torch.solver.spec import ProblemSpec, SolverConfig
from qtos_torch.solver.transcription import KnotAux, knot_aux
from qtos_torch.terrain.heightfield import Terrain, slope_terrain


def assemble(x, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig, aux: KnotAux | None = None,
             slope: Terrain | None = None):
    """Full Gauss-Newton system of a batch: x (B, K, NV) ->
    D (B, K, NV, NV), L (B, K-1, NV, NV), g (B, K, NV), merit (B,).

    `aux` and `slope` (`slope_terrain(terrain, cfg.slope_probe_d)`) are built
    here when not given; the solver builds them once per pass."""
    if aux is None:
        aux = knot_aux(spec, terrain, cfg)
    if slope is None:
        slope = slope_terrain(terrain, cfg.slope_probe_d)
    if x.device.type == "cuda":
        return assemble_ops.assemble_kernel(x, spec, terrain, cfg, aux, slope)
    if x.device.type != "cpu":
        raise ValueError(f"assemble runs on cuda (the kernel) or cpu (the plain version), not {x.device}")
    return assemble_plain(x, spec, terrain, cfg, aux, slope)


def assemble_plain(x, spec: ProblemSpec, terrain: Terrain, cfg: SolverConfig, aux: KnotAux, slope: Terrain):
    """The plain version on x's own device: `knot_normal` and
    `interval_normal` summed into the batch's system."""
    D, g, sq_k = knot_normal(x, aux, spec, terrain, cfg, slope)
    c = spec.schedule.contact
    Daa, Dbb, L, ga, gb, sq_i = interval_normal(
        x[:, :-1], x[:, 1:], c[:, :-1], c[:, 1:], spec, cfg
    )
    D[:, :-1] += Daa
    D[:, 1:] += Dbb
    g[:, :-1] += ga
    g[:, 1:] += gb
    merit = 0.5 * (sq_k.sum(-1) + sq_i.sum(-1))
    return D, L, g, merit
