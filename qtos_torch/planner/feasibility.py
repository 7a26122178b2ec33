"""Solver-probed feasibility map as ONE batched solve (port of
`qtos_tpu.planner.feasibility`).

The candidate (start, goal) cell pairs near obstacles become a stacked
ProblemSpec batch and a single `solve_batch` call; per-scenario obstacle
violations mark traversability.

Probe semantics:
  - candidate pairs are 2-cell hops along +x on every row, enqueued iff
    either endpoint has an obstacle-height cell in its 8-neighborhood;
  - a failed solve stamps the filled radius-3 diamond |dr|+|dc| <= 3 (the
    convex hull of (+-3,0),(0,+-3)) around the start, mid, and goal cells as
    blocked;
  - an all-flat map short-circuits to "everything traversable".
"""

from __future__ import annotations

import numpy as np

from qtos_torch.solver.solve import solve_batch
from qtos_torch.solver.spec import SolverConfig, default_spec
from qtos_torch.terrain.heightfield import Terrain, traversability_map


def _danger_mask(height: np.ndarray, thresh: float = 0.025) -> np.ndarray:
    """Cells with an obstacle-height cell in their 8-neighborhood.

    ``thresh`` separates obstacles from surface texture: randomized
    environments carry 0-2 cm noise EVERYWHERE, and a height>0 test would
    enqueue a probe for every cell of the map."""
    obst = height > thresh
    H, W = obst.shape
    out = np.zeros_like(obst)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            src = obst[
                max(0, -dr) : H - max(0, dr), max(0, -dc) : W - max(0, dc)
            ]
            out[max(0, dr) : H - max(0, -dr), max(0, dc) : W - max(0, -dc)] |= src
    return out


def _candidate_pairs(height: np.ndarray, col_step: int = 2):
    """(start, goal) cell pairs: 2-cell +x hops on every row, near danger."""
    danger = _danger_mask(height)
    H, W = height.shape
    pairs = []
    for r in range(H):
        for c in range(0, W - col_step, col_step):
            if danger[r, c] or danger[r, c + col_step]:
                pairs.append(((r, c), (r, c + col_step)))
    return pairs


def _diamond_offsets(radius: int = 3) -> np.ndarray:
    """Filled |dr|+|dc| <= radius diamond: the convex hull of the
    (+-r, 0), (0, +-r) neighbor set."""
    offs = [
        (dr, dc)
        for dr in range(-radius, radius + 1)
        for dc in range(-radius, radius + 1)
        if abs(dr) + abs(dc) <= radius
    ]
    return np.asarray(offs, np.int64)


def _stamp(blocked: np.ndarray, cell, offsets: np.ndarray) -> None:
    H, W = blocked.shape
    r = cell[0] + offsets[:, 0]
    c = cell[1] + offsets[:, 1]
    keep = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    blocked[r[keep], c[keep]] = True


def probe_specs(terrain: Terrain, window_duration: float = 1.5, K: int = 25, max_batch: int = 8192):
    """The probe's candidate pairs and their stacked ProblemSpec batch on
    the terrain's device: (pairs, specs), specs None when no pair is near an
    obstacle."""
    height = terrain.height.detach().cpu().numpy()
    pairs = _candidate_pairs(height)
    pairs = pairs[:max_batch]
    if not pairs:
        return pairs, None
    x0, y0 = terrain.origin
    res = terrain.resolution

    def cell_xy(cell):
        return (x0 + (cell[1] + 0.5) * res, y0 + (cell[0] + 0.5) * res)

    starts = np.array([cell_xy(p[0]) for p in pairs], np.float32)
    goals = np.array([cell_xy(p[1]) for p in pairs], np.float32)
    specs = default_spec(
        terrain,
        start_xy=(starts[:, 0], starts[:, 1]),
        goal_xy=(goals[:, 0], goals[:, 1]),
        duration=window_duration,
        K=K,
        device=terrain.device,
    )
    return pairs, specs


def feasibility_map(
    terrain: Terrain,
    cfg: SolverConfig | None = None,
    window_duration: float = 1.5,
    K: int = 25,
    max_batch: int = 8192,
    stamp_radius: int = 3,
    include_rough: bool = True,
) -> np.ndarray:
    """Probe the terrain with batched gait solves; return (H, W) blocked map.

    Every candidate pair is one scenario of a single `solve_batch` call on
    the terrain's device.

    ``include_rough`` additionally pre-blocks locally-rough cells (the
    height_bound=0.2 traversability map), so the returned map is directly
    usable as the planner's obstacle grid.
    """
    cfg = cfg or SolverConfig(max_iters=30, tol=6e-3)
    height = terrain.height.detach().cpu().numpy()
    blocked = np.zeros(height.shape, bool)
    if not (height > 0).any():
        # flat maps skip probing entirely
        return blocked.astype(np.float32)

    pairs, specs = probe_specs(terrain, window_duration, K, max_batch)
    offsets = _diamond_offsets(stamp_radius)

    if pairs:
        res_b = solve_batch(specs, terrain, cfg)
        # Blocked = the hop is INFEASIBLE, not merely slow to converge: a
        # status-only test also stamps loosely-converged solves on
        # rough-but-walkable ground.  Gate on the OBSTACLE-relevant
        # families only (feet off the surface, body through terrain, feet
        # outside the kinematic box): a true obstacle in the hop (e.g. the
        # 1 m pillars) leaves these orders of magnitude above threshold,
        # while slow dynamics/goal convergence on walkable ground does not
        # touch them.
        obst = np.maximum.reduce(
            [res_b.viol[k].cpu().numpy() for k in ("terrain", "body")]
        )
        ok = obst < 3e-2

        for (st, gl), good in zip(pairs, ok):
            if not good:
                mid = (st[0], st[1] + 1)
                _stamp(blocked, st, offsets)
                _stamp(blocked, mid, offsets)
                _stamp(blocked, gl, offsets)

    if include_rough:
        blocked |= traversability_map(terrain).cpu().numpy() > 0.5
    return blocked.astype(np.float32)
