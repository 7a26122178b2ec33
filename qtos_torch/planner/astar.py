"""Grid A* for the global planner (the port's own copy of
`qtos_tpu.planner.astar`: pure numpy and `heapq`).

The search runs over a boolean obstacle grid derived from the heightfield.
It is tiny and inherently sequential, so it stays host-side; the expensive
part, deciding *which* cells are traversable by actually attempting gait
solves, is the batched sweep in `qtos_torch.planner.feasibility`.
"""

from __future__ import annotations

import heapq

import numpy as np


def astar(
    blocked: np.ndarray,
    start: tuple[int, int],
    goal: tuple[int, int],
    diagonal: bool = True,
    cost: np.ndarray | None = None,
) -> np.ndarray | None:
    """A* over a (H, W) obstacle grid (1 = blocked).

    Args:
      blocked: obstacle grid, rows = y, cols = x.
      start, goal: (row, col) cells.
      diagonal: allow 8-connectivity.
      cost: optional (H, W) per-cell soft penalty added on entering a cell.
        A pure-distance cost makes every path hug the inflated obstacle
        boundary (ties broken toward the obstacle); a small penalty that
        decays with distance from blocked cells centers the route in
        corridors instead.  Must be >= 0; the heuristic stays admissible
        because penalties only add cost.

    Returns:
      (N, 2) array of (row, col) waypoints including endpoints, or None if
      unreachable (the caller decides what to do then).
    """
    blocked = np.asarray(blocked)
    H, W = blocked.shape
    start = tuple(int(v) for v in start)
    goal = tuple(int(v) for v in goal)

    def inside(c):
        return 0 <= c[0] < H and 0 <= c[1] < W

    if not inside(start) or not inside(goal):
        return None
    if blocked[start] or blocked[goal]:
        return None

    steps = [(-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0)]
    if diagonal:
        steps += [(-1, -1, 1.41421), (-1, 1, 1.41421), (1, -1, 1.41421), (1, 1, 1.41421)]

    def h(c):
        return np.hypot(c[0] - goal[0], c[1] - goal[1])

    open_q = [(h(start), 0.0, start)]
    g_cost = {start: 0.0}
    came = {}
    closed = set()
    while open_q:
        _, g, cur = heapq.heappop(open_q)
        if cur in closed:
            continue
        if cur == goal:
            path = [cur]
            while cur in came:
                cur = came[cur]
                path.append(cur)
            return np.array(path[::-1], dtype=np.int32)
        closed.add(cur)
        for dr, dc, w in steps:
            nxt = (cur[0] + dr, cur[1] + dc)
            if not inside(nxt) or blocked[nxt]:
                continue
            # forbid diagonal corner-cutting through blocked cells
            if dr and dc and (blocked[cur[0] + dr, cur[1]] or blocked[cur[0], cur[1] + dc]):
                continue
            ng = g + w + (float(cost[nxt]) if cost is not None else 0.0)
            if ng < g_cost.get(nxt, np.inf):
                g_cost[nxt] = ng
                came[nxt] = cur
                heapq.heappush(open_q, (ng + h(nxt), ng, nxt))
    return None
