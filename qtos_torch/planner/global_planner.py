"""Global planner: A* waypoints -> smooth timed spline path -> window goals
(port of `qtos_tpu.planner.global_planner`).

A* over the obstacle map, cubic-spline fit of x(t), y(t), and ``spine_step``
goal generation for each receding-horizon window.  The spline lives on the
terrain's device (`qtos_torch.ops.splines`); the search and every query of
the replan loop are host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops.splines import natural_cubic_coeffs, natural_cubic_eval
from qtos_torch.planner.astar import astar
from qtos_torch.runtime import native_astar, native_available
from qtos_torch.terrain.heightfield import Terrain, traversability_map


class GlobalPlanner:
    """Timed global path over a terrain.

    Args:
      terrain: the world.
      start_xy, goal_xy: world coordinates.
      avg_speed: trajectory pacing (m/s of path length).
      blocked: optional (H, W) obstacle grid; defaults to the local
        height-jump traversability map (height_bound=0.2). Pass the
        solver-probed feasibility map for collision-avoidance experiments.
    """

    def __init__(
        self,
        terrain: Terrain,
        start_xy,
        goal_xy,
        avg_speed: float = 0.24,
        blocked: np.ndarray | None = None,
        safety_margin_m: float = 0.30,
    ):
        self.terrain = terrain
        self.avg_speed = float(avg_speed)
        self._height_np = terrain.height.detach().cpu().numpy()
        if blocked is None:
            blocked = traversability_map(terrain)
        if isinstance(blocked, torch.Tensor):
            blocked = blocked.detach().cpu().numpy()
        raw_blocked = np.asarray(blocked) > 0.5
        # the native A* (no cost argument) where it built, else the Python one
        search = native_astar if native_available() else astar

        # Obstacle inflation in METERS, converted to cells at the map's
        # resolution (a cell count silently halves the clearance on
        # mesh_scale=2 maps).  The margin must clear the FOOT LINES, not
        # just the base: footholds land ±0.19 m lateral of the spine (the
        # stance width) plus tracking wobble — at 0.15 m the exp_8 spine
        # passed the 1 m pillar close enough that the left-front foothold
        # had to land ON it, making every window NLP near the pillar
        # unsolvable.
        #
        # The margin is TAPERED near the endpoints: a start or goal that
        # legitimately sits close to geometry (exp_7's goal is 0.3 m past the
        # climb wall; an exp_8 mid-run replan starts wherever the robot
        # stands when the box spawns) would otherwise be swallowed by its own
        # inflation, and the old remedy — shrinking the margin GLOBALLY until
        # the endpoint frees up — collapsed the clearance everywhere, so the
        # spine hugged the wall for its whole length instead of only at the
        # unavoidable final approach.  If even the tapered map has no path
        # (corridor genuinely sealed), retry at smaller global margins — a
        # tight path beats no path.
        want = max(1, int(round(safety_margin_m / terrain.resolution)))
        H, W = raw_blocked.shape
        # The start cell is where the robot ACTUALLY STANDS — traversable by
        # definition, even when the traversability test smears a neighboring
        # box face over it (a mid-run replan right next to a spawned box
        # would otherwise find A*'s start raw-blocked and fail outright).
        raw_blocked = raw_blocked.copy()
        raw_blocked[self._to_cell(start_xy)] = False
        # dist[c] = dilation round at which c becomes blocked (0 = raw
        # obstacle, inf = farther than `want` rounds) — a bounded
        # 4-connected distance transform matching _inflate's growth
        halo = 4  # soft-penalty band beyond the hard margin, in cells
        dist = np.where(raw_blocked, 0.0, np.inf)
        cur = raw_blocked.copy()
        for k in range(1, want + halo + 1):
            nxt = self._inflate(cur, 1)
            dist[nxt & ~cur] = k
            cur = nxt
        rr, cc = np.mgrid[0:H, 0:W]
        s_cell = self._to_cell(start_xy)
        g_cell = self._to_cell(goal_xy)
        d_end = np.minimum(
            np.abs(rr - s_cell[0]) + np.abs(cc - s_cell[1]),
            np.abs(rr - g_cell[0]) + np.abs(cc - g_cell[1]),
        )
        # Soft proximity penalty: pure-distance A* breaks ties TOWARD the
        # obstacle, so the spine grazes the inflated boundary for its whole
        # length — and the tracking controller's few-cm corner-cutting then
        # walks the robot onto the geometry.  A small cost that decays
        # over `halo` cells past the hard margin centers the route in
        # corridors while still letting it thread genuinely tight gaps.
        soft = np.where(np.isfinite(dist), np.maximum(0.0, want + halo - dist), 0.0)
        soft *= 0.5 / halo  # worst extra cost ~0.5 step per cell walked
        cells = None
        for margin in range(want, 0, -1):
            # at the endpoint cells themselves only raw geometry blocks
            # (dist 0 <= allowed 0): a robot standing one cell from a
            # just-spawned box must still be able to path out of the pocket
            allowed = np.minimum(margin, np.maximum(0, d_end - 1))
            self.blocked = dist <= allowed
            if soft.any():
                # weighted search is python-only; the grid is tiny (ms)
                cells = astar(
                    self.blocked, self._to_cell(start_xy),
                    self._to_cell(goal_xy), cost=soft,
                )
            else:
                cells = search(
                    self.blocked, self._to_cell(start_xy), self._to_cell(goal_xy)
                )
            if cells is not None:
                break
        if cells is None:
            raise RuntimeError(
                f"global planner: no path from {tuple(start_xy)} to {tuple(goal_xy)}"
            )
        pts = np.stack([self._to_world(c) for c in cells])
        pts[0] = np.asarray(start_xy, np.float64)
        pts[-1] = np.asarray(goal_xy, np.float64)
        pts = self._decimate(pts)

        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        self.path_length = float(seg.sum())
        self.total_time = max(self.path_length / self.avg_speed, 1e-3)
        # uniform-in-time knots via arc-length resampling
        s = np.concatenate([[0.0], np.cumsum(seg)])
        n_knots = max(8, len(pts))
        ts = np.linspace(0.0, s[-1], n_knots)
        xk = np.interp(ts, s, pts[:, 0])
        yk = np.interp(ts, s, pts[:, 1])
        self._h = self.total_time / (n_knots - 1)
        f32 = dict(dtype=torch.float32, device=terrain.device)
        self._xk = torch.as_tensor(xk, **f32)
        self._yk = torch.as_tensor(yk, **f32)
        self._mx = natural_cubic_coeffs(self._xk, self._h)
        self._my = natural_cubic_coeffs(self._yk, self._h)
        # Dense host-side samples: spine_step/time_at_position run in the
        # replan loop's latency path, so they must be pure numpy (each tensor
        # read would pay a device round trip).  One batched evaluation, moved
        # to the host once.
        ts = np.linspace(0.0, self.total_time, 1024)
        self._dense_ts = ts
        self._dense_xy = self._points_np(ts)

    # -- grid <-> world ---------------------------------------------------

    def _to_cell(self, xy):
        x0, y0 = self.terrain.origin
        res = self.terrain.resolution
        col = int(round((xy[0] - x0) / res - 0.5))
        row = int(round((xy[1] - y0) / res - 0.5))
        H, W = self.blocked.shape if hasattr(self, "blocked") else self.terrain.height.shape
        return (min(max(row, 0), H - 1), min(max(col, 0), W - 1))

    def _to_world(self, cell):
        x0, y0 = self.terrain.origin
        res = self.terrain.resolution
        return np.array([x0 + (cell[1] + 0.5) * res, y0 + (cell[0] + 0.5) * res])

    @staticmethod
    def _inflate(blocked: np.ndarray, n: int) -> np.ndarray:
        out = blocked.copy()
        for _ in range(n):
            grow = out.copy()
            grow[1:] |= out[:-1]
            grow[:-1] |= out[1:]
            grow[:, 1:] |= out[:, :-1]
            grow[:, :-1] |= out[:, 1:]
            out = grow
        return out

    @staticmethod
    def _decimate(pts: np.ndarray, tol: float = 1e-6) -> np.ndarray:
        """Drop collinear intermediate waypoints."""
        if len(pts) <= 2:
            return pts
        keep = [0]
        for i in range(1, len(pts) - 1):
            a, b, c = pts[keep[-1]], pts[i], pts[i + 1]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            if abs(cross) > tol:
                keep.append(i)
        keep.append(len(pts) - 1)
        return pts[keep]

    # -- queries -----------------------------------------------------------

    def point_at(self, t):
        """(x, y, yaw) on the global path at time(s) t (clamped), as tensors
        on the terrain's device."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self._xk.device)
        t = torch.clamp(t, 0.0, self.total_time)
        x, dx = natural_cubic_eval(self._xk, self._mx, self._h, 0.0, t)
        y, dy = natural_cubic_eval(self._yk, self._my, self._h, 0.0, t)
        yaw = torch.atan2(dy, dx)
        return x, y, yaw

    def _points_np(self, ts: np.ndarray) -> np.ndarray:
        """(N, 2) float64 path points at times `ts`: one `point_at` call."""
        x, y, _ = self.point_at(np.asarray(ts, np.float32))
        return torch.stack([x, y], dim=1).cpu().numpy().astype(np.float64)

    def _point_np(self, t: float):
        """Host-numpy path point + yaw (dense-sample interpolation)."""
        t = float(np.clip(t, 0.0, self.total_time))
        x = float(np.interp(t, self._dense_ts, self._dense_xy[:, 0]))
        y = float(np.interp(t, self._dense_ts, self._dense_xy[:, 1]))
        dt = self._dense_ts[1] - self._dense_ts[0]
        t2 = min(t + dt, self.total_time)
        t1 = max(t2 - dt, 0.0)
        dx = np.interp(t2, self._dense_ts, self._dense_xy[:, 0]) - np.interp(
            t1, self._dense_ts, self._dense_xy[:, 0])
        dy = np.interp(t2, self._dense_ts, self._dense_xy[:, 1]) - np.interp(
            t1, self._dense_ts, self._dense_xy[:, 1])
        return x, y, float(np.arctan2(dy, dx))

    def _height_np_at(self, x: float, y: float) -> float:
        """Host-numpy bilinear height query (mirror of heightfield.height_at)."""
        h = self._height_np
        H, W = h.shape
        x0, y0 = self.terrain.origin
        cx = np.clip((x - x0) / self.terrain.resolution - 0.5, 0.0, W - 1.001)
        cy = np.clip((y - y0) / self.terrain.resolution - 0.5, 0.0, H - 1.001)
        ix, iy = int(cx), int(cy)
        fx, fy = cx - ix, cy - iy
        return float(
            h[iy, ix] * (1 - fx) * (1 - fy)
            + h[iy, ix + 1] * fx * (1 - fy)
            + h[iy + 1, ix] * (1 - fx) * fy
            + h[iy + 1, ix + 1] * fx * fy
        )

    def spine_step(self, t: float, horizon: float):
        """Goal for the window starting at path-time t: the path point one
        horizon ahead, with terrain-aware z.  Pure host numpy: this sits in
        the replan latency path."""
        x, y, yaw = self._point_np(t + horizon)
        z = self._height_np_at(x, y) + Solo12.stand_height
        return np.array([x, y, z]), yaw

    def height_span(self, t: float, horizon: float) -> float:
        """Max height variation along the path segment [t, t + horizon].

        The receding-horizon runner paces windows by this (slow down over
        steps/stairs, full speed on flat).  Pure host numpy (replan latency
        path)."""
        t = float(np.clip(t, 0.0, self.total_time))
        t1 = float(np.clip(t + horizon, 0.0, self.total_time))
        mask = (self._dense_ts >= t) & (self._dense_ts <= t1)
        xy = self._dense_xy[mask]
        if len(xy) < 2:
            return 0.0
        hs = [self._height_np_at(x, y) for x, y in xy]
        return float(np.max(hs) - np.min(hs))

    def turn_in(self, t: float, horizon: float) -> float:
        """Total absolute heading change [rad] along [t, t + horizon].

        The runner paces windows by this: the tracking controller handles
        straight lines and gentle arcs, so sharp turns are taken slowly."""
        t = float(np.clip(t, 0.0, self.total_time))
        t1 = float(np.clip(t + horizon, 0.0, self.total_time))
        mask = (self._dense_ts >= t) & (self._dense_ts <= t1)
        xy = self._dense_xy[mask]
        if len(xy) < 3:
            return 0.0
        d = np.diff(xy, axis=0)
        yaw = np.arctan2(d[:, 1], d[:, 0])
        dyaw = np.diff(yaw)
        dyaw = np.arctan2(np.sin(dyaw), np.cos(dyaw))
        return float(np.abs(dyaw).sum())

    def time_at_position(self, xy) -> float:
        """Path time of the point nearest to xy — progress projection.

        The raw trajectory time diverges from actual progress whenever the
        robot holds stance (failure fallback) or drifts; window goals must be
        seeded from where the robot IS on the path."""
        d = np.linalg.norm(self._dense_xy - np.asarray(xy, np.float64)[None, :2], axis=1)
        return float(self._dense_ts[int(np.argmin(d))])

    def save_plot(self, path: str) -> None:
        """Write the global plan over the height map as an image."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x0, y0, x1, y1 = self.terrain.extent
        fig, ax = plt.subplots(figsize=(9, 4))
        ax.imshow(
            self._height_np,
            origin="lower",
            extent=(x0, x1, y0, y1),
            cmap="terrain",
        )
        xy = self._points_np(np.linspace(0, self.total_time, 200))
        ax.plot(xy[:, 0], xy[:, 1], "r-", lw=2, label="global plan")
        by, bx = np.nonzero(self.blocked)
        res = self.terrain.resolution
        ax.plot(x0 + (bx + 0.5) * res, y0 + (by + 0.5) * res, "k.", ms=2, alpha=0.4)
        ax.legend()
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
