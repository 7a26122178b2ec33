"""Frozen copy of `qtos_torch/terrain/heightfield.py` for the benchmark's plain reference: imports
rewritten to this package, nothing else changed unless a comment says so.

Heightfield terrain (port of `qtos_tpu.terrain.heightfield`).

World convention: tiles are 2 m x 2 m, composed along +x; a k-tile map spans
x in [-1, 2k-1], y in [-1, 1].  Heights are queried with bilinear
interpolation, so height and gradient are batchable tensors.
"""

from __future__ import annotations

import dataclasses
import torch



@dataclasses.dataclass(frozen=True)
class Terrain:
    """Heightfield grid. rows = y, cols = x, cell size = resolution meters."""

    height: torch.Tensor       # (H, W) float32 heights
    resolution: float = 0.1
    origin: tuple = (-1.0, -1.0)  # world xy of cell (0, 0) corner

    @property
    def extent(self):
        h, w = self.height.shape
        x0, y0 = self.origin
        return (x0, y0, x0 + w * self.resolution, y0 + h * self.resolution)

    @property
    def device(self) -> torch.device:
        return self.height.device


def _corners(terrain: Terrain, x, y):
    """Bilinear cell corners and fractions at (x, y)."""
    x0, y0 = terrain.origin
    H, W = terrain.height.shape
    cx = torch.clamp((x - x0) / terrain.resolution - 0.5, 0.0, W - 1.001)
    cy = torch.clamp((y - y0) / terrain.resolution - 0.5, 0.0, H - 1.001)
    fcx, fcy = torch.floor(cx), torch.floor(cy)
    ix, iy = fcx.long(), fcy.long()
    fx, fy = cx - fcx, cy - fcy
    h = terrain.height
    return h[iy, ix], h[iy, ix + 1], h[iy + 1, ix], h[iy + 1, ix + 1], fx, fy


def height_at(terrain: Terrain, x, y):
    """Bilinear height query; broadcasts over any shape of (x, y)."""
    h00, h01, h10, h11, fx, fy = _corners(terrain, x, y)
    return (
        h00 * (1 - fx) * (1 - fy)
        + h01 * fx * (1 - fy)
        + h10 * (1 - fx) * fy
        + h11 * fx * fy
    )


def grad_at(terrain: Terrain, x, y):
    """Analytic gradient (dh/dx, dh/dy) of the bilinear surface."""
    h00, h01, h10, h11, fx, fy = _corners(terrain, x, y)
    dhdx = ((h01 - h00) * (1 - fy) + (h11 - h10) * fy) / terrain.resolution
    dhdy = ((h10 - h00) * (1 - fx) + (h11 - h01) * fx) / terrain.resolution
    return dhdx, dhdy


_SLOPE_EPS = 1e-12


def slope_terrain(terrain: Terrain, d: float) -> Terrain:
    """A Terrain whose height grid is the SLOPE magnitude of this one,
    central-differenced with probe half-width `d` (foot-scale, wider than a
    heightfield cell), edges clamped."""
    h = terrain.height
    res = terrain.resolution
    n = max(1, int(round(d / res)))
    H, W = h.shape
    ix = torch.arange(W, device=h.device)
    iy = torch.arange(H, device=h.device)
    xp = h[:, torch.clamp(ix + n, 0, W - 1)]
    xm = h[:, torch.clamp(ix - n, 0, W - 1)]
    yp = h[torch.clamp(iy + n, 0, H - 1), :]
    ym = h[torch.clamp(iy - n, 0, H - 1), :]
    gx = (xp - xm) / (2 * n * res)
    gy = (yp - ym) / (2 * n * res)
    return dataclasses.replace(terrain, height=torch.sqrt(gx * gx + gy * gy + _SLOPE_EPS))


def slope_at(terrain: Terrain, x, y, d: float):
    """Slope magnitude at (x, y): bilinear lookup on `slope_terrain`'s grid."""
    return height_at(slope_terrain(terrain, d), x, y)


def slope_grad_at(terrain: Terrain, x, y, d: float):
    """(s, ds/dx, ds/dy) of `slope_at` in closed form."""
    ts = slope_terrain(terrain, d)
    s = height_at(ts, x, y)
    sx, sy = grad_at(ts, x, y)
    return s, sx, sy
