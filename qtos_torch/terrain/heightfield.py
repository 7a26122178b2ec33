"""Heightfield terrain (port of `qtos_tpu.terrain.heightfield`).

World convention: tiles are 2 m x 2 m, composed along +x; a k-tile map spans
x in [-1, 2k-1], y in [-1, 1].  Heights are queried with bilinear
interpolation, so height and gradient are batchable tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from qtos_torch.device import resolve_device
from qtos_torch.terrain import tiles as tiles_lib
from qtos_torch.utils.profiling import annotate


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


def make_terrain(
    names: Sequence[str] | str = ("plane",),
    scale_factor: int = 1,
    randomize: bool = False,
    rng: np.random.Generator | None = None,
    random_height_amp: float = 0.02,
    device=None,
) -> Terrain:
    """Compose named tiles along +x into one Terrain on `device` (None: CUDA)."""
    dev = resolve_device(device)
    if isinstance(names, str):
        names = [names]
    mats = [tiles_lib.tile(n) for n in names]
    grid = np.concatenate(mats, axis=1)  # compose along x
    if scale_factor > 1:
        grid = np.kron(grid, np.ones((scale_factor, scale_factor), dtype=grid.dtype))
    if randomize:
        rng = rng or np.random.default_rng(0)
        grid = grid + rng.uniform(0.0, random_height_amp, size=grid.shape).astype(grid.dtype)
    res = 0.1 / scale_factor
    height = torch.as_tensor(np.asarray(grid, np.float32), device=dev)
    return Terrain(height=height, resolution=res, origin=(-1.0, -1.0))


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


def shift_terrain(terrain: Terrain, rows: int = 0, cols: int = 0, fill: float = 0.0) -> Terrain:
    """Dynamic-terrain update: scroll the height grid by (rows, cols) cells,
    filling vacated cells.  The shape is unchanged."""
    h = torch.roll(terrain.height, (rows, cols), dims=(0, 1))
    if rows > 0:
        h[:rows] = fill
    elif rows < 0:
        h[rows:] = fill
    if cols > 0:
        h[:, :cols] = fill
    elif cols < 0:
        h[:, cols:] = fill
    return dataclasses.replace(terrain, height=h)


def add_box_obstacle(terrain: Terrain, x: float, y: float, half: float = 0.1,
                     height: float = 0.34) -> Terrain:
    """Raise a box-shaped obstacle into the heightfield at world (x, y): the
    dynamic-terrain event of a box of half-extent `half` spawned mid-run with
    its top face at `height`.  Shape and dtype are preserved; the grid is a
    fresh tensor.  Under a profiler it records the span `qtos::terrain.box`
    (n = the cells raised to at least `height`)."""
    H, W = terrain.height.shape
    x0, y0 = terrain.origin
    res = terrain.resolution
    c0 = int(np.clip(np.floor((x - half - x0) / res), 0, W - 1))
    c1 = int(np.clip(np.ceil((x + half - x0) / res), 1, W))
    r0 = int(np.clip(np.floor((y - half - y0) / res), 0, H - 1))
    r1 = int(np.clip(np.ceil((y + half - y0) / res), 1, H))
    with annotate("qtos::terrain.box", max(r1 - r0, 0) * max(c1 - c0, 0)):
        h = terrain.height.clone()
        h[r0:r1, c0:c1] = torch.clamp(h[r0:r1, c0:c1], min=height)
    return dataclasses.replace(terrain, height=h)


def export_heightfield_txt(terrain: Terrain, path: str, towr_frame: bool = False) -> None:
    """Write the height grid in the on-disk heightfield interchange format:
    comma-delimited with a trailing comma per row.

    Two variants exist: the row-major grid, and a "TOWR-frame" export that
    transposes the grid then shifts the rows down by one (a zero first row,
    the last transposed row dropped, shape preserved).  ``towr_frame=True``
    writes the second."""
    grid = terrain.height.detach().cpu().numpy()
    if towr_frame:
        g = grid.T
        out = np.zeros_like(g)
        out[1:] = g[:-1]
        grid = out
    with open(path, "w") as f:
        lines = [", ".join(str(float(v)) for v in row) + "," for row in grid]
        f.write("\n".join(lines))


def import_heightfield_txt(path: str, resolution: float = 0.1,
                           origin: tuple = (-1.0, -1.0), device=None) -> Terrain:
    """Load a heightfield txt into a Terrain on `device` (None: CUDA).
    Accepts both the comma-delimited format (trailing comma per line) and
    plain whitespace txt."""
    dev = resolve_device(device)
    with open(path) as f:
        head = f.read(4096)
    if "," in head:
        grid = tiles_lib.load_tile_txt(path)
    else:
        grid = np.loadtxt(path, dtype=np.float32)
    height = torch.as_tensor(np.atleast_2d(grid).astype(np.float32), device=dev)
    return Terrain(height=height, resolution=resolution, origin=origin)


def traversability_map(terrain: Terrain, height_bound: float = 0.2) -> torch.Tensor:
    """(H, W) float32 obstacle map (1 = blocked) from local height
    discontinuity: a cell whose height differs from a 4-neighbour's by more
    than `height_bound`.  The cheap analog of the solver-probed map in
    `qtos_torch.planner.feasibility`."""
    h = terrain.height
    pad = torch.nn.functional.pad(h[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    neigh = torch.stack([pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]], dim=0)
    jump = (neigh - h[None]).abs().amax(dim=0)
    return (jump > height_bound).to(torch.float32)
