"""A box dropped into a height grid, for the benchmark's plain reference:
written here from its definition, not copied from the program.

The box of half-extent `half` centred at world (x, y) covers the square
[x - half, x + half] x [y - half, y + half].  Every cell of the grid that
the square covers, the square snapped outward to the grid's lines, is
raised to at least `top`: its height becomes max(height, top).  Cell (i, j)
spans x in [x0 + j res, x0 + (j + 1) res] and y in [y0 + i res,
y0 + (i + 1) res] from the grid's corner (x0, y0).
"""

from __future__ import annotations

import math

import torch


def box_cells(shape: tuple, resolution: float, origin: tuple, x: float, y: float, half: float) -> torch.Tensor:
    """(H, W) bool: the cells the box's square covers, snapped outward (at
    least one row and one column, inside the grid)."""
    H, W = shape
    x0, y0 = origin

    def span(lo: float, hi: float, start: float, n: int) -> tuple:
        first = min(max(math.floor((lo - start) / resolution), 0), n - 1)
        last = min(max(math.ceil((hi - start) / resolution), 1), n)
        return first, last

    c0, c1 = span(x - half, x + half, x0, W)
    r0, r1 = span(y - half, y + half, y0, H)
    rows = torch.arange(H)
    cols = torch.arange(W)
    return ((rows >= r0) & (rows < r1))[:, None] & ((cols >= c0) & (cols < c1))[None, :]


def add_box(grid: torch.Tensor, resolution: float, origin: tuple, x: float, y: float, half: float,
            top: float) -> torch.Tensor:
    """A new grid: `grid` with the box's cells raised to at least `top`."""
    cells = box_cells(tuple(grid.shape), resolution, origin, x, y, half).to(grid.device)
    return torch.where(cells, torch.clamp(grid, min=top), grid)


def raised(grid: torch.Tensor, above: float = 0.05) -> torch.Tensor:
    """(H, W) bool: the cells higher than `above` (a box's, a wall's; the
    ground's own noise stays below), where no foot may start."""
    return grid > above


def cell_of(shape: tuple, resolution: float, origin: tuple, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """(row, col) of the cell under each point (x, y), clamped to the grid."""
    H, W = shape
    col = torch.clamp(torch.floor((x - origin[0]) / resolution), 0, W - 1).long()
    row = torch.clamp(torch.floor((y - origin[1]) / resolution), 0, H - 1).long()
    return row, col
