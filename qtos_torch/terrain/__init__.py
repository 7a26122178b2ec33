"""Terrain: heightfield tiles, composition, and height/gradient queries."""

from qtos_torch.terrain.heightfield import (  # noqa: F401
    Terrain,
    grad_at,
    height_at,
    make_terrain,
    slope_at,
    slope_grad_at,
    slope_terrain,
)
from qtos_torch.terrain.tiles import TILE_GENERATORS, load_tile_txt, tile  # noqa: F401
