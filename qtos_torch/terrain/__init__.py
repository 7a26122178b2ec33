"""Terrain: heightfield tiles, composition, and height/gradient queries."""

from qtos_torch.terrain.heightfield import (  # noqa: F401
    Terrain,
    add_box_obstacle,
    export_heightfield_txt,
    grad_at,
    height_at,
    import_heightfield_txt,
    make_terrain,
    shift_terrain,
    slope_at,
    slope_grad_at,
    slope_terrain,
    traversability_map,
)
from qtos_torch.terrain.tiles import TILE_GENERATORS, load_tile_txt, tile  # noqa: F401
