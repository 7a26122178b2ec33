"""Named heightfield tile library.

The reference ships 20x20 txt tiles, 2 m x 2 m at 0.1 m/cell, selected by name
in experiment YAMLs (reference: QTOS/generateHeightField.py:434-455 ``Maps``;
resolution = 1/(dim/2) at :561).  Here the same named vocabulary is generated
procedurally (no files needed on the TPU path), with txt import/export kept
for interoperability with the reference's on-disk format
(QTOS/generateHeightField.py:100-117 reader, :612-625 writer).

Tiles are numpy float arrays of shape (dim, dim), row axis = y, col axis = x.
Heights in meters.
"""

from __future__ import annotations

import numpy as np

DIM = 20  # cells per 2 m tile edge -> 0.1 m/cell


def _flat(dim=DIM, h=0.0):
    return np.full((dim, dim), h, dtype=np.float32)


def _step(dim=DIM, height=0.13, start=10, width=4):
    """A raised platform band across the tile (x direction)."""
    t = _flat(dim)
    t[:, start : start + width] = height
    return t


def _steps_profile(heights, cols, dim=DIM):
    """Piecewise-constant bands along x: heights[i] applied to cols[i] slice."""
    t = _flat(dim)
    for h, (c0, c1) in zip(heights, cols):
        t[:, c0:c1] = h
    return t


def _stairs(dim=DIM, step_h=0.05, n_steps=4, start=6, tread=2):
    t = _flat(dim)
    for i in range(n_steps):
        c0 = start + i * tread
        t[:, c0:] = (i + 1) * step_h
    return t


def _pyramid_stairs(dim=DIM, step_h=0.05, tread=2):
    """Stairs up then down (traversable staircase)."""
    t = _flat(dim)
    half = dim // 2
    for i in range(half // tread):
        c0 = i * tread
        h = (i + 1) * step_h
        t[:, c0 : dim - c0] = h
    return t


def _wall(dim=DIM, height=1.0, start=9, width=2, gap=None):
    """Impassable wall band; optional gap rows left open (collision tiles)."""
    t = _flat(dim)
    t[:, start : start + width] = height
    if gap is not None:
        g0, g1 = gap
        t[g0:g1, start : start + width] = 0.0
    return t


def _random_terrain(dim=DIM, amp=0.075, seed=3, smooth=2):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, amp, size=(dim, dim)).astype(np.float32)
    for _ in range(smooth):
        t = 0.25 * (
            np.roll(t, 1, 0) + np.roll(t, -1, 0) + np.roll(t, 1, 1) + np.roll(t, -1, 1)
        )
    t -= t.min()
    return t.astype(np.float32)


def _bridge(dim=DIM):
    """Elevated walkway with drops either side."""
    t = _flat(dim, 0.25)
    t[: dim // 2 - 2, 6:14] = 0.0
    t[dim // 2 + 2 :, 6:14] = 0.0
    t[:, :4] = 0.0
    t[:, 16:] = 0.0
    return t


def _obstacle(dim=DIM, height=1.0):
    """Block obstacle offset from center; walkable around it."""
    t = _flat(dim)
    t[6:14, 8:12] = height
    return t


def _calibration(dim=DIM):
    """Assorted posts of known heights for camera/terrain calibration."""
    t = _flat(dim)
    for (r, c, h) in [(3, 3, 0.3), (3, 16, 0.5), (16, 3, 1.0), (16, 16, 1.4), (10, 10, 1.6)]:
        t[r : r + 2, c : c + 2] = h
    return t


def _feasibility(dim=DIM, height=0.5):
    """Scattered untraversable pillars — feasibility-map stress tile."""
    t = _flat(dim)
    for (r, c) in [(2, 5), (5, 12), (9, 3), (12, 9), (15, 15), (7, 17)]:
        t[r : r + 2, c : c + 2] = height
    return t


def _climb(dim=DIM, top=0.08):
    """Gentle multi-level ramp up along x."""
    levels = np.linspace(0.0, top, 8)
    t = _flat(dim)
    for i, h in enumerate(levels):
        t[:, int(i * dim / 8) :] = h
    return t


# Reference tile-name -> vendored data file (the reference's own name->file
# contract, QTOS/generateHeightField.py:505-528 `map_files` + the Maps class
# attributes :434-455).  The txt files under data/heightfields/ are the
# reference's checked-in geometry, vendored verbatim so experiments run the
# SAME terrain; `tile()` prefers them and falls back to the procedural
# generators below when the data is absent.
_DATA_DIR = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "..", "..", "data", "heightfields"
)
REFERENCE_TILE_FILES = {
    "calibration": "calibration.txt",
    "step": "step.txt",
    "step_1": "step_1.txt",
    "step_2": "step_2.txt",
    "step_3": "step_3.txt",
    "wall_1": "wall_1.txt",
    "wall_2": "wall_2.txt",
    "wall_3": "wall_3.txt",
    "wall_4": "wall_4.txt",
    # NOTE the reference's vocabulary: 'stairs' is the tall staircase file,
    # 'stair'/'stair_1' are the gentle step files (generateHeightField.py:515,
    # 523-524) — experiment_6/7 use 'stair'/'stair_1'.
    "stairs": "staircase.txt",
    "staircase": "staircase.txt",
    "stair": "stairs.txt",
    "stair_1": "stairs_1.txt",
    "plane": "plane.txt",
    "climb_1": "climb_1.txt",
    "climb_2": "climb_2.txt",
    "feasibility": "feasibility_test.txt",
    "feasibility_1": "feasibility_test_1.txt",
    "random_terrain": "random_terrain.txt",
    "random_terrain_1": "random_terrain.txt",
    "collision_hill": "collision_wall_hills.txt",
    "collision_hills": "collision_wall_hills.txt",
    "obstacle": "obstacle_1.txt",
    "bridge": "bridge.txt",
}

TILE_GENERATORS = {
    "plane": lambda: _flat(),
    "step": lambda: _step(height=0.13, start=10, width=4),
    "step_1": lambda: _steps_profile(
        [0.01, 0.025, 0.05, 0.065], [(6, 8), (8, 10), (10, 14), (14, 20)]
    ),
    "step_2": lambda: _steps_profile([0.05, 0.075, 0.1], [(6, 9), (9, 12), (12, 20)]),
    "step_3": lambda: _steps_profile([0.1, 0.075, 0.05], [(6, 10), (10, 13), (13, 20)]),
    "wall_1": lambda: _wall(gap=(0, 6)),
    "wall_2": lambda: _wall(gap=(7, 13)),
    "wall_3": lambda: _wall(gap=(14, 20)),
    "wall": lambda: _wall(),
    "stairs": lambda: _stairs(step_h=0.05, n_steps=2, start=8, tread=4),
    "stairs_1": lambda: _stairs(step_h=0.05, n_steps=4, start=6, tread=3),
    "staircase": lambda: _pyramid_stairs(step_h=0.5, tread=4),
    "climb_1": lambda: _climb(top=0.08),
    "climb_2": lambda: _climb(top=0.125),
    "feasibility": lambda: _feasibility(),
    "feasibility_1": lambda: _feasibility(height=0.5),
    "random_terrain": lambda: _random_terrain(),
    "obstacle": lambda: _obstacle(),
    "bridge": lambda: _bridge(),
    "calibration": lambda: _calibration(),
    "test": lambda: _flat(),
    "collision_hills": lambda: np.maximum(_wall(gap=(7, 13)), _random_terrain(amp=0.05, seed=7)),
}

# aliases used by reference experiment YAMLs (experiment_4/6: 'random_terrain_1',
# 'stair', 'stair_1')
TILE_GENERATORS["random_terrain_1"] = TILE_GENERATORS["random_terrain"]
TILE_GENERATORS["stair"] = TILE_GENERATORS["stairs"]
TILE_GENERATORS["stair_1"] = TILE_GENERATORS["stairs_1"]


def tile(name: str) -> np.ndarray:
    """Return a named (dim, dim) tile.

    Prefers the reference's vendored geometry (data/heightfields/*.txt — the
    exact terrain the reference experiments ran on); falls back to the
    procedural generator of the same name."""
    import os

    fname = REFERENCE_TILE_FILES.get(name)
    if fname is not None:
        path = os.path.join(_DATA_DIR, fname)
        if os.path.exists(path):
            return load_tile_txt(path)
    try:
        return TILE_GENERATORS[name]().copy()
    except KeyError as e:
        known = sorted(set(TILE_GENERATORS) | set(REFERENCE_TILE_FILES))
        raise KeyError(f"unknown tile {name!r}; known: {known}") from e


def load_tile_txt(path: str) -> np.ndarray:
    """Read the reference's comma-separated heightfield txt format."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [v.strip() for v in line.strip().split(",")]
            row = [float(v) for v in vals if v not in ("", None)]
            if row:
                rows.append(row)
    return np.asarray(rows, dtype=np.float32)


def save_tile_txt(path: str, arr: np.ndarray) -> None:
    """Write the reference's txt format (trailing comma per row)."""
    with open(path, "w") as f:
        lines = []
        for row in np.asarray(arr):
            lines.append(", ".join(str(float(v)) for v in row) + ",")
        f.write("\n".join(lines))
