"""The assembly kernel's design floor (`qtos_torch/tools/assemble_floor.py`):
its counts are held to `qtos_torch/csrc/assemble.cu` (the loads and calls of
each counted function, the constants, and the kernel's walk over chunks,
groups and tiles), and the floor is the larger of the float32 and the
shared-memory time.

The card's SM clock the floor is taken at is read on the card only
(`chip_smoke.py` phase 3b, `qtos_torch/tools/check_assemble.py`).
"""

import os

import pytest

from qtos_torch.tools import assemble_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SRC = os.path.join(REPO, "qtos_torch", "csrc", "assemble.cu")


@pytest.fixture(scope="module")
def source():
    with open(KERNEL_SRC) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(assemble_floor.SOURCE_CALLS))
def test_recorded_calls_are_the_sources(source, name):
    """An edit of assemble.cu that adds or removes a shared-memory load or a
    Gram call in a counted function fails here until the count is redone."""
    assert assemble_floor.source_calls(source, name) == assemble_floor.SOURCE_CALLS[name]


def test_constants_are_the_sources(source):
    assert assemble_floor.source_constants(source) == assemble_floor.CONSTANTS


def _walk(K, chunk):
    """The kernel's stage D walked as assemble.cu walks it: chunks of
    `chunk` knots, groups of at most kGroup knots spread evenly, per knot the
    lower-triangle tiles of D_k (a Gram tile for Daa if it has interval k,
    one for Dbb if it has k-1), the tiles of L_k and the pieces of g_k.
    Returns (Gram tiles, vector pieces)."""
    G, tiles = assemble_floor.CONSTANTS["kGroup"], assemble_floor.CONSTANTS["kNV"] // assemble_floor.CONSTANTS["kTile"]
    d_units = tiles * (tiles + 1) // 2
    grams = vecs = 0
    for k0 in range(0, K, chunk):
        n = min(chunk, K - k0)
        groups = -(-n // G)
        base, extra = divmod(n, groups)
        for gr in range(groups):
            gs, gn = gr * base + min(gr, extra), base + (gr < extra)
            for k in range(k0 + gs, k0 + gs + gn):
                sides = (k < K - 1) + (k > 0)
                grams += d_units * sides + (tiles * tiles if k < K - 1 else 0)
                vecs += tiles * sides
    return grams, vecs


@pytest.mark.parametrize("K,chunk", [(2, 2), (13, 13), (13, 5), (41, 41), (45, 23)])
def test_counts_walk_the_kernels_tiles(K, chunk):
    c = assemble_floor.counts(K)
    assert (c["gram_tiles"], c["vec_pieces"]) == _walk(K, chunk)


def test_floor_at_the_bench_shape():
    """(8192, 41) at 1,980 MHz: 171 Gram tiles of 12 rows a knot between
    intervals; shared memory sets the floor (0.84 ms), float32 issue 0.66 ms;
    both below the 1.067 ms bound by device-memory bytes."""
    f = assemble_floor.design_floor(8192, 41, 1980.0)
    c = assemble_floor.counts(41)
    assert c["gram_tiles"] == 40 * (2 * 45 + 81) and c["vec_pieces"] == 80 * 9
    assert f["floor_by"] == "shared memory" and f["floor_ms"] == pytest.approx(0.84, abs=0.01)
    assert f["fp32_ms"] == pytest.approx(0.66, abs=0.01)
    assert assemble_floor.design_floor(1024, 41, 1980.0)["floor_ms"] == pytest.approx(f["floor_ms"] / 8)
