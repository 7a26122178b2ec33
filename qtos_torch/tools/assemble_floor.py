"""The assembly kernel's design floor: the least time its Gram products can
take on the card, from the instructions `qtos_torch/csrc/assemble.cu` issues
for them, against the card's float32 issue rate and its shared-memory
bandwidth.

Per window of K knots the kernel computes, as 4 x 4 register tiles of
12-row sums (`gram_tile`), the lower-triangle tiles of Daa and Dbb of every
interval (the tile above the diagonal takes the same sums) and all tiles of
Lba, and as 4-entry pieces of 12-row sums (`gram_vec4`) the two products of
g.  Each is counted as the source computes it: a tile's 12 rows are two
float4 loads from shared memory and 16 products, with 16 additions from the
second row on (no fused multiply-adds: `--fmad=false`); `d_tile` adds each
Gram tile into its knot tile and its mirror, and reads both from shared
memory; `g_piece` adds each product and its diagonal term.  Before the
products, every Gram group writes its W rows and knot tiles to shared memory
(`w_row`, `tile_row`).  The closed forms (a few percent of the instructions)
are left out.

`SOURCE_CALLS` records the loads and calls of each counted function as
assemble.cu holds them (`source_calls` reads them from the source), and
`tests/test_torch_assemble_floor.py` holds it, and the constants, to the
source: an edit that changes one fails there until the count is redone.

The floor is the larger of two times: the float32 instructions over
128 lanes per SM per clock, and the shared-memory bytes (loads and the
expansion's stores, as the threads ask for them) over 128 bytes per SM per
clock, on 132 SMs at the SM clock.  The bound by device-memory bytes
(`check_assemble.bound`) is separate: the kernel's time is at least the
larger of the two.
"""

from __future__ import annotations

import re
import subprocess

from qtos_torch.tools.tick_floor import function_body

SMS = 132                       # H100 SXM
F32_LANES_PER_SM = 128          # float32 instructions per SM per clock
SMEM_BYTES_PER_SM = 128         # shared-memory bytes per SM per clock

# The constants of assemble.cu the count uses, as the source defines them.
CONSTANTS = dict(kNV=36, kRows=12, kTile=4, kGroup=4)
# Per counted function: its float4 shared-memory loads (`ld4(`) and the
# calls of the other counted functions, as assemble.cu holds them.
SOURCE_CALLS = {
    "gram_tile": dict(ld4=4),                  # row 0: two; rows 1-11: two
    "gram_vec4": dict(ld4=2),                  # row 0: one; rows 1-11: one
    "d_tile": dict(ld4=2, gram_tile=2, st4=2),  # the tile and its mirror; Daa, Dbb
    "l_tile": dict(gram_tile=1, st4=1),
    "g_piece": dict(gram_vec4=2, st4=1),
}


def source_calls(text: str, name: str) -> dict:
    """The loads and counted calls in the device function `name` of `text`."""
    body = function_body(text, name)
    counts = {}
    for call in ("ld4", "gram_tile", "gram_vec4", "st4"):
        n = len(re.findall(r"\b" + call + r"\(", body))
        if n:
            counts[call] = n
    return counts


def source_constants(text: str) -> dict:
    """The values of `CONSTANTS`'s names in the source."""
    out = {}
    for name in CONSTANTS:
        m = re.search(r"constexpr int " + name + r" = (\d+);", text)
        if m is None:
            raise KeyError(f"no constant {name} in the source")
        out[name] = int(m.group(1))
    return out


def counts(K: int) -> dict:
    """Float32 instructions and shared-memory bytes of one window of K knots
    in the kernel's Gram products (and the expansion that feeds them)."""
    N, R, T, G = (CONSTANTS[k] for k in ("kNV", "kRows", "kTile", "kGroup"))
    tiles = N // T
    d_units, l_units = tiles * (tiles + 1) // 2, tiles * tiles
    mirrors = d_units - tiles
    intervals = K - 1
    tile_fp = T * T * (2 * R - 1)        # 16 products in row 0, then 16 products and 16 additions a row
    vec_fp = T * (2 * R - 1)
    tile_bytes = 2 * R * 16              # two float4 loads a row
    vec_bytes = R * 16 + R * 4           # a float4 of W and the residual's entry a row
    d_grams = 2 * intervals              # Daa of interval k for knot k, Dbb for knot k+1
    fp = (d_grams * d_units * (tile_fp + T * T)      # the Gram tile, then its sum into the knot tile
          + d_grams * mirrors * T * T                # and into the mirror
          + d_grams * tiles * T                      # the diagonal terms
          + intervals * l_units * tile_fp + intervals * tiles * T
          + d_grams * tiles * (vec_fp + 2 * T))      # g: the product, its diagonal term, the sum
    loads = (d_grams * d_units * tile_bytes + K * (d_units + mirrors) * T * 16 + d_grams * tiles * T * 4
             + intervals * l_units * tile_bytes + intervals * tiles * T * 4
             + d_grams * tiles * (vec_bytes + T * 4) + K * tiles * T * 4)
    groups = -(-K // G)
    stores = 4 * (groups * (2 * G + 1) * R * N + K * N * N)  # W rows and knot tiles, groups full
    return dict(fp32=fp, smem_bytes=loads + stores, smem_load_bytes=loads, smem_store_bytes=stores,
                gram_tiles=(d_grams * d_units + intervals * l_units), vec_pieces=d_grams * tiles)


def design_floor(B: int, K: int, clock_mhz: float) -> dict:
    """This design's floor for B windows of K knots at the SM clock: the
    larger of its float32 time and its shared-memory time, in ms."""
    c = counts(K)
    per_s = SMS * clock_mhz * 1e6
    fp_ms = B * c["fp32"] / (F32_LANES_PER_SM * per_s) * 1e3
    smem_ms = B * c["smem_bytes"] / (SMEM_BYTES_PER_SM * per_s) * 1e3
    return dict(floor_ms=max(fp_ms, smem_ms), fp32_ms=fp_ms, smem_ms=smem_ms,
                floor_by="float32 issue" if fp_ms >= smem_ms else "shared memory",
                fp32_per_knot=c["fp32"] / K, smem_bytes_per_knot=c["smem_bytes"] / K)


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock as `nvidia-smi` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])
