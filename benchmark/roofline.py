"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes and operations each kernel's work needs, counted from the cell's
shapes whatever implements it.  Frozen here so that a change to the program
cannot move them.

Sources of the frozen counts (commit 89ed971):
- `btd_work`: `qtos_torch/ops/btd.py::work`;
- `assemble_work`: `qtos_torch/tools/check_assemble.py::{bound, gram_flops}`;
- `tick_work`: `chip_smoke.py`'s phase 6e bound, with the plain tick's
  operation count that `chip_smoke.py::tick_ops_per_tick` gives frozen as
  `TICK_OPS`.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 bandwidth and the
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

NV = 36                 # knot state width
ROW, TRACE, STATE = 37, 56, 45   # tick kernel: table row, trace row, state floats


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the peak bandwidth or
    operations at the float32 peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def btd_work(B: int, K: int, n: int = NV) -> tuple:
    """(bytes, flops) of one block-tridiagonal solve: D, L and b read once
    and x written once; per scenario K Cholesky factorisations and two
    vector solves, and per sub-diagonal block the solves M C^T = L and
    C z = y, the lower triangle of S = D - M M^T, and M z and L^T x."""
    nbytes = 4 * (B * K * n * n + B * (K - 1) * n * n + 2 * B * K * n)
    per = (K * (n**3 / 3 + 4 * n * n)
           + (K - 1) * ((n + 1) * n * n + n * n * (n + 1) + 4 * n * n))
    return nbytes, B * per


def assemble_work(B: int, K: int, grid_cells: int) -> tuple:
    """(bytes, flops) of one Gauss-Newton assembly: x, the per-knot aux and
    contacts, the per-window start and goal and both terrain grids (height
    and slope, `grid_cells` each) read once, D, L, g and the merit written
    once; the multiply-adds of the three 12-row Gram products and two
    matrix-vector products of every interval."""
    inputs = B * K * (NV + 4 * 7) + K * 2 + B * 28 + 2 * grid_cells
    outputs = B * K * NV * NV + B * (K - 1) * NV * NV + B * K * NV + B
    flops = B * (K - 1) * 2 * (3 * NV * NV * 12 + 2 * NV * 12)
    return 4 * (inputs + outputs), flops


# Floating-point results of one plain tick at B=1 (every non-view aten
# operation's output elements), counted once on the CPU at commit 89ed971.
TICK_OPS = 2426


def tick_work(B: int, T: int) -> tuple:
    """(bytes, flops) of one tick-kernel launch: each table row read and
    each trace row written once, the state read and written, n_valid read;
    `TICK_OPS` results per episode-tick."""
    nbytes = 4 * (B * T * (ROW + TRACE) + 2 * B * STATE + B)
    return nbytes, B * T * TICK_OPS
