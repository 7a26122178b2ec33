"""The small-batch BTD kernel's design floor: the least time its dependent
chain can take, from the latencies of the chain's operations as the probe
`op_cycles.cu` measures them on the card (the probe of
`qtos_torch/tools/tick_floor.py`) and the chain's operations as
`btd_small_kernel` in `qtos_torch/csrc/btd.cu` runs them.

A solve is K Cholesky factorisations and K back-pass steps in a row, with
the row solves and the rank update of each of the K - 1 later knots between
two factorisations; the row solves run beside the Cholesky before them, so
only their last column block, after the Cholesky's last, is on the chain.
The floor is the sum of those stages' chains, each counted by hand from the
source as operations of the probe:

- the Cholesky (chol_inplace), per column block jb of T = ceil(n/4): the
  sums of row_block4 (4 jb FMAs on each of four independent chains), the
  shuffles that gather the diagonal block, its factor (four reciprocal
  square roots, each after a max, and the three products and three FMAs
  between them), the last product of the row's triangle, and the store and
  barrier that hand the block to the next (two shared-memory latencies);
- the row solves' last block: 4 (T - 1) FMAs and the triangle's four
  products and three FMAs, after a named barrier and a load, then the
  block's barrier;
- the rank update: one tile's n FMAs, a load and the subtraction, then the
  block's barrier;
- the back pass: L_k^T x_{k+1} (n FMAs and a load; none at the last knot),
  and for each of the 2 T diagonal blocks of the two triangular solves
  (solve_block, called by chol_solve_rows) the owner's four products and
  three FMAs, a shuffle and the next owner's four FMAs.

The long-horizon kernel (block cyclic reduction, `reduce::btd_kernel`) has
its own floor, `reduce_floor`: its chain is the ceil(log2 K) + 1 phases of
the forward pass and the ceil(log2 K) levels of the back pass, each on the
critical path of one item, counted from `phase_item` and `back_item` the
same way:

- a phase's updates (levels past the first): one 4 x 4 tile of the lower
  triangle, two sums of n FMAs each (tile_nt) after a load, the subtraction,
  then the block's barrier;
- its Cholesky: the small kernel's stage;
- its row solves, which run behind the Cholesky as in the small kernel:
  the last column block after the named barrier that hands it on, then the
  block's barrier;
- a back level: the two sums W_k x_a and V_k x_c (n FMAs each, side by side,
  and two subtractions) after a load, then the n steps of C^T u = r
  (back_solve_vec), each a shuffle, a product and an FMA; the last phase
  ends in one such triangular solve too.

The grid barrier between two phases and the round trips to L2 that start
each item are not operations of the probe: the floor leaves them out, so
what a launch takes beyond it is theirs and the issue slots'.

An FMA is taken at the latency of `fadd` (the probe is built with
--fmad=false, and on Hopper an FMA, an add and a product have one latency);
"simple" (a product, a max, an add) at the slower of `fadd` and `fmul`.
`SOURCE_CALLS` records the counted calls that each function on the chain
holds, and `tests/test_torch_btd_floor.py` holds it to btd.cu: an edit that
adds or removes one fails there until the chain is counted again.
"""

from __future__ import annotations

import math
import re

from qtos_torch.tools.kit import function_body

# The calls in btd.cu that stand for an operation of the probe.
CALLS = {"rsqrtf": "rsqrt", "__shfl_sync": "shfl", "__syncthreads": "bar", "bar_sync": "bar",
         "bar_arrive": "bar"}
# The counted calls each function on the chain holds, as btd.cu holds them.
SOURCE_CALLS = {
    "chol_inplace": dict(rsqrt=1, shfl=1),
    "forward_row_block": dict(),
    "rank_tiles": dict(),
    "chol_solve_rows": dict(),
    "solve_block": dict(shfl=1),
    "btd_small_kernel": dict(bar=5),
    "phase_item": dict(bar=5),
    "tile_nt": dict(),
    "back_item": dict(),
    "back_solve_vec": dict(shfl=1),
}


def stage_ops(n: int) -> dict:
    """Operations on the chain of each stage of one knot at width n."""
    T = math.ceil(n / 4)
    return {
        "cholesky": dict(fma=2 * T * (T - 1) + 3 * T, rsqrt=4 * T, simple=4 * T, shfl=T, lds=2 * T),
        "row solves, last block": dict(fma=4 * (T - 1) + 3, simple=4, lds=1, bar=2),
        "rank update": dict(fma=n, simple=1, lds=1, bar=1),
        "L^T x": dict(fma=n, lds=1),
        "vector solves": dict(fma=2 * T * (3 + 4), simple=2 * T * 4, shfl=2 * T),
    }


def knots_of(stage: str, K: int) -> int:
    """How many of the K knots run `stage` on the chain."""
    return K if stage in ("cholesky", "vector solves") else K - 1


def chain_ops(K: int, n: int) -> dict:
    """Operations on the chain of a whole solve at (K, n)."""
    total = {}
    for stage, ops in stage_ops(n).items():
        for op, c in ops.items():
            total[op] = total.get(op, 0) + c * knots_of(stage, K)
    return total


def design_floor(cycles: dict, K: int, n: int, clock_mhz: float) -> tuple:
    """This design's floor for one solve at (K, n), at the probe's `cycles`
    per operation and the SM clock in MHz.  Returns (ms, cycles, cycles per
    stage over the whole solve)."""
    per = dict(cycles, fma=cycles["fadd"], simple=max(cycles["fadd"], cycles["fmul"]))
    stages = {stage: knots_of(stage, K) * sum(c * per[op] for op, c in ops.items())
              for stage, ops in stage_ops(n).items()}
    total = sum(stages.values())
    return total / (clock_mhz * 1e3), total, stages


def source_calls(text: str, name: str) -> dict:
    """The calls of `CALLS` in the function `name` of `text`, by the
    operation each stands for."""
    body = function_body(text, name)
    counts = {}
    for call, op in CALLS.items():
        n = len(re.findall(r"\b" + re.escape(call) + r"\(", body))
        if n:
            counts[op] = counts.get(op, 0) + n
    return counts


def levels(K: int) -> int:
    """The long-horizon kernel's levels below the last: the least Lv with
    2^Lv >= K."""
    return max(K - 1, 0).bit_length()


def reduce_stage_ops(n: int) -> dict:
    """Operations on the chain of each stage of the long-horizon kernel at
    width n, per phase or back level that runs it."""
    T = math.ceil(n / 4)
    return {
        "updates": dict(fma=2 * n, simple=1, lds=1, bar=1),
        "cholesky": stage_ops(n)["cholesky"],
        "row solves": stage_ops(n)["row solves, last block"],
        "W x + V x": dict(fma=n, simple=2, lds=1),
        "C^T solve": dict(fma=n, simple=n, shfl=n),
    }


def reduce_runs(stage: str, K: int) -> int:
    """How many phases or back levels of a solve at K knots run `stage` on
    the chain: every phase factors and solves rows, every one past the first
    updates, every back level (and the last phase) solves C^T u = r."""
    Lv = levels(K)
    return {"updates": Lv, "cholesky": Lv + 1, "row solves": Lv + 1, "W x + V x": Lv, "C^T solve": Lv + 1}[stage]


def reduce_floor(cycles: dict, K: int, n: int, clock_mhz: float) -> tuple:
    """The long-horizon kernel's floor for one solve at (K, n), at the probe's
    `cycles` per operation and the SM clock in MHz, without its grid barriers
    and L2 round trips.  Returns (ms, cycles, cycles per stage over the whole
    solve)."""
    per = dict(cycles, fma=cycles["fadd"], simple=max(cycles["fadd"], cycles["fmul"]))
    stages = {stage: reduce_runs(stage, K) * sum(c * per[op] for op, c in ops.items())
              for stage, ops in reduce_stage_ops(n).items()}
    total = sum(stages.values())
    return total / (clock_mhz * 1e3), total, stages
