#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: batched SOLO12 gait-NLP solves
per second on one card.  The counterpart of `bench.py`, on the same
distribution: plane x3, K=41, goals 0.3..0.8 m at y=0,
`SolverConfig(max_iters=3, rescue_iters=12)`, the batch sizes of
`QTOS_BENCH_BATCHES` (default 1024 and 8192).

    python3 bench_torch.py                                  # on the card
    QTOS_BENCH_BATCHES=2 python3 bench_torch.py --device cpu

Per size: one warm-up call (on the card it builds the kernels at first use),
then `REPEATS` timed calls of `solve_batch`, each on the host clock and
ended, as in `bench.py`, by a host read of the statuses.  One `#` line per
size: the median call's time and rate, min / median / max over the calls,
the converged count, the BTD and assembly kernels' launches per call, and
pass 1's operations counted from the kernels' shapes (`pass1_flops`) with the
rate they give at the median; on the card also their share of the H100's
float32 peak.  The last line is one JSON object with `bench.py`'s keys; its
value is the best size's median rate.  Exit 1 when any scenario of any size
did not converge, 2 when the device is not there: with no `--device` it is
the card, and the script never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

import qtos_torch  # noqa: F401  (sets TF32 off: bench.py's "highest" matmul precision)
from qtos_torch.device import resolve_device
from qtos_torch.ops.assemble import assemble_kernel
from qtos_torch.ops.btd import btd_solve, work
from qtos_torch.ops.lm_restore import restore_rejected
from qtos_torch.solver import SolverConfig, default_spec, solve_batch
from qtos_torch.solver.spec import NV
from qtos_torch.terrain import make_terrain
from qtos_torch.tools.check_assemble import PEAK_F32_FLOPS, gram_flops
from qtos_torch.tools.kit import card

# bench.py's settings (tests/test_torch_bench.py reads them from its source)
BASELINE_SOLVES_PER_S = 1.3       # TOWR/IPOPT per CPU core (BASELINE.md)
TILES = ["plane", "plane", "plane"]
K = 41
MAX_ITERS, RESCUE_ITERS = 3, 12
GOALS = (0.3, 0.8)
DEFAULT_BATCHES = "1024,8192"
REPEATS = 5


def solver_config() -> SolverConfig:
    return SolverConfig(max_iters=MAX_ITERS, rescue_iters=RESCUE_ITERS)


def build_specs(B: int, device) -> tuple:
    """(specs, terrain): B windows on plane x3, goals evenly from 0.3 to 0.8 m
    at y=0, K=41, on `device`."""
    terrain = make_terrain(TILES, device=device)
    goals = torch.linspace(GOALS[0], GOALS[1], B, device=terrain.device)
    return default_spec(terrain, goal_xy=(goals, 0.0), K=K, device=terrain.device), terrain


def time_solves(specs, terrain, cfg: SolverConfig, repeats: int = REPEATS) -> dict:
    """One warm-up call of `solve_batch`, then `repeats` timed calls, each
    ended by a host read of the statuses.  Returns the seconds of each call,
    the fewest converged scenarios of any call, the kernels' launches in each
    call (their counts are set to 0 before each call and read after it; of
    the BTD solve's, those of its small-batch kernel apart) and the last
    call's result."""
    int((solve_batch(specs, terrain, cfg).status == 0).sum())
    seconds, converged, btd, small, asm, restore = [], [], [], [], [], []
    for _ in range(repeats):
        btd_solve.launches = btd_solve.small_launches = assemble_kernel.launches = restore_rejected.launches = 0
        t0 = time.perf_counter()
        res = solve_batch(specs, terrain, cfg)
        converged.append(int((res.status == 0).sum()))
        seconds.append(time.perf_counter() - t0)
        btd.append(btd_solve.launches)
        small.append(btd_solve.small_launches)
        asm.append(assemble_kernel.launches)
        restore.append(restore_rejected.launches)
    return dict(B=int(res.status.shape[0]), seconds=seconds, converged=min(converged),
                btd_launches=btd, small_btd_launches=small, assemble_launches=asm, restore_launches=restore,
                result=res)


def pass1_flops(B: int, cfg: SolverConfig) -> int:
    """Operations of one pass-1 call at (B, K=41): per LM iteration the BTD
    solve's (`qtos_torch.ops.btd.work`) and the assembly's Gram products
    (`qtos_torch.tools.check_assemble.gram_flops`)."""
    return cfg.max_iters * (work(B, K, NV)[1] + gram_flops(B, K))


def card_line(dev: torch.device) -> str:
    """The device the times were taken on: for a card, its name and power
    limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return f"# device {dev.type}"
    try:
        return f"# {card(index=dev.index)}"
    except RuntimeError:
        return f"# {torch.cuda.get_device_name(dev)}, power limit not read (nvidia-smi failed)"


def describe(t: dict, flops: int, on_card: bool) -> str:
    """`bench.py`'s `#` line for one size, at the median call, with the
    spread and the launches."""
    B, s = t["B"], t["seconds"]
    dt = statistics.median(s)
    line = (f"# B={B}: {dt:.3f}s -> {B / dt:.1f} solves/s ({t['converged']}/{B} converged); {len(s)} calls "
            f"min / median / max {min(s):.4f} / {dt:.4f} / {max(s):.4f} s; launches per call btd "
            f"{t['btd_launches']}, assembly {t['assemble_launches']}, LM restore {t['restore_launches']}, of the "
            f"btd the small-batch kernel's {t['small_btd_launches']}")
    fps = flops / dt
    line += f" | {flops / 1e9:.1f} GFLOP pass-1 -> {fps / 1e12:.3f} TFLOP/s"
    if on_card:
        line += f" (~{100 * fps / PEAK_F32_FLOPS:.1f}% of f32 peak)"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda; never falls back to the CPU)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_torch: {e}", file=sys.stderr, flush=True)
        return 2
    print(card_line(dev), flush=True)

    sizes = tuple(int(s) for s in os.environ.get("QTOS_BENCH_BATCHES", DEFAULT_BATCHES).split(","))
    cfg = solver_config()
    best, all_converged = 0.0, True
    for B in sizes:
        specs, terrain = build_specs(B, dev)
        t = time_solves(specs, terrain, cfg)
        del t["result"]
        print(describe(t, pass1_flops(B, cfg), dev.type == "cuda"), flush=True)
        all_converged = all_converged and t["converged"] == B
        best = max(best, B / statistics.median(t["seconds"]))
        del specs, terrain
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    print(json.dumps({
        "metric": "gait_nlp_solves_per_s",
        "value": round(best, 1),
        "unit": "solves/s/chip",
        "vs_baseline": round(best / BASELINE_SOLVES_PER_S, 1),
    }), flush=True)
    return 0 if all_converged else 1


if __name__ == "__main__":
    sys.exit(main())
