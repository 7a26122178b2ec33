r"""A quick check of the tick kernel on one CUDA card, for after an edit of
`qtos_torch/csrc/tick.cu`: shorter than `chip_smoke.py`.

    python3 -m qtos_torch.tools.check_tick [TICKS]

Builds the kernel (printing the ptxas report: registers, spills), solves 256
trot windows on flat ground (plane x3, K=41, goals 0.3-0.8 m, three LM
iterations), holds the kernel against the plain loop on
the card at B=4 over the first TICKS rows (default 200) and prints the largest
difference of each trace entry, then times the kernel at B=1 and B=256 over
the whole 2,501-row tables (CUDA events over 3 calls).  It needs a card and
exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import torch

from qtos_torch.control import ControlParams
from qtos_torch.control.loop import _hold_ticks, _scan_ticks, state_from_row
from qtos_torch.ops import tick
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
from qtos_torch.terrain import make_terrain


def _episodes(state, n):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name)[:n].contiguous()
                                         for f in dataclasses.fields(state)})


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("check_tick: needs a CUDA card", file=sys.stderr)
        return 1
    ticks = int(argv[1]) if len(argv) > 1 else 200
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.time()
    tick.build(verbose=True)
    print(f"build {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    terrain = make_terrain(["plane"] * 3)
    B = 256
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, B, device=dev), 0.0), K=41)
    res = solve_batch(specs, terrain, SolverConfig(max_iters=3, rescue_iters=12))
    tables = sample_trajectory(res.x, specs)[0].contiguous()
    params = ControlParams()
    s0 = _hold_ticks(state_from_row(tables[:, 0], terrain, params), terrain, params, 50)

    short, s4 = tables[:4, :ticks].contiguous(), _episodes(s0, 4)
    _, traces = tick.tick_scan(short, s4, terrain, params)
    _, plain = _scan_ticks(short, s4, terrain, params)
    print(f"kernel vs plain loop on the card, B=4, {ticks} ticks, largest |diff|: "
          + ", ".join(f"{k} {float((traces[k] - plain[k]).abs().max()):.3e}" for k in traces), flush=True)

    for n in (1, B):
        tab, st = tables[:n].contiguous(), _episodes(s0, n)
        tick.tick_scan(tab, st, terrain, params)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            tick.tick_scan(tab, st, terrain, params)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        T = tab.shape[1]
        print(f"B={n} T={T}: kernel {ms:.3f} ms per call = {ms / T * 1e3:.3f} us per tick", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
