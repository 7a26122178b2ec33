"""The readings that the limits of `correct` are set from, for one cell on
this machine's card: for each seed, a short window of the program at the
cell's own load and its numbers against the reference, and on the first
seeds the same numbers with each control put in the program's place: the
reference at a lower precision (`tf32`; `bfloat16` for playback), a fault
of the driver's `FAULTS` planted in the reference, or (`card`, playback)
the reference's own loop on the card.

    python3 benchmark/control.py --workload CELL --seeds 12 --control-seeds 3 --seconds 3 \
        --controls tf32,damping_clamp [--out PATH]

One JSON line per seed on standard output, and in PATH when given.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--controls", default="tf32", help="comma-separated: precisions or the driver's faults")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    import qtos_torch  # noqa: F401

    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    driver = harness.load_module("drivers", cell["driver"]).Driver
    out = open(args.out, "a") if args.out else None
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        drv = driver(cell, seed, device)
        start, n = time.perf_counter(), 0
        while time.perf_counter() - start < args.seconds:
            drv.step(n)
            n += 1
        drv.release()
        t = time.perf_counter()
        rec = dict(cell=args.workload, seed=seed, steps=n, attempted=drv.attempted, failed=drv.failed,
                   program={c["name"]: c["value"] for c in drv.check()}, check_s=time.perf_counter() - t,
                   detail=getattr(drv, "detail", None))
        if i < args.control_seeds:
            rec["controls"] = {}
            for name in args.controls.split(","):
                t = time.perf_counter()
                try:
                    got = {c["name"]: c["value"] for c in drv.control(name)}
                except Exception as e:          # a control that crashes has failed
                    got = dict(crashed=f"{type(e).__name__}: {e}"[:300])
                rec["controls"][name] = dict(got, seconds=time.perf_counter() - t, detail=getattr(drv, "detail", None))
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
