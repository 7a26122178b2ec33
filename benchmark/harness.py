"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything a cell needs is found by name from data files:

- `BENCHMARK.json` (the repo's root): the cells, and for each metric the
  cells that report it;
- `workloads/<cell>.json`: the configuration, the traffic mix, the driver,
  the chips, the limits of the numbers compared;
- `configs/<config>.json`, `traffic/<traffic>.json`: sizes and the mix's
  parameters, read by `traffic.py`;
- `drivers/<driver>.py`: a `Driver` class that drives one entry of the
  program in a closed loop and checks what it produced;
- `metrics/<metric>.py`: a `read(summary, ctx)` for each per-layer metric,
  which returns a number or None when it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import re
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# top-level module names that no run may load: JAX, its libraries, and the
# JAX package that the measured port was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "qtos_tpu")
TILE_CELLS = 20          # a terrain tile is 20 x 20 cells of 0.1 m


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def index() -> dict:
    return read_json(ROOT, "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's workload file, with its configuration under "cfg" and its
    traffic mix under "mix"."""
    if not NAME_RE.match(name):
        raise ValueError(f"not a cell name: {name!r}")
    cell = read_json(BENCH_DIR, "workloads", f"{name}.json")
    cell["name"] = name
    cell["cfg"] = read_json(BENCH_DIR, "configs", f"{cell['config']}.json")
    cell["mix"] = read_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    return cell


def metrics_of(idx: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that the cell
    reports."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return [m for m in idx["end_to_end"] if mine(m)], [m for m in idx["per_layer"] if mine(m)]


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark's folder, by file name (metric
    names hold dots)."""
    if not NAME_RE.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def terrain_grid(cfg: dict, device):
    """The configuration's height grid (H, W): its tiles side by side along
    x, "plane" flat and any other tile read from `configs/tiles/<name>.csv`."""
    import numpy as np
    import torch

    tiles = []
    for name in cfg["tiles"]:
        if name == "plane":
            tiles.append(np.zeros((TILE_CELLS, TILE_CELLS), np.float32))
        else:
            tiles.append(np.loadtxt(os.path.join(BENCH_DIR, "configs", "tiles", f"{name}.csv"),
                                    delimiter=",", dtype=np.float32))
    return torch.as_tensor(np.concatenate(tiles, axis=1), device=device)


class Reservoir:
    """A uniform sample of at most `size` of the items offered, drawn from
    the seed (reservoir sampling): `offer(n)` says whether the n-th item
    (from 0) is kept, and in which slot."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed)

    def offer(self, n: int):
        if n < self.size:
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.size else None


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(args, t0: float) -> int:
    """One run; returns the exit code.  `t0` is the process's start on the
    `time.perf_counter` clock."""
    idx = index()
    cell = load_cell(args.workload)
    if not any(w["name"] == args.workload for w in idx["workloads"]):
        raise ValueError(f"{args.workload!r} is not a cell of BENCHMARK.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    try:
        import qtos_torch  # noqa: F401  (the system under test; sets TF32 off)
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = measure(idx, cell, args, device, t0)
    found = forbidden_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def measure(idx: dict, cell: dict, args, device, t0: float) -> dict:
    """Set-up, the window, the check: the result line of one run on
    `device` (the tests call this on the CPU, at small sizes)."""
    import torch

    from benchmark import trace

    on_card = device.type == "cuda"
    e2e, per_layer = metrics_of(idx, cell["name"])
    drv = load_module("drivers", cell["driver"]).Driver(cell, args.seed, device)
    if on_card:
        torch.cuda.synchronize()
    # set-up is the program's: the seconds the plain reference spent making
    # a cell's inputs (solved tables) are left out
    setup_s = time.perf_counter() - t0 - getattr(drv, "reference_s", 0.0)

    def window():
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            start, n = time.perf_counter(), 0
            while True:
                drv.step(n)
                n += 1
                if time.perf_counter() - start >= args.seconds:
                    return time.perf_counter() - start

    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            window_s = window()
        summary = trace.summarize(prof, trace.SPAN_PREFIX + "window")
        del prof
    else:
        window_s = window()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    values = drv.end_to_end(window_s)
    ctx = dict(cell=cell, counters=drv.counters(), shapes=drv.shapes())
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check()

    device_info = dict(platform="gpu" if on_card else device.type,
                       kind=torch.cuda.get_device_name(device) if on_card else device.type,
                       count=cell["chips"], memory_peak_bytes=int(memory_peak))
    metrics = {}
    if args.trace:
        for m in per_layer:
            v = load_module("metrics", m["name"]).read(summary, ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    else:
        values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    line = dict(correct=all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks),
                attempted=drv.attempted,
                failed=drv.failed, metrics=metrics, device=device_info)
    if args.trace:
        line["breakdown"] = dict(device_ops=summary["device_ops"], idle_gaps=summary["idle_gaps"])
    # a non-finite gap is written as text: JSON has no NaN
    line["checks"] = {c["name"]: dict(value=c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                                      limit=c["limit"]) for c in checks}
    return line
