r"""A check of the tick kernel on one CUDA card, for after an edit of
`qtos_torch/csrc/tick.cu`, and several versions of its source side by side:
shorter than `chip_smoke.py`.

    python3 -m qtos_torch.tools.check_tick [TICKS] [NAME=PATH[!REGEX[!TEXT]] ...]

With no version it checks `new=qtos_torch/csrc/tick.cu`.  Each PATH is a
version of `tick.cu` with its C entry points (`tick_run` with or without the
scratch argument), built with the flags of `qtos_torch.ops.tick.build`.  With
`!REGEX` the version is a copy of PATH without the lines that match REGEX,
and with `!REGEX!TEXT` one in which each match is replaced by TEXT: an
ablation, whose answers are wrong but whose time says what the removed work
costs.  PATH may also be the NAME of an earlier version, whose edited copy is
then edited again.  For example

    python3 -m qtos_torch.tools.check_tick new=qtos_torch/csrc/tick.cu \
        notrace='old.cu!out\[0\] = norm3'

The script prints each build's ptxas report (registers, stack frame, spill
stores and loads) and, where the toolkit has `cuobjdump`, the local-memory
instructions (LDL, STL) of each kernel's SASS.  It solves 256 trot windows on
flat ground (plane x3, K=41, goals 0.3-0.8 m, three LM iterations), holds
every version against the plain loop on the card at B=4 over the first TICKS
rows (default 200), then plays the whole 2,501-row tables at B=1 and B=256
through every version and the plain loop and prints, for each version against
the first and against the plain loop, the largest difference of every trace
entry and final state leaf, whether the two are equal bit for bit and, where
not, the first tick and entry at which they part.  Then it times the versions
at B=1 and B=256 in turns (v1, v2, ..., v2, v1; CUDA events over 3 calls
each).  There the versions of one scratch width share one scratch, so a copy
without the table pass reads the rows that the versions before it wrote; the
line says whether each version's chain entries (pos, q, qd, tau) equal the
first's.  Last it prints the design's floor (`qtos_torch.tools.tick_floor`,
whose probe it builds beside the versions) and the card's name, power limit
and SM clock.  It needs a card and exits non-zero without one, or when a
build or a launch fails.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from qtos_torch.control import ControlParams
from qtos_torch.control.loop import _hold_ticks, _scan_ticks, state_from_row
from qtos_torch.ops import tick
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
from qtos_torch.terrain import make_terrain
from qtos_torch.tools import tick_floor

STATE_LEAVES = [name for name, _, _ in tick.STATE_LAYOUT]
# The trace entries the chain writes; the trace pass writes the others.
CHAIN_ENTRIES = ("pos", "q", "qd", "tau")


def _episodes(state, n):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name)[:n].contiguous()
                                         for f in dataclasses.fields(state)})


def _sources(specs: list[str], out_dir: str) -> dict:
    """NAME -> path of each version's source, edited copies written to
    `out_dir`."""
    paths = {}
    for spec in specs:
        name, _, rest = spec.partition("=")
        src, *edit = rest.split("!", 2)
        src = paths.get(src, src)
        if edit:
            pattern = re.compile(edit[0])
            with open(src) as f:
                lines = f.readlines()
            if len(edit) == 1:
                lines = [line for line in lines if not pattern.search(line)]
            else:
                lines = [pattern.sub(lambda _: edit[1], line) for line in lines]
            src = os.path.join(out_dir, f"{name}.cu")
            with open(src, "w") as f:
                f.writelines(lines)
        paths[name] = src
    return paths


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def _build(name: str, src: str, out_dir: str) -> tuple:
    """Builds one version; returns (library path, report lines)."""
    out = os.path.join(out_dir, f"lib_{name}.so")
    proc = subprocess.run(tick.nvcc_command(src, out, verbose=True), capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    report = [f"{name}: " + line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if re.search(r"Compiling entry|registers|stack frame", line)]
    tool = _cuobjdump()
    if tool:
        sass = subprocess.run([tool, "-sass", out], capture_output=True, text=True).stdout
        for part in sass.split("Function : ")[1:]:
            fn = part.split("\n", 1)[0].strip()
            ldl = len(re.findall(r"\bLDL\b", part))
            stl = len(re.findall(r"\bSTL\b", part))
            instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
            report.append(f"{name}: SASS {fn}: {instr} instructions, {ldl} LDL, {stl} STL")
    else:
        report.append(f"{name}: no cuobjdump in the toolkit: local-memory instructions not counted")
    return out, report


class _NoScratch:
    """A library of a version whose `tick_run` takes no scratch argument,
    with the interface of `tick.load_library`'s (the scratch is dropped)."""

    def __init__(self, path: str):
        self._lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self._lib.tick_run.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, ci, ci, vp, vp, ci, ci, ci, vp]
        self._lib.tick_run.restype = ci
        self._lib.tick_param_layout.restype = ctypes.c_char_p

    def tick_param_layout(self):
        return self._lib.tick_param_layout()

    @staticmethod
    def tick_scratch_floats():
        return 0

    def tick_run(self, *args):
        return self._lib.tick_run(*args[:12], *args[13:])


def _load(path: str):
    if hasattr(ctypes.CDLL(path), "tick_scratch_floats"):
        return tick.load_library(path)
    return _NoScratch(path)


def _play(lib, table, state, terrain, params, scratch=None):
    stream = torch.cuda.current_stream().cuda_stream
    return tick.run(lib, state, terrain, params, table=table, stream=stream, scratch=scratch)


def _first_parting(a: dict, b: dict):
    """The first tick at which any trace entry of `a` and `b` differs (NaN
    equal to NaN), and the entries that differ there; None if none does."""
    lead = None
    for name in a:
        x, y = a[name], b[name]
        diff = (x != y) & ~(torch.isnan(x) & torch.isnan(y))
        diff = diff.reshape(x.shape[0], x.shape[1], -1).any(dim=2).any(dim=0)
        idx = torch.nonzero(diff).flatten()
        if idx.numel():
            t = int(idx[0])
            if lead is None or t < lead[0]:
                lead = (t, [name])
            elif t == lead[0]:
                lead[1].append(name)
    return lead


def _compare(label: str, a: tuple, b: tuple) -> None:
    (fa, ta), (fb, tb) = a, b
    trace = {k: float((ta[k] - tb[k]).abs().max()) for k in ta}
    state = {k: float((getattr(fa, k) - getattr(fb, k)).abs().max()) for k in STATE_LEAVES}
    same = (all(torch.equal(ta[k], tb[k]) for k in ta)
            and all(torch.equal(getattr(fa, k), getattr(fb, k)) for k in STATE_LEAVES))
    parting = None if same else _first_parting(ta, tb)
    print(f"{label}: bit for bit {same}"
          + ("" if same else f", first parting tick and entries {parting}")
          + "; largest |diff| traces " + ", ".join(f"{k} {v:.3e}" for k, v in trace.items())
          + "; final state " + ", ".join(f"{k} {v:.3e}" for k, v in state.items()), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("check_tick: needs a CUDA card", file=sys.stderr)
        return 1
    args = argv[1:]
    ticks = int(args.pop(0)) if args and args[0].isdigit() else 200
    specs = args or [f"new={tick.SOURCE}"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)

    with tempfile.TemporaryDirectory(prefix="check_tick_") as tmp:
        srcs = _sources(specs, tmp)
        t0 = time.time()
        with concurrent.futures.ThreadPoolExecutor(len(srcs) + 1) as pool:   # one nvcc per source, all at once
            probe = pool.submit(tick_floor.build_probe)
            built = {name: pool.submit(_build, name, src, tmp) for name, src in srcs.items()}
            built = {name: f.result() for name, f in built.items()}
            probe = tick_floor.load_probe(probe.result())
        for _, report in built.values():
            print("\n".join(report), flush=True)
        print(f"build {time.time() - t0:.1f} s", flush=True)
        libs = {name: _load(path) for name, (path, _) in built.items()}
        _check(libs, probe, ticks)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


def _check(libs: dict, probe, ticks: int) -> None:
    dev = torch.device("cuda")
    terrain = make_terrain(["plane"] * 3)
    B = 256
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, B, device=dev), 0.0), K=41)
    res = solve_batch(specs, terrain, SolverConfig(max_iters=3, rescue_iters=12))
    tables = sample_trajectory(res.x, specs)[0].contiguous()
    params = ControlParams()
    s0 = _hold_ticks(state_from_row(tables[:, 0], terrain, params), terrain, params, 50)
    names = list(libs)

    short, s4 = tables[:4, :ticks].contiguous(), _episodes(s0, 4)
    _, plain = _scan_ticks(short, s4, terrain, params)
    for name, lib in libs.items():
        _, traces = _play(lib, short, s4, terrain, params)
        print(f"{name} vs plain loop on the card, B=4, {ticks} ticks, largest |diff|: "
              + ", ".join(f"{k} {float((traces[k] - plain[k]).abs().max()):.3e}" for k in traces), flush=True)

    for n in (1, B):
        tab, st = tables[:n].contiguous(), _episodes(s0, n)
        T = tab.shape[1]
        runs = {name: _play(lib, tab, st, terrain, params) for name, lib in libs.items()}
        torch.cuda.synchronize()
        plain = _scan_ticks(tab, st, terrain, params)
        for name in names[1:]:
            _compare(f"B={n} T={T} {name} vs {names[0]}", runs[name], runs[names[0]])
        for name in names:
            _compare(f"B={n} T={T} {name} vs plain loop", runs[name], plain)
        del runs, plain

    for n in (1, B):
        tab, st = tables[:n].contiguous(), _episodes(s0, n)
        T = tab.shape[1]
        times = {name: [] for name in names}
        # versions of one scratch width share one scratch, so that a copy
        # without the table pass reads the rows the versions before it wrote
        scratch = {w: torch.empty((n, T, w), device=dev) for w in {lib.tick_scratch_floats() for lib in libs.values()}}
        last = {}
        for name in names + names[::-1]:
            lib = libs[name]
            scr = scratch[lib.tick_scratch_floats()]
            _play(lib, tab, st, terrain, params, scr)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                _, last[name] = _play(lib, tab, st, terrain, params, scr)
            end.record()
            torch.cuda.synchronize()
            times[name].append(round(start.elapsed_time(end) / 3, 3))
        print(f"B={n} T={T} ms per call in turns: {times}; us per tick: "
              + ", ".join(f"{k} {[round(v / T * 1e3, 3) for v in vs]}" for k, vs in times.items())
              + f"; the chain's entries ({', '.join(CHAIN_ENTRIES)}) of the last timed call equal {names[0]}'s: "
              + ", ".join(f"{k} {all(torch.equal(last[k][e], last[names[0]][e]) for e in CHAIN_ENTRIES)}"
                          for k in names[1:]), flush=True)

    cycles = tick_floor.op_cycles(probe)
    clock = tick_floor.sm_clock_mhz()
    ms, per_tick, cycle = tick_floor.design_floor(cycles, tables.shape[1], clock)
    print("dependent cycles per operation " + ", ".join(f"{k} {v:.1f}" for k, v in cycles.items())
          + f"; the design's floor {ms:.4f} ms per {tables.shape[1]}-tick call ({per_tick:.0f} cycles per tick, "
          f"the mean of the cycle {cycle!r}, at {clock:g} MHz)", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
