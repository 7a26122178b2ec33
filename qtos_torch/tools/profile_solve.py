r"""Where the device time of one `solve_batch` call goes.

    python3 -m qtos_torch.tools.profile_solve [--batch 1024 8192] [--K 41] [--device cuda]

Solves the bench distribution (plane x3, trot, goals 0.3-0.8 m,
`max_iters=3, rescue_iters=12`) at each batch size: once to warm up, once
timed on the host clock without the profiler, once under `torch.profiler`.
For each size it prints

  - the 15 device kernels with the most device time, with their launch
    counts;
  - the BTD solve's and the assembly kernel's shares of the device time
    (`btd_kernel` or, at small batches, `btd_small_kernel`; `assemble_kernel`;
    launched through ctypes, so they have no aten operation of their own);
  - assembly's share: the device time of the kernels that the profiled
    call's own `assemble` calls launched (each call marked with a
    `record_function` range, rescue passes on their subsets included) and of
    `assemble_kernel`, which the trace does not attribute to the range (it
    is launched through ctypes), over the call's device busy time;
  - the device's idle share over the profiled call: 1 - (the union of its
    device intervals) / (its span in the trace, from the host's entry into
    `solve_batch` to the end of its last device operation).  The profiler's
    host overhead lengthens that span, so the wall time of the same call
    without the profiler is printed beside it;
  - the aten operations one LM iteration dispatches (counted on the host
    with a `TorchDispatchMode`, views included; the call's count over its
    iterations);

and, last, one JSON line with those numbers per size.  On the CPU
(`--device cpu`, at small sizes) only the operation counts are measured;
every device number reads "not measured".
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import time
from collections import Counter

import torch

from qtos_torch.device import resolve_device
from qtos_torch.solver import SolverConfig, default_spec, solve_batch
from qtos_torch.terrain import make_terrain
from qtos_torch.tools.profile_tick import _card, _CountOps

NOT_MEASURED = "not measured"
# the module, not the function `qtos_torch.solver.solve` that shadows it
solve_mod = importlib.import_module("qtos_torch.solver.solve")


def _synced(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


# the program's root span of a `solve_batch` call, and this tool's range
# over each `assemble` call
SPAN_PREFIX = "qtos::"
CALL, ASSEMBLE = SPAN_PREFIX + "solve_batch", SPAN_PREFIX + "assemble"


@contextlib.contextmanager
def _marked_assembly():
    """Mark every `assemble` call of the solver with a profiler range and
    count the calls and the scenarios they assemble."""
    inner, seen = solve_mod.assemble, {"calls": 0, "rows": 0}

    def marked(x, *args, **kwargs):
        seen["calls"] += 1
        seen["rows"] += x.shape[0]
        with torch.profiler.record_function(ASSEMBLE):
            return inner(x, *args, **kwargs)

    solve_mod.assemble = marked
    try:
        yield seen
    finally:
        solve_mod.assemble = inner


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _tally(events, seen: dict) -> dict:
    """The profiled call's device kernels and copies (without the device-side
    copies of the `record_function` ranges, the program's `qtos::` spans and
    this tool's own, which the trace lists as device events too), its span
    in the trace, the union of its device intervals and the device time of
    the kernels launched inside `assemble` (all us)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith(SPAN_PREFIX)]
    call = next(e for e in events if e.name == CALL and e.device_type == cpu)
    start = call.time_range.start
    end = max([call.time_range.end] + [e.time_range.end for e in kernels])
    return dict(kernels=kernels, span_us=end - start,
                busy_us=_busy_us((e.time_range.start, e.time_range.end) for e in kernels),
                assembly_us=sum(float(e.device_time_total) for e in events
                                if e.name == ASSEMBLE and e.device_type == cpu),
                assemble_calls=seen["calls"], assembled_rows=seen["rows"])


def _profiled(fn) -> dict:
    """`_tally` of one `solve_batch` call, `fn`, under the profiler (the
    call's span is the program's own root span)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with _marked_assembly() as seen, torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return _tally(prof.events(), seen)


def _share(num: float, den: float, what: str) -> float:
    """num / den, unclamped; a ratio outside [0, 1] is reported."""
    r = num / den
    if not 0.0 <= r <= 1.0:
        print(f"# profile_solve: WARNING: {what} reads {r:.4f}, outside [0, 1]", flush=True)
    return r


def profile_once(B: int, K: int = 41, device=None) -> dict:
    """One profiled `solve_batch` call on the bench distribution at batch B."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    terrain = make_terrain(["plane"] * 3, device=dev)
    cfg = SolverConfig(max_iters=3, rescue_iters=12)
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, B, device=dev), 0.0), K=K, device=dev)
    res = solve_batch(specs, terrain, cfg)                                # warm-up, builds the kernel
    t0 = _synced(dev)
    res = solve_batch(specs, terrain, cfg)
    wall = _synced(dev) - t0
    iters = int(res.iters.max())
    with _CountOps() as counter:
        solve_batch(specs, terrain, cfg)
    out = dict(B=B, K=K, device=str(dev), wall_s=wall, iterations=iters,
               converged=int((res.status == 0).sum()), aten_ops_per_iteration=sum(counter.ops.values()) / iters)
    prof = _profiled(lambda: solve_batch(specs, terrain, cfg)) if on_card else None
    if prof is None or not prof["kernels"]:
        out.update(top_kernels=NOT_MEASURED, btd_share=NOT_MEASURED, assembly_share=NOT_MEASURED,
                   idle_share=NOT_MEASURED, device_busy_ms=NOT_MEASURED)
        return out
    kernels, busy_us = prof["kernels"], prof["busy_us"]
    by_name, counts = Counter(), Counter()
    for e in kernels:
        by_name[e.name] += float(e.device_time)
        counts[e.name] += 1
    device_us = sum(by_name.values())
    def is_btd(name):
        return "btd_kernel" in name or "btd_small_kernel" in name

    btd_us = sum(t for name, t in by_name.items() if is_btd(name))
    asm_us = sum(t for name, t in by_name.items() if "assemble_kernel" in name)
    out.update(
        top_kernels=[dict(name=name, ms=t / 1e3, count=counts[name], share=t / device_us)
                     for name, t in by_name.most_common(15)],
        device_busy_ms=busy_us / 1e3,
        span_ms=prof["span_us"] / 1e3,
        btd_share=btd_us / device_us,
        btd_launches=sum(c for name, c in counts.items() if is_btd(name)),
        assemble_kernel_share=asm_us / device_us,
        assemble_kernel_launches=sum(c for name, c in counts.items() if "assemble_kernel" in name),
        assemble_calls=prof["assemble_calls"],
        assembled_rows=prof["assembled_rows"],
        assembly_ms=(prof["assembly_us"] + asm_us) / 1e3,
        assembly_share=(_share(prof["assembly_us"] + asm_us, device_us, "assembly's share")
                        if prof["assembly_us"] + asm_us > 0 else NOT_MEASURED),
        idle_share=1.0 - _share(busy_us, prof["span_us"], "the busy share of the span"),
        kernels_launched=len(kernels),
    )
    return out


def report(out: dict) -> None:
    """The human-readable lines of one `profile_once` result."""
    B, dev = out["B"], out["device"]
    print(f"# profile_solve B={B} K={out['K']} on {dev}: {out['wall_s']:.3f} s without the profiler, "
          f"{out['converged']}/{B} converged, {out['iterations']} LM iterations, "
          f"{out['aten_ops_per_iteration']:.1f} aten operations per LM iteration", flush=True)
    if out["top_kernels"] == NOT_MEASURED:
        print(f"# profile_solve B={B}: device time by kernel, BTD share, assembly share, device idle share: "
              f"{NOT_MEASURED} (no device activity in this run)", flush=True)
        return
    for k in out["top_kernels"]:
        print(f"#   {k['ms']:10.3f} ms {k['share']:7.2%} x{k['count']:<5d} {k['name'][:100]}", flush=True)
    asm = out["assembly_share"]
    asm = asm if isinstance(asm, str) else f"{asm:.2%} ({out['assembly_ms']:.3f} ms)"
    print(f"# profile_solve B={B}: device busy {out['device_busy_ms']:.3f} ms of the profiled call's "
          f"{out['span_ms']:.3f} ms span ({out['wall_s'] * 1e3:.3f} ms without the profiler) in "
          f"{out['kernels_launched']} kernels and copies; device idle {out['idle_share']:.2%} of the span; "
          f"BTD kernel {out['btd_share']:.2%} of device time ({out['btd_launches']} launches); assembly {asm} "
          f"in {out['assemble_calls']} assemble calls over {out['assembled_rows']} scenario-rows, of which the "
          f"assembly kernel {out['assemble_kernel_share']:.2%} of device time "
          f"({out['assemble_kernel_launches']} launches)", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1024, 8192])
    p.add_argument("--K", type=int, default=41)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(_card(), flush=True)
    outs = []
    for B in args.batch:
        outs.append(profile_once(B, args.K, dev))
        report(outs[-1])
    print(json.dumps({"profile_solve": outs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
