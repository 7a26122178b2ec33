"""Aggregates of a `torch.profiler` trace of one measured window.

Only aggregates are kept: device time and launches by kernel name, the
union of the device's busy intervals, the window's length, the device
operations that took most time and the longest idle gaps by what the host
was doing.  No trace file is written.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

SPAN_PREFIX = "bench::"


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _innermost(cpu, starts, t):
    """Name of the shortest host operation that covers time t."""
    best = None
    i = bisect.bisect_right(starts, t) - 1
    # host operations nest, so the covering ones are among the last that
    # started before t; look back a bounded number
    for j in range(i, max(-1, i - 256), -1):
        a, b, name = cpu[j]
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host outside any operation"


def summarize(prof, window: str) -> dict:
    """The aggregates of the window that the host span `window` (a
    `record_function` name) covers, from the profiler's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if name.startswith(SPAN_PREFIX) or e.is_user_annotation():
                continue
            dev.append((a, b, name))
        elif name == window:
            span = (a, b)
        elif not name.startswith("cu"):           # not a CUDA runtime or driver call
            cpu.append((a, b, name))
    if span is None:
        raise LookupError(f"span {window!r} not in the trace")
    w0, w1 = span
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    kernels = defaultdict(lambda: [0, 0.0])
    for a, b, n in dev:
        kernels[n][0] += 1
        kernels[n][1] += (b - a) * 1e-9
    busy_s = union_length((a, b) for a, b, _ in dev) * 1e-9

    # idle gaps, each named by the innermost host operation at its middle
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps = defaultdict(float)
    end = w0
    for a, b, _ in sorted(dev):
        if a > end:
            gaps[_innermost(cpu, starts, (a + end) / 2)] += (a - end) * 1e-9
        end = max(end, b)
    if w1 > end:
        gaps[_innermost(cpu, starts, (w1 + end) / 2)] += (w1 - end) * 1e-9

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return dict(
        window_s=(w1 - w0) * 1e-9,
        busy_s=busy_s,
        kernels={n: dict(launches=c, seconds=s) for n, (c, s) in kernels.items()},
        device_ops=[[n, s] for n, (_, s) in top[:10]],
        idle_gaps=sorted(([n, s] for n, s in gaps.items()), key=lambda kv: -kv[1])[:10],
    )


def kernel_time(summary: dict, kernel: str) -> tuple:
    """(launches, device seconds) of the kernels named `kernel` (a
    `__global__` name, which the trace may wrap in its signature)."""
    word = re.compile(rf"(?<!\w){re.escape(kernel)}(?!\w)")
    n, s = 0, 0.0
    for name, k in summary["kernels"].items():
        if word.search(name):
            n += k["launches"]
            s += k["seconds"]
    return n, s


def idle_pct(summary: dict) -> float:
    """Share of the window in which no operation ran on the device."""
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def roofline_pct(summary: dict, kernel: str, bound_s: float):
    """100 x the least time one launch could take over the kernel's device
    time per launch in the window; None where the kernel never ran."""
    n, s = kernel_time(summary, kernel)
    return 100.0 * bound_s * n / s if n else None
