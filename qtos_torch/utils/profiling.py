"""Tracing / profiling (port of `qtos_tpu.utils.profiling`).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (host operators and, on a card, device kernels) of
  everything run inside it into `logdir`.
- ``annotate(name)``: named region that shows up inside the trace.
- ``solve_telemetry(result, wall_s)``: per-batch solver telemetry —
  solves/s, convergence counts, violation quantiles.
- ``Timer``: blocking wall timer (waits for the device so asynchronous
  dispatch does not hide device time).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "./logs/torch-trace"):
    """Capture a torch.profiler trace of the enclosed block.

    The trace is written to ``<logdir>/trace.json`` when the block ends; view
    it with chrome://tracing or Perfetto.  A 1 kHz run records several
    hundred events per tick: trace short runs.
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region (torch.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield


def _tensor_leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensor_leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensor_leaves(v)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensor_leaves(getattr(obj, name))


class Timer:
    """Wall timer that blocks on device results.

    >>> with Timer() as t:
    ...     out = fn(x)
    ...     t.block(out)
    >>> t.elapsed
    """

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.elapsed = None
        return self

    def block(self, *outs):
        """Wait until every tensor in `outs` (tensors, or dataclasses, dicts
        and sequences of them) is computed: one synchronise per CUDA device
        they live on, nothing for CPU tensors."""
        devices = {t.device for o in outs for t in _tensor_leaves(o) if t.device.type == "cuda"}
        for dev in devices:
            torch.cuda.synchronize(dev)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def solve_telemetry(result, wall_s: float | None = None) -> dict:
    """Summarize a SolveResult batch into a flat metrics dict."""
    status = np.atleast_1d(_np(result.status))
    viol = np.atleast_1d(_np(result.max_violation))
    merit = np.atleast_1d(_np(result.merit))
    B = int(status.shape[0])
    out = {
        "batch": B,
        "converged": int((status == 0).sum()),
        "convergence_rate": float((status == 0).mean()),
        "max_violation_p50": float(np.quantile(viol, 0.5)),
        "max_violation_p95": float(np.quantile(viol, 0.95)),
        "max_violation_max": float(viol.max()),
        "merit_p50": float(np.quantile(merit, 0.5)),
        "iters": int(np.max(np.atleast_1d(_np(result.iters)))),
    }
    if wall_s is not None and wall_s > 0:
        out["wall_s"] = float(wall_s)
        out["solves_per_s"] = float(B / wall_s)
    return out
