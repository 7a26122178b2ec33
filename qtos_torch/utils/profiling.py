"""Tracing / profiling (port of `qtos_tpu.utils.profiling`).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (host operators and, on a card, device kernels) of
  everything run inside it into `logdir`.
- ``annotate(name, n=None, **counts)``: the program's span.  With a profiler
  running, a range in its trace and one record in an in-memory log
  (``spans()``) on the trace's clock; with none, a shared no-op.
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


class _NoSpan:
    """What `annotate` returns with no profiler running: enters and leaves
    without a record, a range or a device operation."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts):
        pass


_NO_SPAN = _NoSpan()
_profiler_enabled = torch._C._autograd._profiler_enabled
# The span's range in the trace.  `torch.profiler.record_function` opens a
# user annotation, and under a profiler that traces the card every operation
# inside one costs ~5 us more on the host (H100 host: a replan's ~16k
# operations took 112 ms in place of 74 under the profiler); this range is a
# host event of the same trace without that cost.
_range = torch._C._profiler._RecordFunctionFast
LOG_CAP = 1 << 17           # records the span log keeps; later ones are counted as dropped


class _SpanLog:
    """The spans of the latest profiling session: one record per span,
    ``[name, parent, root, start_ns, end_ns, n, counts]``, parent and root
    as indices into `records`."""

    def __init__(self):
        self.records, self.open, self.dropped = [], [], 0
        # spans ran with no profiler since the last record: the next root
        # span starts a new session's log
        self.stale = False


_LOG = _SpanLog()


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, n, counts: dict):
        self.rec = [name, None, None, 0, 0, n, counts]

    def __enter__(self):
        log = _LOG
        if log.stale and not log.open:
            log.records, log.dropped, log.stale = [], 0, False
        self.rf = _range(self.rec[0])
        self.rf.__enter__()
        rec, records = self.rec, log.records
        if len(records) < LOG_CAP:
            index = len(records)
            parent = log.open[-1] if log.open else None
            rec[1], rec[2] = parent, index if parent is None else records[parent][2]
            records.append(rec)
        else:
            index = None
            log.dropped += 1
        log.open.append(index)
        rec[3] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec[4] = time.time_ns()
        _LOG.open.pop()
        self.rf.__exit__(*exc)
        return False

    def set(self, **counts):
        """Add counts known only inside the span (a tensor is summed when the
        log is read)."""
        self.rec[6].update(counts)


def annotate(name: str, n=None, **counts):
    """The program's span over a stage: ``with annotate("qtos::stage", n):``.

    With a profiler running it is a host range of the trace, beside the
    device's work, and one record in the span log: the
    name, the enclosing span (`parent`) and the outermost one (`root`), start
    and end on ``time.time_ns()``'s clock (the trace's), `n` (the work the
    span covers) and `counts`, to which the entered span's ``set`` adds.  A
    count may be a tensor (a mask or integer counts): it is kept as it is,
    with no device operation, and summed when the log is read.  With no
    profiler running it returns a shared no-op and records nothing.

    The log holds one profiling session's spans: the first root span
    recorded after spans ran with no profiler starts it anew (two sessions
    with no program call between them share one log)."""
    if not _profiler_enabled():
        _LOG.stale = True
        return _NO_SPAN
    return _Span(name, n, counts)


def spans() -> list:
    """The span log of the latest profiling session as plain records (dicts
    with `name`, `parent`, `root`, `start_ns`, `end_ns`, `n` and the counts),
    a record's index its place in the list.  Tensor counts are summed here,
    with one host read per device for the whole log."""
    records = _LOG.records
    held = [(rec[6], k, v) for rec in records for k, v in rec[6].items() if isinstance(v, torch.Tensor)]
    by_device = {}
    for item in held:
        by_device.setdefault(item[2].device, []).append(item)
    for dev, items in by_device.items():
        flat = torch.cat([v.reshape(-1).to(torch.int64) for _, _, v in items])
        lengths = torch.tensor([v.numel() for _, _, v in items], device=dev)
        segment = torch.repeat_interleave(torch.arange(len(items), device=dev), lengths, output_size=flat.numel())
        sums = torch.zeros(len(items), dtype=torch.int64, device=dev).index_add_(0, segment, flat)
        for (counts, k, _), total in zip(items, sums.tolist()):
            counts[k] = total
    return [dict(c, name=name, parent=parent, root=root, start_ns=a, end_ns=b, n=n)
            for name, parent, root, a, b, n, c in records]


def spans_dropped() -> int:
    """Spans of the latest profiling session left out of the log (past
    `LOG_CAP`)."""
    return _LOG.dropped


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
