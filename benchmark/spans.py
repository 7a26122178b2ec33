"""The program's own span log of the traced window
(`qtos_torch.utils.profiling.spans`), grouped by the entry call each span
belongs to.

Like `program.py` and the drivers it imports the program, here only
`qtos_torch.utils.profiling.spans`.  A program that records no spans gives
an empty log, and every reader of it None.
"""

from __future__ import annotations

import statistics


def log() -> list:
    """The records of the latest profiling session, each with its `index`
    in the log; empty where the program keeps no span log."""
    try:
        from qtos_torch.utils.profiling import spans
    except ImportError:
        return []
    return [dict(r, index=i) for i, r in enumerate(spans())]


def calls(summary: dict, root: str) -> list:
    """The spans of each call of the entry span named `root`: one list per
    call, the root's record first, the rest in the order they started.  None
    (an empty list) where the trace `summary` holds no device operation: off
    the card the spans time the CPU's run, and no number of such a run is
    reported under a metric of the device trace."""
    if not summary["kernels"]:
        return []
    records = log()
    by_root = {}
    for r in records:
        by_root.setdefault(r["root"], []).append(r)
    return [group for i, group in sorted(by_root.items()) if records[i]["name"] == root]


def named(call: list, name: str) -> list:
    return [r for r in call if r["name"] == name]


def children(call: list, parent: dict, name: str) -> list:
    return [r for r in call if r["parent"] == parent["index"] and r["name"] == name]


def seconds(r: dict) -> float:
    return (r["end_ns"] - r["start_ns"]) * 1e-9


def median(values: list):
    """The median, or None where there is nothing to read."""
    return statistics.median(values) if values else None
