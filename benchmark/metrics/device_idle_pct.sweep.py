"""The device's idle share over the traced window: 1 - (the union of the
device's busy intervals) / (the window)."""

from benchmark.trace import idle_pct


def read(summary: dict, ctx: dict):
    return idle_pct(summary)
