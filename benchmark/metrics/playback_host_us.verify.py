"""The host's time in a `playback` call (packing, checks, the tick kernel's
launch, the tracking metric), without the caller's read: the median
duration of the window's `qtos::playback` spans, in us."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    m = spans.median([spans.seconds(call[0]) for call in spans.calls(summary, "qtos::playback")])
    return None if m is None else 1e6 * m
