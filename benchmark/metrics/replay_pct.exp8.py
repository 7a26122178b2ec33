"""The share of the window's replans that replayed a graph captured before
them: 100 x (replays - captures) / replans, from the counters of
`plan_windows_batch` that the driver reports for the window.  None where
the program counts no replays (on the CPU no call captures, and the share
reads 0 there)."""


def read(summary: dict, ctx: dict):
    c = ctx["counters"]
    if "replays" not in c or not c.get("calls"):
        return None
    return 100.0 * (c["replays"] - c["captures"]) / c["calls"]
