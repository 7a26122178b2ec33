"""`assemble_kernel`'s share of its roofline at the cell's batch: the least
time of one assembly at (B, K) (`roofline.assemble_work`) over its device
time per launch.  Nothing is read where a rescue pass assembled a smaller
batch in the window: its launches would mix two sizes."""

from benchmark.roofline import assemble_work, bound_s
from benchmark.trace import roofline_pct


def read(summary: dict, ctx: dict):
    s, c = ctx["shapes"], ctx["counters"]
    if c["assemble"] != c["calls"] * s["iters"]:
        return None
    return roofline_pct(summary, "assemble_kernel", bound_s(*assemble_work(s["B"], s["K"], s["grid_cells"])))
