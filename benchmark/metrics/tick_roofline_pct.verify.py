"""`tick_kernel`'s share of its roofline at the cell's batch of tables: the
least time of one launch over (B, T) (`roofline.tick_work`: rows read and
traces written once) over its device time per launch."""

from benchmark.roofline import bound_s, tick_work
from benchmark.trace import roofline_pct


def read(summary: dict, ctx: dict):
    s = ctx["shapes"]
    return roofline_pct(summary, "tick_kernel", bound_s(*tick_work(s["B"], s["T"])))
