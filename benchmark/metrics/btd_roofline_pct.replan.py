"""`btd_small_kernel`'s share of its roofline at the replan's batch of
candidates: the least time of one solve at (B, K, 36) (`roofline.btd_work`)
over its device time per launch."""

from benchmark.roofline import bound_s, btd_work
from benchmark.trace import roofline_pct


def read(summary: dict, ctx: dict):
    s = ctx["shapes"]
    return roofline_pct(summary, "btd_small_kernel", bound_s(*btd_work(s["B"], s["K"])))
