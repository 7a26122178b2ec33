"""The host's time before a replan's LM iterations: the median over the
window's `qtos::replan` calls of their `qtos::replan.start` (drift and yaw
shift, terrain re-seat, spec) plus `qtos::solve.presolve` spans, in ms."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    m = spans.median([sum(spans.seconds(r) for r in call if r["name"] in ("qtos::replan.start", "qtos::solve.presolve"))
                      for call in spans.calls(summary, "qtos::replan")])
    return None if m is None else 1e3 * m
