"""The host's time in a replan's final selection (`violations` of the best
and the last point, the choice between them): the median over the window's
`qtos::replan` calls of their `qtos::solve.select` spans, in ms."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    m = spans.median([sum(spans.seconds(r) for r in spans.named(call, "qtos::solve.select"))
                      for call in spans.calls(summary, "qtos::replan")])
    return None if m is None else 1e3 * m
