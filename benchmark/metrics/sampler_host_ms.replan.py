"""The host's time in a replan's 1 kHz sampling (`sample_trajectory`): the
median over the window's `qtos::replan` calls of their `qtos::sample` spans,
in ms."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    m = spans.median([sum(spans.seconds(r) for r in spans.named(call, "qtos::sample"))
                      for call in spans.calls(summary, "qtos::replan")])
    return None if m is None else 1e3 * m
