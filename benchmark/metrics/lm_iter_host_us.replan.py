"""The host's time per LM iteration of a replan: the median duration of the
`qtos::lm.iter` spans under the window's `qtos::replan` calls, in us."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    its = [r for call in spans.calls(summary, "qtos::replan") for r in spans.named(call, "qtos::lm.iter")]
    m = spans.median([spans.seconds(r) for r in its])
    return None if m is None else 1e6 * m
