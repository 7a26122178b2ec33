"""The host's time in pass 1's set-up of a `solve_batch` call (initial
guess, knot data, slope grid, the system's buffers): the median over the
window's calls of their first `qtos::solve.presolve` span, in ms."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    firsts = [spans.named(call, "qtos::solve.presolve")[:1] for call in spans.calls(summary, "qtos::solve_batch")]
    m = spans.median([spans.seconds(f[0]) for f in firsts if f])
    return None if m is None else 1e3 * m
