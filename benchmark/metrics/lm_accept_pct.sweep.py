"""The share of evaluated LM steps that were accepted in pass 1 of the
window's `solve_batch` calls: 100 x accepted / evaluated windows over each
pass-1 `qtos::lm.iter` span but the first (whose point is the initial guess,
always accepted)."""

from benchmark import spans


def read(summary: dict, ctx: dict):
    accepted = evaluated = 0
    for call in spans.calls(summary, "qtos::solve_batch"):
        for pass1 in spans.children(call, call[0], "qtos::solve.pass")[:1]:
            for it in spans.children(call, pass1, "qtos::lm.iter")[1:]:
                accepted += it["accepted"]
                evaluated += it["n"]
    return 100.0 * accepted / evaluated if evaluated else None
