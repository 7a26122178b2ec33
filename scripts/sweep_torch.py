#!/usr/bin/env python3
"""Experiment scoreboard of the PyTorch/CUDA port: the counterpart of
`scripts/sweep.py`.

Runs each preset through `scripts/main_torch.py` and renders the outcomes,
beside `qtos_tpu`'s committed ones (`logs/experiment_data_<exp>.out`), into
`docs/PARITY_TORCH.md` (never `docs/PARITY.md`).  The port's evidence file
`logs/torch/experiment_data_<exp>.out` is deleted before each run, so a run
that crashes or times out leaves no earlier run's summary behind as fresh
evidence; each seed's summary is also kept as
`logs/torch/experiment_data_<exp>.run<seed>.out` for the pass-rate column.

    python scripts/sweep_torch.py                        # every preset, then the table
    python scripts/sweep_torch.py exp_2 --timeout=900    # one preset, 900 s at most
    python scripts/sweep_torch.py exp_1 --runs=3         # seeds 0..2
    python scripts/sweep_torch.py --table-only           # re-render from logs/torch/
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = [f"exp_{i}" for i in range(1, 11)]
MARK_BEGIN = "<!-- SCOREBOARD:BEGIN (scripts/sweep_torch.py) -->"
MARK_END = "<!-- SCOREBOARD:END -->"
DEFAULT_TIMEOUT = 1500


def _evidence(root: str, exp: str) -> str:
    return os.path.join(root, "logs", "torch", f"experiment_data_{exp}.out")


def run_experiment(exp: str, seed: int = 0, timeout: float = DEFAULT_TIMEOUT, root: str = REPO) -> dict | None:
    """One seeded run of `scripts/main_torch.py --exp <exp>` from `root`
    (whose `logs/torch/` receives the summary).  Returns the summary, or None
    when the run wrote none (crash or timeout)."""
    print(f"=== {exp} (seed {seed}) ===", flush=True)
    path = _evidence(root, exp)
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, os.path.join(REPO, "scripts", "main_torch.py"), "--exp", exp, "--seed", str(seed)]
    try:
        subprocess.run(cmd, cwd=root, timeout=timeout, check=False)
    except subprocess.TimeoutExpired:
        print(f"!!! {exp} seed {seed}: timed out after {timeout} s", flush=True)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        summary = json.load(f)
    summary["seed"] = seed
    with open(os.path.join(root, "logs", "torch", f"experiment_data_{exp}.run{seed}.out"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _load(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_summaries(root: str = REPO) -> dict:
    """{exp: (port summary or None, qtos_tpu's committed summary or None)}."""
    return {exp: (_load(_evidence(root, exp)), _load(os.path.join(root, "logs", f"experiment_data_{exp}.out")))
            for exp in ORDER}


def _runs(root: str, exp: str) -> list[dict]:
    pattern = os.path.join(root, "logs", "torch", f"experiment_data_{exp}.run*.out")
    return [_load(p) for p in sorted(glob.glob(pattern))]


def _reached(s: dict) -> str:
    return "**yes**" if s["reached_goal"] else "no" + (" (aborted)" if s.get("aborted") else "")


def _statuses(s: dict) -> str:
    stat = "".join(str(v) for v in s["statuses"])
    if len(stat) > 20:
        stat = f"{stat[:20]}… ({sum(1 for v in s['statuses'] if v)} of {len(s['statuses'])} nonzero)"
    return f"`{stat}`"


def render_table(summaries: dict, root: str = REPO) -> str:
    cards = sorted({f"{s.get('device_name')}, power limit {s.get('power_limit')}"
                    for s, _ in summaries.values() if s is not None})
    lines = [
        MARK_BEGIN,
        "",
        "## Experiment scoreboard: qtos_torch beside qtos_tpu",
        "",
        "Generated by `scripts/sweep_torch.py` from `logs/torch/experiment_data_<exp>.out`",
        "(each written by `scripts/main_torch.py --exp <exp>`) and, for the `qtos_tpu`",
        "columns, the committed `logs/experiment_data_<exp>.out`.  Wall seconds are",
        "host-clock time of the port's whole run, on the device below; the reference's",
        "columns compare behaviour only, never time.",
        "",
        f"Port runs on: {'; '.join(cards) if cards else 'no run yet'}.",
        "",
        "| exp | reached | runs | dist to goal [m] | solves | ticks | holds | err/s | wall [s] | BTD launches "
        "| statuses (0=conv) | qtos_tpu: reached | solves | ticks | holds | err/s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for exp in ORDER:
        s, ref = summaries[exp]
        refcols = ("| — | | | | " if ref is None else
                   f"| {_reached(ref)} | {ref['windows']} | {ref['sim_ticks']} | {ref['stance_holds']} "
                   f"| {ref['avg_com_err_per_s']:.1f} ")
        if s is None:
            lines.append(f"| {exp} | — | | | | | | | | | no run {refcols}|")
            continue
        goal, pos = s["goal"], s["final_pos"]
        dist = ((pos[0] - goal[0]) ** 2 + (pos[1] - goal[1]) ** 2) ** 0.5
        runs = _runs(root, exp)
        rate = f"{sum(1 for r in runs if r.get('reached_goal'))}/{len(runs)}" if runs else "—"
        lines.append(
            f"| {exp} | {_reached(s)} | {rate} | {dist:.2f} of {goal[0]:.1f} | {s['windows']} | {s['sim_ticks']} "
            f"| {s['stance_holds']} | {s['avg_com_err_per_s']:.1f} | {s['wall_time_s']:.1f} "
            f"| {s.get('btd_launches', '—')} | {_statuses(s)} "
            f"{refcols}|"
        )
    lines += ["", MARK_END]
    return "\n".join(lines)


def update_parity(table: str, root: str = REPO) -> str:
    path = os.path.join(root, "docs", "PARITY_TORCH.md")
    if os.path.exists(path):
        with open(path) as f:
            text = f.read()
    else:
        text = "# Experiment parity: qtos_torch (PyTorch/CUDA) beside qtos_tpu\n"
    if MARK_BEGIN in text:
        head, rest = text.split(MARK_BEGIN, 1)
        _, tail = rest.split(MARK_END, 1)
        text = head + table + tail
    else:
        text = text.rstrip() + "\n\n" + table + "\n"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    print(f"scoreboard written to {path}")
    return path


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    opts = dict(a[2:].split("=", 1) for a in args if a.startswith("--") and "=" in a)
    table_only = "--table-only" in args
    n_runs = int(opts.get("runs", 1))
    timeout = float(opts.get("timeout", DEFAULT_TIMEOUT))
    exps = [a for a in args if not a.startswith("--")]
    if not table_only:
        os.makedirs(os.path.join(REPO, "logs", "torch"), exist_ok=True)
        for exp in exps or ORDER:
            first = None
            for seed in range(n_runs):
                s = run_experiment(exp, seed=seed, timeout=timeout)
                if seed == 0:
                    first = s
            # the canonical evidence is the seed-0 run, so the table's detail
            # columns and its pass-rate column describe the same runs
            if first is not None:
                with open(_evidence(REPO, exp), "w") as f:
                    json.dump(first, f, indent=2)
    update_parity(render_table(load_summaries()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
