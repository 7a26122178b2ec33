"""Nothing the benchmark runs loads JAX or the JAX package `qtos_tpu`
(compared by whole top-level module names: the port's name begins with the
JAX package's), and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

SOURCES = sorted(glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"), recursive=True))


def imported(path: str) -> set:
    """Top-level names of the absolute imports in a source file."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        assert not imported(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in SOURCES if os.sep + "reference" + os.sep in p]
    assert len(ref) >= 10
    for path in ref:
        assert imported(path) <= {"__future__", "contextlib", "dataclasses", "functools", "math", "types",
                                  "torch"}, path


def test_a_run_loads_no_jax():
    """Every module a run loads, the program's entries included."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, trace, roofline, control\n"
        "idx = harness.index()\n"
        "for w in idx['workloads']: harness.load_module('drivers', harness.load_cell(w['name'])['driver'])\n"
        "for m in idx['per_layer']: harness.load_module('metrics', m['name'])\n"
        "import qtos_torch.solver, qtos_torch.control.replan, qtos_torch.control.loop\n"
        "print(','.join(harness.forbidden_loaded()))\n" % harness.ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
