"""The control of `correct` on the card: the plain reference computed in TF32
and put in the program's place must fail the cell's limits (or crash, as
the solver does), while the program's own run passes them.  At a size a test
run holds: one short window per cell, smaller batches.  Run on the card:

    python -m pytest benchmark/tests/test_bench_control.py -o addopts="" -q
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control compares TF32 with float32 products on it")
    import qtos_torch  # noqa: F401  (TF32 off, as the program runs)

    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["sweep.b8192", "replan.exp1", "verify.b256"])
def test_control_fails_and_program_passes(card, name):
    cell = harness.load_cell(name)
    if cell["driver"] != "plan_windows_batch":
        cell["mix"] = dict(cell["mix"], batch=1024 if cell["driver"] == "solve_batch" else 64, pool=1)
    drv = harness.load_module("drivers", cell["driver"]).Driver(cell, 2**31 + 99, card)
    start, n = time.perf_counter(), 0
    while time.perf_counter() - start < 1.0:
        drv.step(n)
        n += 1
    drv.release()
    assert all(c["value"] <= c["limit"] for c in drv.check())
    try:
        failed = any(c["value"] > c["limit"] for c in drv.control())
    except FloatingPointError:          # TF32 breaks the solver: a control that crashes has failed
        failed = True
    assert failed
