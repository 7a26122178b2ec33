"""The tick kernel's design floor (`qtos_torch/tools/tick_floor.py`): its
counts of the chain's operations are held to `qtos_torch/csrc/tick.cu`, and
the floor is the largest mean of the chain's loop-carried cycles.

The latencies the floor is taken at are measured on the card only
(`chip_smoke.py` phase 6e, `qtos_torch/tools/check_tick.py`).
"""

import os

import pytest

from qtos_torch.tools import tick_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SRC = os.path.join(REPO, "qtos_torch", "csrc", "tick.cu")


@pytest.fixture(scope="module")
def source():
    with open(KERNEL_SRC) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(tick_floor.SOURCE_CALLS))
def test_recorded_calls_are_the_sources(source, name):
    """An edit of tick.cu that adds or removes a counted call in a function
    on the paths fails here until the paths are counted again."""
    assert tick_floor.source_calls(source, name) == tick_floor.SOURCE_CALLS[name]


@pytest.mark.parametrize("path", sorted(tick_floor.PATHS))
def test_paths_take_only_calls_their_functions_hold(path):
    for fn, ops in tick_floor.PATHS[path]:
        held = tick_floor.SOURCE_CALLS[fn]
        for op, n in ops.items():
            if op in tick_floor.CALLS.values():
                assert n <= held.get(op, 0), f"{path}: {n} {op} in {fn}, which holds {held.get(op, 0)}"


def test_cycles_close():
    """Each cycle's paths chain from carried value to carried value and come
    back to the one they left."""
    for name, legs in tick_floor.CYCLES.items():
        ends = [tuple(p.split(" -> ")) for p in legs]
        for (_, b), (a, _) in zip(ends, ends[1:] + ends[:1]):
            assert a == b, name
        assert " -> ".join([e[0] for e in ends] + [ends[0][0]]) == name


def test_floor_is_the_largest_cycle_mean():
    """At one cycle per operation each path costs its count of operations:
    quat -> q 65, q -> quat 72, quat -> quat 75, q -> q 55, so the largest
    mean is the one-tick cycle of the quaternion, 75.  With the divisions
    and cosines at 100 the two-tick cycle through the joints leads."""
    unit = dict.fromkeys(tick_floor.OPS, 1.0)
    assert {p: sum(tick_floor.path_ops(p).values()) for p in tick_floor.PATHS} == {
        "quat -> q": 65, "q -> quat": 72, "quat -> quat": 75, "q -> q": 55}
    ms, per_tick, name = tick_floor.design_floor(unit, 2000, 1000.0)
    assert (per_tick, name) == (75.0, "quat -> quat")
    assert ms == pytest.approx(2000 * 75 / 1e6)
    slow = dict(unit, div=100.0, cos=100.0)
    _, per_tick, name = tick_floor.design_floor(slow, 1, 1.0)
    assert name == "quat -> q -> quat"
    assert per_tick == pytest.approx(((65 - 7) + 7 * 100 + (72 - 6) + 6 * 100) / 2)


def test_function_body_reads_one_function(source):
    assert tick_floor.function_body(source, "norm3").count("sqrtf(") == 1
    with pytest.raises(KeyError):
        tick_floor.function_body(source, "no_such_function")
