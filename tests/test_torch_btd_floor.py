"""The small BTD kernel's design floor (`qtos_torch/tools/btd_floor.py`): its
counts of the chain's operations are held to `qtos_torch/csrc/btd.cu`, and
the floor is their sum over the knots at the probed latencies.  The
long-horizon kernel's floor is its stages' chains summed over its levels.

The latencies are measured on the card only (`chip_smoke.py` phase 3).
"""

import os

import pytest

from qtos_torch.tools import btd_floor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SRC = os.path.join(REPO, "qtos_torch", "csrc", "btd.cu")
UNIT = dict.fromkeys(("fadd", "fmul", "rsqrt", "shfl", "lds", "bar"), 1.0)


@pytest.fixture(scope="module")
def source():
    with open(KERNEL_SRC) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(btd_floor.SOURCE_CALLS))
def test_recorded_calls_are_the_sources(source, name):
    """An edit of btd.cu that adds or removes a counted call in a function on
    the chain fails here until the chain is counted again."""
    assert btd_floor.source_calls(source, name) == btd_floor.SOURCE_CALLS[name]


def test_chain_at_the_path_width():
    """At n = 36 (T = 9 column blocks): the Cholesky's sums 144 FMAs deep,
    36 reciprocal square roots, a shuffle per block; the vector solves 18
    blocks of a shuffle each."""
    ops = btd_floor.stage_ops(36)
    assert ops["cholesky"] == dict(fma=144 + 27, rsqrt=36, simple=36, shfl=9, lds=18)
    assert ops["vector solves"] == dict(fma=126, simple=72, shfl=18)
    assert ops["row solves, last block"]["fma"] == 35 and ops["rank update"]["fma"] == 36


@pytest.mark.parametrize("K,n", [(41, 36), (1, 36), (9, 5), (17, 64)])
def test_floor_is_the_chain_summed_over_the_knots(K, n):
    """At one cycle per operation the floor is the count of the chain's
    operations; the stages between two factorisations run K - 1 times."""
    ms, cycles, stages = btd_floor.design_floor(UNIT, K, n, 1000.0)
    assert cycles == sum(btd_floor.chain_ops(K, n).values()) == sum(stages.values())
    assert ms == pytest.approx(cycles / 1e6)
    if K == 1:
        assert stages["rank update"] == stages["L^T x"] == 0
    slow = dict(UNIT, rsqrt=10.0)
    assert btd_floor.design_floor(slow, K, n, 1000.0)[1] == cycles + 9 * btd_floor.chain_ops(K, n)["rsqrt"]


def test_function_body_reads_one_function(source):
    assert "__shfl_sync" in btd_floor.function_body(source, "chol_inplace")
    assert "rsqrtf" not in btd_floor.function_body(source, "forward_row_block")
    with pytest.raises(KeyError):
        btd_floor.function_body(source, "no_such_function")


def test_reduce_chain_at_the_path_width():
    """At n = 36: the Cholesky and the row solves' last block behind it are
    the small kernel's, a back level's triangular solve is 36 shuffles,
    products and FMAs."""
    ops = btd_floor.reduce_stage_ops(36)
    assert ops["cholesky"] == btd_floor.stage_ops(36)["cholesky"]
    assert ops["row solves"] == dict(fma=35, simple=4, lds=1, bar=2)
    assert ops["C^T solve"] == dict(fma=36, simple=36, shfl=36)
    assert ops["updates"]["fma"] == 72


@pytest.mark.parametrize("K,levels", [(1, 0), (2, 1), (3, 2), (13, 4), (129, 8), (154, 8), (256, 8), (257, 9)])
def test_reduce_floor_is_its_stages_over_the_levels(K, levels):
    """ceil(log2 K) levels: every phase factors and solves its rows, the
    phases past the first update, and each back level and the last phase
    solve C^T u = r; at one cycle per operation the floor is that count."""
    assert btd_floor.levels(K) == levels
    ms, cycles, stages = btd_floor.reduce_floor(UNIT, K, 36, 1000.0)
    per = {stage: sum(ops.values()) for stage, ops in btd_floor.reduce_stage_ops(36).items()}
    assert stages == {"updates": levels * per["updates"], "cholesky": (levels + 1) * per["cholesky"],
                      "row solves": (levels + 1) * per["row solves"], "W x + V x": levels * per["W x + V x"],
                      "C^T solve": (levels + 1) * per["C^T solve"]}
    assert cycles == sum(stages.values()) and ms == pytest.approx(cycles / 1e6)
