"""The port's native host runtime (`qtos_torch.runtime`): its build, the
native A* against the Python one and against `qtos_tpu`'s, and the ring
buffer's two implementations against each other and against `qtos_tpu`'s.
Everything here is exact: integers and copied float32 rows."""

import os

import numpy as np
import pytest

from qtos_tpu.runtime import RingBuffer as JRingBuffer
from qtos_tpu.runtime import native_astar as j_native_astar
from qtos_tpu.runtime import native_available as j_native_available

from qtos_torch.planner import astar
from qtos_torch.runtime import RingBuffer, bindings, native_astar, native_available


def _path_length(cells) -> float:
    return float(np.linalg.norm(np.diff(np.asarray(cells, np.float64), axis=0), axis=1).sum())


def _random_map(seed, H=24, W=40, density=0.22):
    rng = np.random.default_rng(seed)
    blocked = rng.random((H, W)) < density
    free = np.argwhere(~blocked)
    start, goal = free[rng.integers(len(free))], free[rng.integers(len(free))]
    return blocked, tuple(int(v) for v in start), tuple(int(v) for v in goal)


def test_native_library_builds_into_the_build_directory():
    assert native_available()
    so = bindings.library_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(bindings.__file__)))
    assert os.path.dirname(so) == os.path.join(pkg, "_build")
    assert os.path.exists(so)
    # nothing is built next to the source, and qtos_tpu's library is not the one loaded
    native_dir = os.path.dirname(bindings.SOURCE)
    assert sorted(os.listdir(native_dir)) == ["qtos_native.cpp"]
    assert "qtos_tpu" not in so


def test_native_source_is_a_byte_copy():
    ref = os.path.join(os.path.dirname(bindings.SOURCE), "..", "..", "..",
                       "qtos_tpu", "runtime", "native", "qtos_native.cpp")
    with open(ref, "rb") as a, open(bindings.SOURCE, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("diagonal", [True, False])
def test_native_astar_matches(seed, diagonal):
    blocked, start, goal = _random_map(seed)
    got = native_astar(blocked, start, goal, diagonal=diagonal)
    py = astar(blocked, start, goal, diagonal=diagonal)
    assert (got is None) == (py is None)
    if j_native_available():
        ref = j_native_astar(blocked, start, goal, diagonal=diagonal)
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(got, ref)          # cell for cell
    if got is not None:
        assert tuple(got[0]) == start and tuple(got[-1]) == goal
        assert not blocked[got[:, 0], got[:, 1]].any()
        # equally short as the Python search (ties may be broken otherwise);
        # the native step cost is 1.41421, so 1e-4 per diagonal step
        assert abs(_path_length(got) - _path_length(py)) < 1e-4 * len(got)


def test_native_astar_rejects_blocked_or_outside_endpoints():
    blocked = np.zeros((6, 6), bool)
    blocked[2, 2] = True
    assert native_astar(blocked, (2, 2), (5, 5)) is None
    assert native_astar(blocked, (0, 0), (2, 2)) is None
    assert native_astar(blocked, (0, 0), (6, 0)) is None
    assert native_astar(blocked, (-1, 0), (5, 5)) is None
    wall = np.zeros((6, 6), bool)
    wall[:, 3] = True
    assert native_astar(wall, (0, 0), (0, 5)) is None


def _segments(seed, n_seg=6, cap=400):
    rng = np.random.default_rng(seed)
    at, out = 0, []
    for _ in range(n_seg):
        n = int(rng.integers(5, 60))
        rows = rng.standard_normal((n, 37)).astype(np.float32)
        contact = (rng.random((n, 4)) < 0.8).astype(np.float32)
        out.append((at, rows, contact))
        # the next segment overwrites the tail of this one, as a stitch does
        at = at + int(rng.integers(1, n))
    return out, cap


@pytest.mark.parametrize("seed", range(4))
def test_ring_buffer_implementations_agree(seed):
    segs, cap = _segments(seed)
    bufs = [RingBuffer(cap, native=True), RingBuffer(cap, native=False), JRingBuffer(cap)]
    assert bufs[0].is_native and not bufs[1].is_native
    rng = np.random.default_rng(100 + seed)
    for at, rows, contact in segs:
        ends = [b.stitch(at, rows, contact) for b in bufs]
        assert ends == [at + len(rows)] * 3
        assert [b.end for b in bufs] == ends
        for _ in range(6):
            start = int(rng.integers(0, ends[0]))
            n = int(rng.integers(1, 80))
            reads = [b.read(start, n) for b in bufs]
            assert reads[0].shape == (min(n, ends[0] - start), 37)
            np.testing.assert_array_equal(reads[0], reads[1])
            np.testing.assert_array_equal(reads[0], reads[2])
            frm = int(rng.integers(0, ends[0]))
            found = [b.find_contact_row(frm) for b in bufs]
            assert found[0] == found[1] == found[2]
    # what is read back is a copy
    r = bufs[1].read(0, 3)
    r[:] = 7.0
    assert not (bufs[1].read(0, 3) == 7.0).all()


@pytest.mark.parametrize("native", [True, False])
def test_ring_buffer_out_of_range(native):
    rb = RingBuffer(50, native=native)
    rows, contact = np.ones((10, 37), np.float32), np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError, match="out of range"):
        rb.stitch(1, rows, contact)                        # a gap after the end
    with pytest.raises(ValueError, match="out of range"):
        rb.stitch(-1, rows, contact)
    rb.stitch(0, rows, contact)
    with pytest.raises(ValueError, match="out of range"):
        rb.stitch(45, rows, contact)                       # past the capacity
    with pytest.raises(ValueError, match="rows"):
        rb.stitch(0, rows[:, :30], contact)
    assert rb.end == 10
    assert rb.read(10, 5).shape == (0, 37)
    assert rb.read(-1, 5).shape == (0, 37)
    assert rb.read(3, 0).shape == (0, 37)
    assert rb.read(8, 100).shape == (2, 37)
    assert rb.find_contact_row(0) == -1                    # no all-contact row
    rb.stitch(10, rows, np.ones((10, 4), np.float32))
    assert rb.find_contact_row(0) == 10
    assert rb.find_contact_row(-5) == 10
    assert rb.find_contact_row(20) == -1
