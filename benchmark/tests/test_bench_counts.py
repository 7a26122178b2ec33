"""The frozen yardstick: the kernels' bytes and operations at the shapes the
port's own records give, and the readers' arithmetic on a made-up trace."""

from __future__ import annotations

import pytest

from benchmark import harness, roofline, trace


def test_btd_work_at_the_sweep():
    nbytes, flops = roofline.btd_work(8192, 41, 36)
    assert nbytes / 1e9 == pytest.approx(3.537, abs=5e-4)
    assert flops / 1e9 == pytest.approx(40.09, abs=5e-3)
    assert 1e3 * roofline.bound_s(nbytes, flops) == pytest.approx(1.056, abs=5e-4)


def test_assemble_bound_at_the_sweep():
    grid = 3 * harness.TILE_CELLS * harness.TILE_CELLS          # plane x3
    assert 1e3 * roofline.bound_s(*roofline.assemble_work(8192, 41, grid)) == pytest.approx(1.067, abs=5e-4)


def test_tick_bound_at_the_playback():
    nbytes, flops = roofline.tick_work(256, 2501)
    assert 1e3 * nbytes / roofline.PEAK_BYTES_PER_S == pytest.approx(0.0711, abs=5e-5)
    assert roofline.bound_s(nbytes, flops) == nbytes / roofline.PEAK_BYTES_PER_S


def _summary():
    # 10 ms window; btd 2 launches of 3 ms, assembly 1 of 1 ms, a copy 2 ms
    return dict(window_s=0.010, busy_s=0.008, kernels={
        "btd_kernel(float const*, float const*)": dict(launches=2, seconds=0.006),
        "assemble_kernel(AsmParams, AsmTensors, int, int, int)": dict(launches=1, seconds=0.001),
        "void at::native::elementwise_kernel<128, 2>(int)": dict(launches=4, seconds=0.002),
    })


def test_readers_on_a_made_up_trace():
    s = _summary()
    ctx = dict(shapes=dict(B=8192, K=41, iters=1, grid_cells=1200), counters=dict(assemble=1, calls=1))
    read = {n: harness.load_module("metrics", n).read for n in (
        "device_idle_pct.sweep", "lm_other_pct.sweep", "btd_roofline_pct.sweep", "btd_roofline_pct.replan",
        "assemble_roofline_pct.sweep")}
    assert read["device_idle_pct.sweep"](s, ctx) == pytest.approx(20.0)
    assert read["lm_other_pct.sweep"](s, ctx) == pytest.approx(100 * 0.002 / 0.009)
    assert read["btd_roofline_pct.sweep"](s, ctx) == pytest.approx(100 * 1.0557e-3 / 3e-3, rel=1e-3)
    assert read["btd_roofline_pct.replan"](s, ctx) is None          # its kernel never ran
    assert read["assemble_roofline_pct.sweep"](s, ctx) == pytest.approx(100 * 1.0672e-3 / 1e-3, rel=1e-3)
    ctx["counters"]["assemble"] = 2                                 # a rescue pass: two sizes
    assert read["assemble_roofline_pct.sweep"](s, ctx) is None


def test_union_and_kernel_names():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    s = _summary()
    assert trace.kernel_time(s, "btd_kernel") == (2, 0.006)
    assert trace.kernel_time(s, "btd_small_kernel") == (0, 0.0)
