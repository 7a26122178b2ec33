"""The CUDA source of the tick kernel, run on the CPU.

`qtos_torch/csrc/tick.cu` is compiled with the host C++ compiler against the
CUDA stand-in in `qtos_torch/csrc/emu/` (`-ffp-contract=off`, as nvcc's
`--fmad=false` on the card) and driven through `qtos_torch.ops.tick.run`, the
wrapper's own packing of the state, the constants and the traces.  It is held
against the plain version, `qtos_torch.control.loop._scan_ticks` and
`_hold_ticks`, on the same inputs, and once against `qtos_tpu.control.playback`
itself.  The tables are the K=13 windows of 1.5 s on flat ground of
`tests/test_torch_playback.py`'s fixture (goals 0.15-0.45 m, three LM
iterations), solved and sampled by the port on the CPU, which is quicker than
compiling `qtos_tpu`'s batched solve; one is the window over exp_2's first
riser of `tests/test_torch_steps.py`.

Tolerances, those of `tests/test_torch_playback.py`: after one tick every
state leaf and trace entry within 1e-5, except `tau` (1e-3) and `qd` (1e-4):
the desired joint velocity is a difference of two IK results over dt = 1e-3,
so a one-ulp difference of a sine or an arctangent (the host's libm here,
PyTorch's vectorised ones in the plain version) becomes 1e-4 rad/s.  After 300
ticks, traces and final state within 2e-3.

The kernel's speed and its build by nvcc are checked on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.control import ControlParams as JControlParams
from qtos_tpu.control import playback as j_playback
from qtos_tpu.sim import SimState as JSimState
from qtos_tpu.terrain import make_terrain as j_make_terrain

from helpers import emu
from qtos_torch.control import ControlParams
from qtos_torch.control.loop import _hold_ticks, _metrics, _scan_ticks, gait_control_params, state_from_row
from qtos_torch.convert import control_params_from_reference, terrain_from_reference
from qtos_torch.ops import tick
from qtos_torch.sim import SimState
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
from qtos_torch.tools import riser, tick_floor

ATOL = 1e-5
ATOL_TAU = 1e-3
ATOL_QD = 1e-4
ATOL_SHORT = 2e-3
B, K, ROWS = 3, 13, 300
STATE_FIELDS = ("pos", "quat", "v", "w", "q", "qd", "anchor")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMU_DIR = os.path.join(REPO, "qtos_torch", "csrc", "emu")
KERNEL_SRC = os.path.join(REPO, "qtos_torch", "csrc", "tick.cu")
# The line of tick.cu that freezes the carry at t >= n_valid, and the
# expression of its table pass that freezes q_prev there.
FREEZE = re.compile(r"if \(t < nv\) \{")
PLAN_FREEZE = re.compile(r"min\(t, n_valid\[b0 \+ i / T\]\)")


def _build(src_dir, out):
    """Builds `src_dir`/emu/tick_emu.cpp (which includes ../tick.cu) into `out`."""
    return tick.load_library(emu.build(tick.KERNEL, os.path.join(src_dir, "emu", "tick_emu.cpp"), out))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(os.path.dirname(EMU_DIR), tmp_path_factory.mktemp("tick_emu") / "libtick_emu.so")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    """Three K=13 tables (first ROWS rows), their start states after 100
    ticks of the plain stance hold, and the terrains of both packages."""
    jterr = j_make_terrain(["plane", "plane"])
    terr = terrain_from_reference(_np_tree(jterr), device="cpu")
    goals = np.linspace(0.15, 0.45, B).astype(np.float32)
    specs = default_spec(terr, goal_xy=(goals, 0.0), K=K, duration=1.5, device="cpu")
    res = solve_batch(specs, terr, SolverConfig(max_iters=3))
    tables = sample_trajectory(res.x, specs)[0][:, :ROWS].contiguous()
    params = ControlParams()
    s0 = _hold_ticks(state_from_row(tables[:, 0], terr, params), terr, params, 100)
    return dict(jterr=jterr, terr=terr, tables=tables, s0=s0)


def _drifted(s0: SimState) -> SimState:
    """The start states moved off the plan, so that every correction term of
    the controller is live from the first tick."""
    rng = np.random.default_rng(7)
    u = lambda scale, shape: torch.from_numpy((scale * rng.uniform(-1, 1, size=shape)).astype(np.float32))  # noqa: E731
    return SimState(pos=s0.pos + u(0.02, (B, 3)), quat=s0.quat, v=s0.v + u(0.1, (B, 3)),
                    w=s0.w + u(0.2, (B, 3)), q=s0.q, qd=s0.qd + u(0.5, (B, 12)), anchor=s0.anchor)


def _assert_state(a: SimState, b: SimState, atol, qd_atol=None):
    for k in STATE_FIELDS:
        tol = qd_atol if (qd_atol is not None and k == "qd") else atol
        np.testing.assert_allclose(getattr(a, k).numpy(), getattr(b, k).numpy(), atol=tol, rtol=0,
                                   err_msg=f"state.{k}")


def _assert_traces(a: dict, b: dict, atol, tau_atol=None, qd_atol=None):
    assert list(a) == list(b)
    for k in b:
        tol = {"tau": tau_atol, "qd": qd_atol}.get(k) or atol
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("use_force_ff", [False, True], ids=["noff", "ff"])
@pytest.mark.parametrize("frame", ["live", "hybrid", "plan"])
def test_emulated_kernel_matches_plain(lib, world, frame, use_force_ff):
    """One tick and 300 ticks from drifted, moving states, each controller
    frame with and without the force feedforward."""
    params = ControlParams(frame=frame, use_force_ff=use_force_ff, vel_corr=0.15, yaw_corr=0.3,
                           ee_shift=0.005)
    s0, terr = _drifted(world["s0"]), world["terr"]
    for T in (1, ROWS):
        table = world["tables"][:, :T].contiguous()
        final, traces = tick.run(lib, s0, terr, params, table=table)
        final_p, traces_p = _scan_ticks(table, s0, terr, params)
        if T == 1:
            _assert_state(final, final_p, ATOL, qd_atol=ATOL_QD)
            _assert_traces(traces, traces_p, ATOL, tau_atol=ATOL_TAU, qd_atol=ATOL_QD)
        else:
            _assert_state(final, final_p, ATOL_SHORT)
            _assert_traces(traces, traces_p, ATOL_SHORT)


def test_emulated_kernel_n_valid_per_episode(lib, world):
    """n_valid = [300, 120, 0]: the carry freezes at each episode's count, the
    trace rows past it are still written (from the frozen carry), and an
    episode that runs no tick ends in its start state bit for bit."""
    n_valid = torch.tensor([ROWS, 120, 0])
    params = ControlParams()
    final, traces = tick.run(lib, world["s0"], world["terr"], params, table=world["tables"], n_valid=n_valid)
    final_p, traces_p = _scan_ticks(world["tables"], world["s0"], world["terr"], params, n_valid)
    _assert_state(final, final_p, ATOL_SHORT)
    _assert_traces(traces, traces_p, ATOL_SHORT)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(final, k)[2].numpy(), getattr(world["s0"], k)[2].numpy(), err_msg=k)
    # episode 1 after tick 120 is its state at 120; its later rows repeat one tick from it
    short, _ = tick.run(lib, world["s0"], world["terr"], params, table=world["tables"][:, :120].contiguous())
    np.testing.assert_array_equal(final.q[1].numpy(), short.q[1].numpy())
    np.testing.assert_array_equal(traces["pos"][1, 150].numpy(), traces["pos"][1, 299].numpy())
    m, m_p = _metrics(traces, n_valid), _metrics(traces_p, n_valid)
    np.testing.assert_allclose(m.avg_com_err_per_s.numpy(), m_p.avg_com_err_per_s.numpy(), rtol=1e-3)


def test_emulated_kernel_hold(lib, world):
    """The stance hold: 100 steps of PD to the start joints, no controller."""
    params = ControlParams()
    s = state_from_row(world["tables"][:, 0], world["terr"], params)
    final, traces = tick.run(lib, s, world["terr"], params, hold_steps=100)
    assert traces is None
    _assert_state(final, _hold_ticks(s, world["terr"], params, 100), ATOL_SHORT)
    same, _ = tick.run(lib, s, world["terr"], params, hold_steps=0)
    _assert_state(same, s, 0.0)


def test_emulated_kernel_matches_the_reference(lib, world):
    """Three ways: the kernel's source, the plain version and
    `qtos_tpu.control.playback` on one table from one start state."""
    s0 = SimState(**{k: getattr(world["s0"], k)[1].contiguous() for k in STATE_FIELDS})
    js0 = JSimState(**{k: jnp.asarray(getattr(s0, k).numpy()) for k in STATE_FIELDS})
    jfinal, jm = j_playback(jnp.asarray(world["tables"][1].numpy()), js0, world["jterr"], JControlParams())
    final, traces = tick.run(lib, s0, world["terr"], ControlParams(), table=world["tables"][1].contiguous())
    m = _metrics(traces, ROWS)
    for name in ("pos", "feet", "com_err", "ee_err", "yaw"):
        np.testing.assert_allclose(getattr(m, name).numpy(), np.asarray(getattr(jm, name)), atol=ATOL_SHORT,
                                   rtol=0, err_msg=name)
    for k in ("pos", "q", "anchor"):
        np.testing.assert_allclose(getattr(final, k).numpy(), np.asarray(getattr(jfinal, k)), atol=ATOL_SHORT,
                                   rtol=0, err_msg=k)


def test_emulated_kernel_over_the_first_riser(lib):
    """exp_2's window over step_2's riser (`qtos_torch.tools.riser`, the
    window of tests/test_torch_steps.py): 300 rows from 100 before the first
    planned foot crossing, from the plain version's state there."""
    terr, table, status, s0 = riser.riser_window("cpu")
    assert status == 0
    feet_x = table[:, 7:19].reshape(-1, 4, 3)[..., 0]
    t0 = max(int(torch.nonzero((feet_x > riser.RISER_X).any(dim=1))[0]) - 100, 0)
    params = gait_control_params("trot")
    state, _ = _scan_ticks(table[:t0], s0, terr, params)
    rows = table[t0:t0 + ROWS].contiguous()
    assert bool((rows[-1, 7:19].reshape(4, 3)[:, 0] > riser.RISER_X).any())
    final, traces = tick.run(lib, state, terr, params, table=rows)
    final_p, traces_p = _scan_ticks(rows, state, terr, params)
    _assert_state(final, final_p, ATOL_SHORT)
    _assert_traces(traces, traces_p, ATOL_SHORT)


def test_emulated_kernel_needs_its_n_valid_freeze(world, tmp_path):
    """A copy of tick.cu whose freeze commits every tick must fail the
    n_valid case: the stand-in does not hide the freeze."""
    mutant = _mutant(tmp_path, FREEZE, "if (true) {")
    n_valid = torch.tensor([ROWS, 120, 0])
    final, _ = tick.run(mutant, world["s0"], world["terr"], ControlParams(), table=world["tables"], n_valid=n_valid)
    final_p, _ = _scan_ticks(world["tables"], world["s0"], world["terr"], ControlParams(), n_valid)
    assert not np.allclose(final.pos.numpy(), final_p.pos.numpy(), atol=ATOL_SHORT, rtol=0)


def _mutant(tmp_path, pattern, text):
    """tick.cu with its one match of `pattern` replaced by `text`, built."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    assert len(pattern.findall(src)) == 1, f"tick.cu has {pattern.pattern} in one place"
    (tmp_path / "emu").mkdir()
    (tmp_path / "tick.cu").write_text(pattern.sub(text, src))
    shutil.copy(os.path.join(EMU_DIR, "tick_emu.cpp"), tmp_path / "emu" / "tick_emu.cpp")
    return _build(str(tmp_path), tmp_path / "libtick_mutant.so")


def test_emulated_kernel_needs_its_plan_freeze(world, tmp_path):
    """A copy of tick.cu whose table pass takes q_prev from the tick before
    t also past n_valid must fail the n_valid case: the desired joint
    velocities of the ticks past it, and so their torques, change."""
    mutant = _mutant(tmp_path, PLAN_FREEZE, "t")
    n_valid = torch.tensor([ROWS, 120, 0])
    _, traces = tick.run(mutant, world["s0"], world["terr"], ControlParams(), table=world["tables"], n_valid=n_valid)
    _, traces_p = _scan_ticks(world["tables"], world["s0"], world["terr"], ControlParams(), n_valid)
    assert not np.allclose(traces["tau"].numpy(), traces_p["tau"].numpy(), atol=ATOL_SHORT, rtol=0)


@pytest.mark.parametrize("n", [5, 9])
def test_emulated_kernel_ragged_batch(lib, world, n):
    """B = 5 and 9, not multiples of the 8 episodes of a block (9 fills one
    block and starts another): the masked lanes finish (no barrier or
    shuffle waits for them) and the playback, with per-episode n_valid, and
    the hold match the plain loops."""
    idx = torch.arange(n) % B
    rng = np.random.default_rng(n)
    u = lambda scale, shape: torch.from_numpy((scale * rng.uniform(-1, 1, size=shape)).astype(np.float32))  # noqa: E731
    s0 = SimState(**{k: getattr(world["s0"], k)[idx].contiguous() for k in STATE_FIELDS})
    s0 = SimState(pos=s0.pos + u(0.01, (n, 3)), quat=s0.quat, v=s0.v + u(0.05, (n, 3)), w=s0.w, q=s0.q,
                  qd=s0.qd + u(0.2, (n, 12)), anchor=s0.anchor)
    tables = world["tables"][idx, :100].contiguous()
    n_valid = torch.tensor([max(100 - 13 * i, 0) for i in range(n)])
    params = ControlParams()
    final, traces = tick.run(lib, s0, world["terr"], params, table=tables, n_valid=n_valid)
    final_p, traces_p = _scan_ticks(tables, s0, world["terr"], params, n_valid)
    _assert_state(final, final_p, ATOL_SHORT)
    _assert_traces(traces, traces_p, ATOL_SHORT)
    held, _ = tick.run(lib, s0, world["terr"], params, hold_steps=30)
    _assert_state(held, _hold_ticks(s0, world["terr"], params, 30), ATOL_SHORT)


def test_op_probe_runs_every_operation(tmp_path):
    """The latency probe behind the design's floor
    (`qtos_torch/tools/op_cycles.cu`, its own library) launches each
    operation and leaves a count and a finite value (times only mean
    something on the card)."""
    src = tmp_path / "op_cycles_emu.cpp"
    src.write_text('#define EMU_TYPED_LAUNCH_ONLY\n#include "cuda_runtime.h"\nfloat* emu_smem_base = nullptr;\n'
                   f'#include "{tick_floor.PROBE_SOURCE}"\n')
    probe = tick_floor.load_probe(emu.build(tick_floor.PROBE, src, tmp_path / "libop_cycles_emu.so"))
    buf = torch.zeros(64)
    for op in range(len(tick_floor.OPS)):
        assert probe.op_cycles(op, 16, buf.data_ptr(), None) == 0
        assert float(buf[0]) > 0 and np.isfinite(float(buf[1]))
    assert probe.op_cycles(len(tick_floor.OPS), 16, buf.data_ptr(), None) != 0


def test_param_layout_is_the_libraries(lib):
    """Every constant the kernel names comes from Python, once."""
    vals = tick.param_values(control_params_from_reference(JControlParams()),
                             terrain_from_reference(_np_tree(j_make_terrain(["plane"])), device="cpu"))
    names = [item.split(":")[0] for item in lib.tick_param_layout().decode().strip(",").split(",")]
    assert sorted(names) == sorted(vals) and len(set(names)) == len(names)
    assert tick.param_array(lib, ControlParams(), terrain_from_reference(
        _np_tree(j_make_terrain(["plane"])), device="cpu")).dtype == np.float32


def test_run_rejects_bad_tables(lib, world):
    s0, terr = world["s0"], world["terr"]
    with pytest.raises(ValueError, match="contiguous table"):
        tick.run(lib, s0, terr, ControlParams(), table=world["tables"][:, ::2])
    with pytest.raises(ValueError, match="T, 37"):
        tick.run(lib, s0, terr, ControlParams(), table=world["tables"][..., :36].contiguous())
    with pytest.raises(TypeError, match="float32"):
        tick.run(lib, s0, terr, ControlParams(), table=world["tables"].double())
    with pytest.raises(ValueError, match="state.pos"):
        tick.run(lib, s0, terr, ControlParams(), table=world["tables"][:2].contiguous())
