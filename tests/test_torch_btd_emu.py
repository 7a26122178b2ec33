"""The CUDA source of the BTD kernel, run on the CPU.

`qtos_torch/csrc/btd.cu` is compiled with the host C++ compiler against the
CUDA stand-in in `qtos_torch/csrc/emu/` (one thread per CUDA thread, warp
barriers for __syncwarp and shuffles, cp.async copies that leave NaN in
their destination until they are waited for), run on small systems, and
held against the plain version `qtos_torch.ops.tridiag.block_tridiag_solve`
on the same inputs.  This checks the kernel's index maps, lane ownership,
copy alignment, and that each copy is waited for before its destination is
read or written again: a copy without each of the kernel's `cp_wait` calls
must fail.  A missing __syncwarp between two lanes' plain shared-memory
accesses may still pass here, since the CPU's threads order memory more
strictly than a warp; that, the kernel's speed and its build by nvcc are
checked on the card (tests/test_torch_gpu.py, chip_smoke.py).

Each solve runs in a subprocess, so that a fault in the kernel (a hang at a
warp barrier, a misaligned copy) fails one test instead of the test worker.
The stand-in reports 2 SMs with 1 block of 4 warps each, so a batch of more
than 8 scenarios walks the grid more than once.

The small-batch kernel of the same source (one scenario per block of 8
warps) is held to `btd_kernel` bit for bit at every shape it takes, with
the block's threads at once and one at a time in either order
(`QTOS_EMU_THREAD_ORDER`), and a copy without each of its block barriers
and copy waits must fail.  The rule that picks between the two kernels is
checked at the edge of the shared memory the small kernel's factors need.

Both kernels take the LM damping `lm` (B,) and add it to each diagonal block
as it lands in shared memory.  At every shape above, each damped kernel is
held to the plain solve of the damped copy `D + diag_embed(lm * diag(D) +
1e-8)` within ATOL and, bit for bit, to its own undamped launch on that copy
(PyTorch rounds the copy's operations one by one, as the kernels do), and the
two damped kernels to each other; a copy of the source that damps a block
before its copy is waited for must fail.

Tolerance atol=5e-4 as tests/test_pallas_btd.py: float32 block Thomas on
diagonally dominant systems with O(1) solutions.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import emu
from qtos_torch.ops import btd
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve

ATOL = 5e-4
EMU_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "qtos_torch", "csrc", "emu")

# Loads the library, solves the system saved in the directory with each
# entry named after the mode (btd_solve_f32 when none), saves each x.  Where
# the directory holds lm.npy, each solve takes that damping.
_RUN = r"""
import ctypes, os, sys
import numpy as np
lib_path, d, mode, *entries = sys.argv[1:]
lib = ctypes.CDLL(lib_path)
vp, ci = ctypes.c_void_p, ctypes.c_int
lib.btd_packed_floats.argtypes = [ci]
D, L, b = (np.load(f"{d}/{k}.npy") for k in "DLb")
lm = np.load(f"{d}/lm.npy") if os.path.exists(f"{d}/lm.npy") else None
B, K, n = b.shape
if mode == "misaligned":  # D one float past a 16-byte boundary: 4-byte copies
    buf = np.zeros(D.size + 4, np.float32)
    D2 = buf[1:1 + D.size].reshape(D.shape)
    D2[...] = D
    D = D2
for entry in entries or ["btd_solve_f32"]:
    fn = getattr(lib, entry)
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp]
    x = np.full_like(b, np.nan)
    C = np.full((B, max(K - 1, 1), lib.btd_packed_floats(n)), np.nan, np.float32)
    err = fn(D.ctypes.data, L.ctypes.data, b.ctypes.data, x.ctypes.data, C.ctypes.data, B, K, n, None,
             None if lm is None else lm.ctypes.data)
    assert err == 0, (entry, err)
    np.save(f"{d}/x_{entry}.npy", x)
"""

WARP, SMALL = "btd_solve_f32", "btd_small_solve_f32"

KERNEL_SRC = os.path.join(os.path.dirname(EMU_DIR), "btd.cu")
with open(KERNEL_SRC) as _f:
    KERNEL_LINES = _f.readlines()
# Indices of the lines of btd.cu that call cp_wait in btd_kernel's functions.
_SMALL_START = next(i for i, line in enumerate(KERNEL_LINES) if "---- the small-batch kernel" in line)
CP_WAITS = [i for i, line in enumerate(KERNEL_LINES[:_SMALL_START]) if re.search(r"\bcp_wait\(\);", line)]
# Indices of the lines of the small kernel that hold a barrier (a block's,
# or a named one between warps) or wait for copies.
_SMALL_BODY = next(i for i, line in enumerate(KERNEL_LINES) if line.startswith("btd_small_kernel("))
_SYNC = r"__syncthreads\(\);|__pipeline_wait_prior\(0\);|\bcp_wait\(\);|\bbar_(sync|arrive)\([^;]*\);"
SMALL_SYNCS = [i for i in range(_SMALL_BODY, next(i for i in range(_SMALL_BODY, len(KERNEL_LINES))
                                                  if KERNEL_LINES[i].startswith("}")))
               if re.search(_SYNC, KERNEL_LINES[i])]
# Scenarios per SM up to which the small kernel runs, as the source fixes it.
SMALL_PER_SM = int(re.search(r"constexpr int kSmallPerSm = (\d+);", "".join(KERNEL_LINES)).group(1))
EMU_SMS, EMU_SMEM = 2, 232448  # the stand-in's card (emu/cuda_runtime.h)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("btd_emu") / "libbtd_emu.so"
    return emu.build(btd.KERNEL, os.path.join(EMU_DIR, "btd_emu.cpp"), out)


def _system(B, K, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, n, n)).astype(np.float32)
    D = A @ A.transpose(0, 1, 3, 2) + (n + 8) * np.eye(n, dtype=np.float32)
    L = (0.3 * rng.normal(size=(B, K - 1, n, n))).astype(np.float32)
    xt = rng.normal(size=(B, K, n)).astype(np.float32)
    return D, L, xt


def _damping(B, seed):
    """lm (B,) from 1e-4 to 2: the damped solves part from the undamped ones
    far beyond ATOL."""
    return (10.0 ** np.random.default_rng(seed).uniform(-4, 0.3, size=B)).astype(np.float32)


def _damped_copy(D, lm):
    """The LM loop's damped copy of D, as PyTorch computes it."""
    Dt, lmt = torch.from_numpy(D), torch.from_numpy(lm)
    return (Dt + torch.diag_embed(lmt[:, None, None] * torch.diagonal(Dt, dim1=-2, dim2=-1) + 1e-8)).numpy()


def _emu_run(lib, tmp_path, D, L, b, mode="aligned", entries=(WARP,), env=None, lm=None):
    """Returns the solving subprocess and x of each entry (None when the
    subprocess failed); with `lm` (B,), the solves are damped by it."""
    for k, a in zip("DLb", (D, L, b)):
        np.save(tmp_path / f"{k}.npy", np.ascontiguousarray(a, dtype=np.float32))
    if lm is not None:
        np.save(tmp_path / "lm.npy", np.ascontiguousarray(lm, dtype=np.float32))
    elif (tmp_path / "lm.npy").exists():
        (tmp_path / "lm.npy").unlink()
    proc = subprocess.run([sys.executable, "-c", _RUN, lib, str(tmp_path), mode, *entries],
                          capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        return proc, None
    return proc, {e: torch.from_numpy(np.load(tmp_path / f"x_{e}.npy")) for e in entries}


def _emu_solve(lib, tmp_path, D, L, b, mode="aligned", entries=(WARP,), env=None, lm=None):
    proc, xs = _emu_run(lib, tmp_path, D, L, b, mode, entries, env, lm)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return xs if len(entries) > 1 else xs[entries[0]]


@pytest.mark.parametrize(
    "B,K,n,mode",
    [
        (9, 3, 36, "aligned"),      # bench width; 9 scenarios on 8 warps: the grid stride wraps
        (3, 7, 12, "aligned"),
        (1, 9, 5, "aligned"),       # n % 4 != 0: 4-byte copies, a partial column block
        (4, 3, 31, "aligned"),      # one row per lane
        (4, 3, 32, "aligned"),
        (4, 3, 33, "aligned"),      # rows 32.. on a second row of each lane
        (2, 4, 64, "aligned"),      # two rows per lane, and row 64 of M a third
        (5, 1, 7, "aligned"),       # K = 1: no L, no scratch
        (3, 2, 36, "misaligned"),   # D not 16-byte aligned: 4-byte copies at bench width
    ],
)
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_emulated_kernel_matches_plain(emu_lib, tmp_path, B, K, n, mode, damped):
    """btd_kernel solves H x = b within ATOL of the plain version; damped by
    lm, it solves the damped copy's system, within ATOL of the plain solve of
    that copy and bit for bit its own undamped launch on the copy."""
    D, L, xt = _system(B, K, n, B * 100 + K * 10 + n)
    Dt, Lt, xtt = torch.from_numpy(D), torch.from_numpy(L), torch.from_numpy(xt)
    b = block_tridiag_matvec(Dt, Lt, xtt).contiguous()
    if not damped:
        x = _emu_solve(emu_lib, tmp_path, D, L, b.numpy(), mode)
        torch.testing.assert_close(x, block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL)
        torch.testing.assert_close(x, xtt, rtol=0, atol=ATOL)
        return
    lm = _damping(B, B + K + n)
    Dd = _damped_copy(D, lm)
    x = _emu_solve(emu_lib, tmp_path, D, L, b.numpy(), mode, lm=lm)
    xp = block_tridiag_solve(torch.from_numpy(Dd), Lt, b)
    torch.testing.assert_close(x, xp, rtol=0, atol=ATOL)
    assert not torch.allclose(xp, block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL), "the damping moves nothing"
    x_copy = _emu_solve(emu_lib, tmp_path, Dd, L, b.numpy(), mode)
    assert torch.equal(x, x_copy), f"largest difference {float((x - x_copy).abs().max())}"


def test_emulated_kernel_pivot_clamp(emu_lib, tmp_path):
    """Row and column 3 of D_0 are zero but for the diagonal, 1e-13, below
    the 1e-12 clamp, and column 3 of L_0 is zero (see
    tests/test_torch_gpu.py::test_kernel_pivot_clamp for the tolerance)."""
    D, L, xt = _system(3, 4, 12, 8)
    D[:, 0, 3, :] = 0
    D[:, 0, :, 3] = 0
    D[:, 0, 3, 3] = 1e-13
    L[:, 0, :, 3] = 0
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    xs = _emu_solve(emu_lib, tmp_path, D, L, b.numpy(), entries=(WARP, SMALL))
    x, xp = xs[WARP], block_tridiag_solve(Dt, Lt, b)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(xp).all())
    torch.testing.assert_close(x, xp, rtol=1e-4, atol=ATOL)
    assert torch.equal(xs[SMALL], x), "the small kernel's x is not btd_kernel's bit for bit"


def test_kernel_source_has_cp_waits():
    assert len(CP_WAITS) >= 3, "btd.cu's copies are waited for by cp_wait()"


@pytest.mark.parametrize("line", [pytest.param(i, id=f"btd.cu:{i + 1}") for i in CP_WAITS])
def test_emulated_kernel_needs_each_cp_wait(tmp_path, line):
    """A copy of btd.cu whose cp_wait on `line` is a bare __syncwarp (the
    lanes still meet, but do not wait for their copies) reads some copy's
    destination before the copy is done.  The stand-in leaves NaN there
    until the copy is waited for, so the solve must abort or give an answer
    that disagrees with the plain version: the stand-in does not hide a
    missing wait."""
    mutant = list(KERNEL_LINES)
    mutant[line] = re.sub(r"\bcp_wait\(\);", "__syncwarp();", mutant[line])
    (tmp_path / "emu").mkdir()
    (tmp_path / "btd.cu").write_text("".join(mutant))
    shutil.copy(os.path.join(EMU_DIR, "btd_emu.cpp"), tmp_path / "emu" / "btd_emu.cpp")
    lib = emu.build(btd.KERNEL, tmp_path / "emu" / "btd_emu.cpp", tmp_path / "libbtd_mutant.so")

    D, L, xt = _system(9, 3, 36, 7)
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    proc, xs = _emu_run(lib, run_dir, D, L, b.numpy())
    if proc.returncode == 0:
        close = torch.allclose(xs[WARP], block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL)
        assert not close, f"the kernel without the cp_wait at btd.cu:{line + 1} still agrees"


# The lines of btd.cu that damp D_0, each with the line of the wait for its
# copy that must come first: btd_kernel's cp_wait, the small kernel's
# __pipeline_wait_prior (before its __syncthreads).
_D0_DAMP = {
    "btd_kernel": (next(i for i, line in enumerate(KERNEL_LINES) if "if (lm) { damp_diagonal(" in line), r"\bcp_wait\(\);"),
    "btd_small_kernel": (next(i for i, line in enumerate(KERNEL_LINES) if "&& lm) damp_diagonal(" in line),
                         r"__pipeline_wait_prior\(0\);"),
}


@pytest.mark.parametrize("kernel", list(_D0_DAMP))
def test_emulated_damping_needs_its_wait(tmp_path, kernel):
    """A copy of btd.cu that damps D_0's diagonal before the wait for D_0's
    copy (the line moved above the wait) damps NaN or a value the copy then
    overwrites: its damped solve must abort or part from the plain solve of
    the damped copy, with the block's threads at once or one at a time."""
    line, wait = _D0_DAMP[kernel]
    at = max(i for i in range(line) if re.search(wait, KERNEL_LINES[i]))
    assert line - at <= 2, "the damping of D_0 follows the wait for its copy"
    mutant = list(KERNEL_LINES)
    mutant.insert(at, mutant.pop(line))
    (tmp_path / "emu").mkdir()
    (tmp_path / "btd.cu").write_text("".join(mutant))
    shutil.copy(os.path.join(EMU_DIR, "btd_emu.cpp"), tmp_path / "emu" / "btd_emu.cpp")
    lib = emu.build(btd.KERNEL, tmp_path / "emu" / "btd_emu.cpp", tmp_path / "libbtd_early_damp.so")
    D, L, xt = _system(2, 4, 36, 17)
    lm = _damping(2, 17)
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    xp = block_tridiag_solve(torch.from_numpy(_damped_copy(D, lm)), Lt, b)
    entry = WARP if kernel == "btd_kernel" else SMALL
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    for order in ("1", "-1", ""):
        proc, xs = _emu_run(lib, run_dir, D, L, b.numpy(), entries=(entry,), lm=lm,
                            env=dict(os.environ, QTOS_EMU_THREAD_ORDER=order))
        if proc.returncode != 0 or not torch.allclose(xs[entry], xp, rtol=0, atol=ATOL):
            return
    pytest.fail(f"{kernel} damping D_0 before its copy is waited for still agrees")


# ---- the small-batch kernel --------------------------------------------------


@pytest.mark.parametrize(
    "B,K,n,mode,order",
    [
        (3, 9, 36, "aligned", ""),      # the path's width; knots of both parities
        (2, 2, 33, "aligned", ""),      # 4-byte copies; row threads on a third warp
        (2, 9, 5, "aligned", ""),       # one partial column block
        (2, 1, 36, "aligned", ""),      # K = 1: no L, no forward step
        (1, 17, 64, "aligned", ""),     # the widest block, the most knots whose factors fit at n = 64
        (3, 2, 36, "misaligned", ""),   # D not 16-byte aligned: 4-byte copies of D
        (2, 11, 36, "aligned", ""),     # shared memory ending on a page: a read past it faults
        (2, 3, 36, "aligned", "1"),     # the block's threads one at a time, ascending
        (2, 3, 36, "aligned", "-1"),    # and descending
        (1, 2, 5, "aligned", "-1"),
    ],
)
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_small_kernel_equals_warp_kernel(emu_lib, tmp_path, B, K, n, mode, order, damped):
    """The small kernel's x is btd_kernel's bit for bit, and the plain
    version's within ATOL.  Damped by lm, both kernels' x equal each other
    and their undamped launches on the damped copy bit for bit."""
    D, L, xt = _system(B, K, n, 1000 + B * 100 + K * 10 + n)
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    env = dict(os.environ, QTOS_EMU_THREAD_ORDER=order)
    lm = _damping(B, 2000 + B + K + n) if damped else None
    xs = _emu_solve(emu_lib, tmp_path, D, L, b.numpy(), mode, (WARP, SMALL), env=env, lm=lm)
    assert torch.equal(xs[SMALL], xs[WARP]), f"largest difference {float((xs[SMALL] - xs[WARP]).abs().max())}"
    if not damped:
        torch.testing.assert_close(xs[SMALL], block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL)
        return
    Dd = _damped_copy(D, lm)
    torch.testing.assert_close(xs[SMALL], block_tridiag_solve(torch.from_numpy(Dd), Lt, b), rtol=0, atol=ATOL)
    copy = _emu_solve(emu_lib, tmp_path, Dd, L, b.numpy(), mode, (WARP, SMALL), env=env)
    for entry in (WARP, SMALL):
        assert torch.equal(xs[entry], copy[entry]), f"{entry}: the damped launch is not the undamped one on the copy"


def _emu_library(path):
    lib = ctypes.CDLL(path)
    lib.btd_pick_small.argtypes = [ctypes.c_int] * 3
    lib.btd_small_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.btd_small_smem_bytes.restype = ctypes.c_size_t
    return lib


@pytest.mark.parametrize("n,K", [(36, 73), (64, 17), (5, 2756)])
def test_pick_small_where_the_factors_fit(emu_lib, n, K):
    """The small kernel takes a shape while its shared memory fits a block
    (the stand-in's 232,448 bytes, an H100's), btd_kernel the next knot."""
    lib = _emu_library(emu_lib)
    assert lib.btd_small_smem_bytes(n, K) <= EMU_SMEM < lib.btd_small_smem_bytes(n, K + 1)
    assert lib.btd_pick_small(1, K, n) == 1 and lib.btd_pick_small(1, K + 1, n) == 0


def test_pick_small_up_to_the_crossover(emu_lib):
    """The small kernel takes up to SMALL_PER_SM scenarios per SM, btd_kernel
    more; a shape the kernels do not take is an error."""
    lib = _emu_library(emu_lib)
    edge = SMALL_PER_SM * EMU_SMS
    assert [lib.btd_pick_small(B, 41, 36) for B in (1, edge, edge + 1)] == [1, 1, 0]
    assert lib.btd_pick_small(0, 41, 36) < 0 and lib.btd_pick_small(1, 41, 65) < 0


def test_small_kernel_refuses_factors_that_do_not_fit(emu_lib, tmp_path):
    """Past the shared memory a block has, the small kernel's launch fails
    (it computes nothing), and btd_kernel, which the rule picks there,
    solves."""
    D, L, xt = _system(1, 18, 64, 5)
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    proc, _ = _emu_run(emu_lib, tmp_path, D, L, b.numpy(), entries=(WARP, SMALL))
    assert proc.returncode != 0 and SMALL in proc.stderr
    x = torch.from_numpy(np.load(tmp_path / f"x_{WARP}.npy"))
    torch.testing.assert_close(x, block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL)


def test_small_kernel_reads_stay_in_shared_memory(tmp_path):
    """At (2, 11, 36) the small kernel's shared memory ends on a page, past
    which the stand-in faults: a copy whose back pass lets the lanes past
    the last row block read their own columns (4 lane, past the factors)
    must abort."""
    src = "".join(KERNEL_LINES)
    clamp = "const int c0 = min(i0, 4 * (T - 1));"
    assert src.count(clamp) == 1
    (tmp_path / "emu").mkdir()
    (tmp_path / "btd.cu").write_text(src.replace(clamp, "const int c0 = i0;"))
    shutil.copy(os.path.join(EMU_DIR, "btd_emu.cpp"), tmp_path / "emu" / "btd_emu.cpp")
    lib = emu.build(btd.KERNEL, tmp_path / "emu" / "btd_emu.cpp", tmp_path / "libbtd_past.so")
    D, L, xt = _system(2, 11, 36, 13)
    b = block_tridiag_matvec(torch.from_numpy(D), torch.from_numpy(L), torch.from_numpy(xt)).contiguous()
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    proc, _ = _emu_run(lib, run_dir, D, L, b.numpy(), entries=(SMALL,))
    assert proc.returncode != 0


@pytest.fixture(scope="module")
def drop_lib(tmp_path_factory):
    """btd.cu with each barrier and copy wait of the small kernel left out
    when the environment's QTOS_DROP_LINE names its line (1-based)."""
    d = tmp_path_factory.mktemp("btd_drop")
    lines = list(KERNEL_LINES)
    for i in SMALL_SYNCS:
        lines[i] = re.sub(_SYNC, lambda m, i=i: f"if (emu_keep({i + 1})) {{ {m.group(0)} }}", lines[i])
    head = ('#include <cstdlib>\n'
            'static bool emu_keep(int line) {\n'
            '  static const int drop = std::atoi(std::getenv("QTOS_DROP_LINE") ? std::getenv("QTOS_DROP_LINE") : "0");\n'
            '  return line != drop;\n'
            '}\n')
    (d / "emu").mkdir()
    (d / "btd.cu").write_text(head + "".join(lines))
    shutil.copy(os.path.join(EMU_DIR, "btd_emu.cpp"), d / "emu" / "btd_emu.cpp")
    return emu.build(btd.KERNEL, d / "emu" / "btd_emu.cpp", d / "libbtd_drop.so")


def _small_agrees(lib, tmp_path, drop, order):
    D, L, xt = _system(2, 4, 36, 11)
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    proc, xs = _emu_run(lib, tmp_path, D, L, b.numpy(), entries=(WARP, SMALL),
                        env=dict(os.environ, QTOS_DROP_LINE=str(drop), QTOS_EMU_THREAD_ORDER=order))
    return proc.returncode == 0 and torch.equal(xs[SMALL], xs[WARP])


def test_small_kernel_source_has_its_barriers():
    held = "".join(KERNEL_LINES[i] for i in SMALL_SYNCS)
    assert held.count("__syncthreads") >= 3 and "bar_sync" in held and "bar_arrive" in held, \
        "the small kernel's stages end at __syncthreads, its columns are handed on at named barriers"


@pytest.mark.parametrize("order", ["", "1", "-1"], ids=["parallel", "ascending", "descending"])
def test_small_kernel_drop_harness_passes_the_source(drop_lib, tmp_path, order):
    assert _small_agrees(drop_lib, tmp_path, 0, order)


@pytest.mark.parametrize("line", [pytest.param(i, id=f"btd.cu:{i + 1}") for i in SMALL_SYNCS])
def test_small_kernel_needs_each_barrier_and_wait(drop_lib, tmp_path, line):
    """Without the barrier or copy wait on `line` the small kernel aborts or
    parts from btd_kernel, with the block's threads at once or one at a
    time in one of the two orders."""
    for order in ("1", "-1", ""):  # one at a time first: a barrier nobody completes aborts at once there
        if not _small_agrees(drop_lib, tmp_path, line + 1, order):
            return
    pytest.fail(f"the small kernel without btd.cu:{line + 1} ({KERNEL_LINES[line].strip()}) still agrees")
