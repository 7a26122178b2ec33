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

Tolerance atol=5e-4 as tests/test_pallas_btd.py: float32 block Thomas on
diagonally dominant systems with O(1) solutions.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve

ATOL = 5e-4
EMU_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "qtos_torch", "csrc", "emu")

# Loads the library, solves the system saved in the directory, saves x.
_RUN = r"""
import ctypes, sys
import numpy as np
d = sys.argv[2]
lib = ctypes.CDLL(sys.argv[1])
vp = ctypes.c_void_p
lib.btd_solve_f32.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
lib.btd_packed_floats.argtypes = [ctypes.c_int]
D, L, b = (np.load(f"{d}/{k}.npy") for k in "DLb")
B, K, n = b.shape
if sys.argv[3] == "misaligned":  # D one float past a 16-byte boundary: 4-byte copies
    buf = np.zeros(D.size + 4, np.float32)
    D2 = buf[1:1 + D.size].reshape(D.shape)
    D2[...] = D
    D = D2
x = np.full_like(b, np.nan)
C = np.full((B, max(K - 1, 1), lib.btd_packed_floats(n)), np.nan, np.float32)
err = lib.btd_solve_f32(D.ctypes.data, L.ctypes.data, b.ctypes.data, x.ctypes.data,
                        C.ctypes.data, B, K, n, None)
assert err == 0, err
np.save(f"{d}/x.npy", x)
"""


KERNEL_SRC = os.path.join(os.path.dirname(EMU_DIR), "btd.cu")
with open(KERNEL_SRC) as _f:
    KERNEL_LINES = _f.readlines()
# Indices of the lines of btd.cu that call cp_wait.
CP_WAITS = [i for i, line in enumerate(KERNEL_LINES) if re.search(r"\bcp_wait\(\);", line)]


def _build(cpp, out):
    """Builds the stand-in's entry `cpp` (which includes ../btd.cu) into `out`."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's source for the CPU")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-pthread", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", EMU_DIR, "-o", str(out), str(cpp)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return str(out)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("btd_emu") / "libbtd_emu.so"
    return _build(os.path.join(EMU_DIR, "btd_emu.cpp"), out)


def _system(B, K, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, K, n, n)).astype(np.float32)
    D = A @ A.transpose(0, 1, 3, 2) + (n + 8) * np.eye(n, dtype=np.float32)
    L = (0.3 * rng.normal(size=(B, K - 1, n, n))).astype(np.float32)
    xt = rng.normal(size=(B, K, n)).astype(np.float32)
    return D, L, xt


def _emu_run(lib, tmp_path, D, L, b, mode="aligned"):
    """Returns the solving subprocess and x (None when the subprocess failed)."""
    for k, a in zip("DLb", (D, L, b)):
        np.save(tmp_path / f"{k}.npy", np.ascontiguousarray(a, dtype=np.float32))
    proc = subprocess.run([sys.executable, "-c", _RUN, lib, str(tmp_path), mode],
                          capture_output=True, text=True, timeout=600)
    x = torch.from_numpy(np.load(tmp_path / "x.npy")) if proc.returncode == 0 else None
    return proc, x


def _emu_solve(lib, tmp_path, D, L, b, mode="aligned"):
    proc, x = _emu_run(lib, tmp_path, D, L, b, mode)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return x


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
def test_emulated_kernel_matches_plain(emu_lib, tmp_path, B, K, n, mode):
    D, L, xt = _system(B, K, n, B * 100 + K * 10 + n)
    Dt, Lt, xtt = torch.from_numpy(D), torch.from_numpy(L), torch.from_numpy(xt)
    b = block_tridiag_matvec(Dt, Lt, xtt).contiguous()
    x = _emu_solve(emu_lib, tmp_path, D, L, b.numpy(), mode)
    torch.testing.assert_close(x, block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL)
    torch.testing.assert_close(x, xtt, rtol=0, atol=ATOL)


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
    x = _emu_solve(emu_lib, tmp_path, D, L, b.numpy())
    xp = block_tridiag_solve(Dt, Lt, b)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(xp).all())
    torch.testing.assert_close(x, xp, rtol=1e-4, atol=ATOL)


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
    lib = _build(tmp_path / "emu" / "btd_emu.cpp", tmp_path / "libbtd_mutant.so")

    D, L, xt = _system(9, 3, 36, 7)
    Dt, Lt = torch.from_numpy(D), torch.from_numpy(L)
    b = block_tridiag_matvec(Dt, Lt, torch.from_numpy(xt)).contiguous()
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    proc, x = _emu_run(lib, run_dir, D, L, b.numpy())
    if proc.returncode == 0:
        close = torch.allclose(x, block_tridiag_solve(Dt, Lt, b), rtol=0, atol=ATOL)
        assert not close, f"the kernel without the cp_wait at btd.cu:{line + 1} still agrees"
