"""Wrapper of the CUDA block-tridiagonal kernel (`qtos_torch/csrc/btd.cu`).

`btd_solve(D, L, b)` has the batch-major signature of `qtos_tpu`'s
`btd_solve_pallas`.  On a CUDA tensor it launches the hand-written kernel (or
raises); on a CPU tensor it runs the plain version,
`qtos_torch.ops.tridiag.block_tridiag_solve`.

The source holds two kernels, compiled with `nvcc` for sm_90a at first use
into `qtos_torch/_build/` (keyed by the source's hash) and loaded with
ctypes.  `btd_kernel` solves one scenario per warp, for large batches; its
scratch holds the factors C_0 .. C_{K-2} of each scenario, lower triangles
packed: (B, K-1, n(n+1)/2 rounded up to a multiple of 4) floats.  The
small-batch kernel solves one scenario per block of 8 warps and keeps the
factors in shared memory.  The library's `btd_pick_small` chooses between
them from (B, K, n) before each launch: the small kernel while B is at most
a fixed number of scenarios per SM (the crossover measured on an H100) and
its factors fit in a block's shared memory.  The two give the same x bit for
bit.  There is no fallback: a failed launch of either raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from qtos_torch.ops.tridiag import block_tridiag_solve

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "btd.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
MAX_N = 64

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> str:
    """Compile `csrc/btd.cu` into a shared library (if not built yet) and
    return its path.  ``verbose`` adds ``-Xptxas -v`` and prints its report."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libqtos_btd_{tag}.so")
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE,
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            for fn in (lib.btd_solve_f32, lib.btd_small_solve_f32):
                fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
                fn.restype = ctypes.c_int
            lib.btd_pick_small.argtypes = [ctypes.c_int] * 3
            lib.btd_pick_small.restype = ctypes.c_int
            lib.btd_resident_warps.argtypes = [ctypes.c_int]
            lib.btd_resident_warps.restype = ctypes.c_int
            lib.btd_smem_bytes.argtypes = [ctypes.c_int]
            lib.btd_smem_bytes.restype = ctypes.c_size_t
            lib.btd_packed_floats.argtypes = [ctypes.c_int]
            lib.btd_packed_floats.restype = ctypes.c_int
            _lib = lib
    return _lib


def occupancy(n: int) -> dict:
    """The kernel's occupancy on the current CUDA device at block width n:
    resident warps (= scenarios in flight) per SM and dynamic shared memory
    per block in bytes."""
    lib = _load()
    warps = lib.btd_resident_warps(n)
    if warps <= 0:
        raise RuntimeError(f"btd occupancy query failed: CUDA error {-warps}")
    return {"warps_per_sm": warps, "smem_per_block": int(lib.btd_smem_bytes(n))}


def picks_small(B: int, K: int, n: int) -> bool:
    """Whether `btd_solve` at (B, K, n) on the current CUDA device launches
    the small-batch kernel (else `btd_kernel`)."""
    pick = _load().btd_pick_small(B, K, n)
    if pick < 0:
        raise RuntimeError(f"btd kernel choice failed at ({B}, {K}, {n}): CUDA error {-pick}")
    return pick == 1


def work(B: int, K: int, n: int) -> tuple:
    """(bytes, flops) that one solve at (B, K, n) must do, whatever the
    kernel: D, L and b read once and x written once; per scenario K Cholesky
    factorisations and two vector solves, and per sub-diagonal block the
    solves M C^T = L and C z = y, the lower triangle of S = D - M M^T, and
    the products M z and L^T x."""
    nbytes = 4 * (B * K * n * n + B * (K - 1) * n * n + 2 * B * K * n)
    per = (K * (n**3 / 3 + 4 * n * n)
           + (K - 1) * ((n + 1) * n * n + n * n * (n + 1) + 4 * n * n))
    return nbytes, B * per


def _check(D, L, b):
    if not (D.dtype == L.dtype == b.dtype == torch.float32):
        raise TypeError(f"btd_solve takes float32, got {D.dtype}, {L.dtype}, {b.dtype}")
    if D.dim() != 4 or L.dim() != 4 or b.dim() != 3:
        raise ValueError("btd_solve takes D (B,K,n,n), L (B,K-1,n,n), b (B,K,n)")
    B, K, n, n2 = D.shape
    if n != n2 or tuple(L.shape) != (B, K - 1, n, n) or tuple(b.shape) != (B, K, n):
        raise ValueError(
            f"btd_solve shapes disagree: D {tuple(D.shape)}, L {tuple(L.shape)}, b {tuple(b.shape)}"
        )
    if not (D.device == L.device == b.device):
        raise ValueError(f"btd_solve inputs on different devices: {D.device}, {L.device}, {b.device}")
    if not (D.is_contiguous() and L.is_contiguous() and b.is_contiguous()):
        raise ValueError("btd_solve takes contiguous tensors")
    return B, K, n


def btd_solve(D: torch.Tensor, L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve batched SPD block-tridiagonal systems H x = b.

    Args:
      D: (B, K, n, n) diagonal blocks.
      L: (B, K-1, n, n) sub-diagonal blocks.
      b: (B, K, n) right-hand sides.

    Returns:
      x: (B, K, n).

    `btd_solve.launches` counts kernel launches (one per call on CUDA),
    `btd_solve.small_launches` those of them that went to the small-batch
    kernel.
    """
    B, K, n = _check(D, L, b)
    if D.device.type == "cpu":
        return block_tridiag_solve(D, L, b)
    if D.device.type != "cuda":
        raise ValueError(f"btd_solve runs on cuda or cpu, not {D.device}")
    if n > MAX_N:
        raise ValueError(f"btd_solve kernel takes n <= {MAX_N}, got {n}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = _load()
    with torch.cuda.device(D.device):
        small = picks_small(B, K, n)
        if small:
            launch, scratch = lib.btd_small_solve_f32, None
        else:
            launch = lib.btd_solve_f32
            scratch = torch.empty((B, K - 1, lib.btd_packed_floats(n)), dtype=D.dtype, device=D.device)
        stream = torch.cuda.current_stream(D.device).cuda_stream
        err = launch(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), B, K, n, stream)
    if err != 0:
        kind = "small-batch" if small else "btd"
        raise RuntimeError(f"{kind} kernel launch failed at ({B}, {K}, {n}): CUDA error {err}")
    btd_solve.launches += 1
    btd_solve.small_launches += small
    return x


btd_solve.launches = 0
btd_solve.small_launches = 0
