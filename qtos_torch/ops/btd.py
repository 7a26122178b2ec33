"""Wrapper of the CUDA block-tridiagonal kernel (`qtos_torch/csrc/btd.cu`).

`btd_solve(D, L, b)` has the batch-major signature of `qtos_tpu`'s
`btd_solve_pallas`.  On a CUDA tensor it launches the hand-written kernel (or
raises); on a CPU tensor it runs the plain version,
`qtos_torch.ops.tridiag.block_tridiag_solve`.  With `lm` it solves the LM
loop's damped system, the damping added by the kernel as each diagonal block
lands in shared memory: D is read, never written or copied.

The source holds two kernels, built at first use by `qtos_torch.ops.cuda_lib`
with the common flags only (`-O3`, no `--fmad=false`) and loaded with
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

import torch

from qtos_torch.ops import cuda_lib
from qtos_torch.ops.tridiag import block_tridiag_solve

SOURCE = cuda_lib.csrc("btd.cu")
MAX_N = 64


def load_library(path: str):
    """The kernel's library at `path` (built by `build`, or the CPU build of
    the same source in the tests) with its functions' argument types set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.btd_solve_f32, lib.btd_small_solve_f32):
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp]
        fn.restype = ci
    lib.btd_pick_small.argtypes = [ci] * 3
    lib.btd_pick_small.restype = ci
    lib.btd_resident_warps.argtypes = [ci]
    lib.btd_resident_warps.restype = ci
    lib.btd_smem_bytes.argtypes = [ci]
    lib.btd_smem_bytes.restype = ctypes.c_size_t
    lib.btd_packed_floats.argtypes = [ci]
    lib.btd_packed_floats.restype = ci
    return lib


KERNEL = cuda_lib.Kernel(SOURCE, "libqtos_btd", load_library)
build = KERNEL.build


def occupancy(n: int) -> dict:
    """The kernel's occupancy on the current CUDA device at block width n:
    resident warps (= scenarios in flight) per SM and dynamic shared memory
    per block in bytes."""
    lib = KERNEL.load()
    warps = lib.btd_resident_warps(n)
    if warps <= 0:
        raise RuntimeError(f"btd occupancy query failed: CUDA error {-warps}")
    return {"warps_per_sm": warps, "smem_per_block": int(lib.btd_smem_bytes(n))}


def picks_small(B: int, K: int, n: int) -> bool:
    """Whether `btd_solve` at (B, K, n) on the current CUDA device launches
    the small-batch kernel (else `btd_kernel`)."""
    pick = KERNEL.load().btd_pick_small(B, K, n)
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


def _check(D, L, b, lm):
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
    if lm is not None:
        if lm.dtype != torch.float32 or tuple(lm.shape) != (B,) or lm.device != D.device:
            raise ValueError(f"btd_solve's lm is float32 ({B},) on {D.device}, got {lm.dtype} "
                             f"{tuple(lm.shape)} on {lm.device}")
        if not lm.is_contiguous():
            raise ValueError("btd_solve takes a contiguous lm")
    return B, K, n


def btd_solve(D: torch.Tensor, L: torch.Tensor, b: torch.Tensor,
              lm: torch.Tensor | None = None) -> torch.Tensor:
    """Solve batched SPD block-tridiagonal systems H x = b.

    Args:
      D: (B, K, n, n) diagonal blocks.
      L: (B, K-1, n, n) sub-diagonal blocks.
      b: (B, K, n) right-hand sides.
      lm: optional (B,) Levenberg-Marquardt damping: H's diagonal blocks are
        then D + diag(lm * diag(D) + 1e-8), each operation rounded in float32
        as written (D is not written).

    Returns:
      x: (B, K, n).

    `btd_solve.launches` counts kernel launches (one per call on CUDA),
    `btd_solve.small_launches` those of them that went to the small-batch
    kernel, `btd_solve.damped_launches` those that took `lm`.
    """
    B, K, n = _check(D, L, b, lm)
    if D.device.type == "cpu":
        if lm is not None:
            D = D + torch.diag_embed(lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8)
        return block_tridiag_solve(D, L, b)
    if D.device.type != "cuda":
        raise ValueError(f"btd_solve runs on cuda or cpu, not {D.device}")
    if n > MAX_N:
        raise ValueError(f"btd_solve kernel takes n <= {MAX_N}, got {n}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = KERNEL.load()
    with torch.cuda.device(D.device):
        small = picks_small(B, K, n)
        if small:
            launch, scratch = lib.btd_small_solve_f32, None
        else:
            launch = lib.btd_solve_f32
            scratch = torch.empty((B, K - 1, lib.btd_packed_floats(n)), dtype=D.dtype, device=D.device)
        stream = torch.cuda.current_stream(D.device).cuda_stream
        err = launch(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), B, K, n, stream,
                     None if lm is None else lm.data_ptr())
    if err != 0:
        kind = "small-batch" if small else "btd"
        raise RuntimeError(f"{kind} kernel launch failed at ({B}, {K}, {n}): CUDA error {err}")
    btd_solve.launches += 1
    btd_solve.small_launches += small
    btd_solve.damped_launches += lm is not None
    return x


cuda_lib.count_launches(btd_solve, "launches", "small_launches", "damped_launches")
