r"""Build several versions of the BTD kernel source and time them in turns on
one CUDA card.

    python3 -m qtos_torch.tools.compare_btd NAME=PATH[!REGEX] ...

Each PATH is a version of `qtos_torch/csrc/btd.cu` with the same C entry
points (`btd_solve_f32`; `btd_packed_floats` where the scratch is packed, a
full (B, K, n, n) scratch otherwise), built with nvcc for sm_90a.  With
`!REGEX` the version is a copy of PATH without the
lines that match REGEX: an ablation, whose answers are wrong but whose time
says what the deleted calls cost, for example

    python3 -m qtos_torch.tools.compare_btd full=qtos_torch/csrc/btd.cu \
        no_rank='qtos_torch/csrc/btd.cu!rank_update\(CS'

The script prints each build's registers and spills, each
version's max |x - plain| at a few shapes, its time at B = 132, 1024 and 2640
(K=41, n=36), and its time at the bench shape (8192, 41, 36) in the order
v1, v2, ..., v2, v1, then the card's name, power limit and clock.  It needs a
card and exits non-zero without one, or when a launch fails.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from qtos_torch.ops.btd import _nvcc
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve


def _build(name: str, spec: str, out_dir: str):
    src, _, drop = spec.partition("!")
    if drop:
        with open(src) as f:
            kept = [line for line in f if not re.search(drop, line)]
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.writelines(kept)
    out = os.path.join(out_dir, f"lib_{name}.so")
    proc = subprocess.run(
        [_nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, src],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    print(name, re.findall(r"Used \d+ registers.*|\d+ bytes spill stores", proc.stderr), flush=True)
    lib = ctypes.CDLL(out)
    vp = ctypes.c_void_p
    lib.btd_solve_f32.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
    packed = hasattr(lib, "btd_packed_floats")
    if packed:
        lib.btd_packed_floats.argtypes = [ctypes.c_int]
    return lib, packed


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_btd: needs a CUDA card")
    with tempfile.TemporaryDirectory(prefix="compare_btd_") as tmp:
        _compare({name: _build(name, spec, tmp) for name, spec in (a.split("=", 1) for a in argv)})


def _compare(libs) -> None:
    dev = torch.device("cuda")

    def solve(name, D, L, b):
        lib, packed = libs[name]
        B, K, n, _ = D.shape
        x = torch.empty_like(b)
        C = (torch.empty((B, K, lib.btd_packed_floats(n)), device=dev) if packed
             else torch.empty_like(D))
        err = lib.btd_solve_f32(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(),
                                C.data_ptr(), B, K, n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed at ({B}, {K}, {n}) with CUDA error {err}")
        return x

    def system(B, K, n, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn((B, K, n, n), generator=gen, device=dev)
        D = (A @ A.transpose(-1, -2) + (n + 8) * torch.eye(n, device=dev)).contiguous()
        L = (0.3 * torch.randn((B, K - 1, n, n), generator=gen, device=dev)).contiguous()
        xt = torch.randn((B, K, n), generator=gen, device=dev)
        return D, L, block_tridiag_matvec(D, L, xt).contiguous()

    def ms(name, D, L, b, reps):
        solve(name, D, L, b)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            solve(name, D, L, b)
        end.record()
        torch.cuda.synchronize()
        return round(start.elapsed_time(end) / reps, 3)

    for B, K, n in [(9, 3, 36), (3000, 3, 36), (4, 3, 33), (2, 4, 64), (64, 41, 36)]:
        D, L, b = system(B, K, n, 1)
        xp = block_tridiag_solve(D, L, b)
        print(f"max |x - plain| at ({B}, {K}, {n}):",
              {name: float((solve(name, D, L, b) - xp).abs().max()) for name in libs}, flush=True)
    for B in (132, 1024, 2640):
        D, L, b = system(B, 41, 36, 2)
        print(f"ms at ({B}, 41, 36):", {name: ms(name, D, L, b, 5) for name in libs}, flush=True)
    D, L, b = system(8192, 41, 36, 2)
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(ms(name, D, L, b, 10))
    print("ms at (8192, 41, 36), in turns:", times, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
