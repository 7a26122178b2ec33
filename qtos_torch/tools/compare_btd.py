r"""Build several versions of the BTD kernel source and time them in turns on
one CUDA card.

    python3 -m qtos_torch.tools.compare_btd [--batches B,B,...] [--no-bench] [--damped] \
        NAME=PATH[!REGEX[!TEXT]] ...

Each PATH is a version of `qtos_torch/csrc/btd.cu` with the same C entry
points (`btd_solve_f32`; `btd_packed_floats` where the scratch is packed, a
full (B, K, n, n) scratch otherwise; `btd_small_solve_f32` where the version
has the small-batch kernel), built with nvcc for sm_90a.  With `!REGEX` the
version is a copy of PATH without the lines that match REGEX, and with
`!REGEX!TEXT` one in which each match is replaced by TEXT: an ablation, whose
answers are wrong but whose time says what the removed work costs.  PATH may
also be the NAME of an earlier version, whose edited copy is then edited
again.  For example

    python3 -m qtos_torch.tools.compare_btd full=qtos_torch/csrc/btd.cu \
        no_rank='qtos_torch/csrc/btd.cu!rank_update\(CS'

Each kernel of a version is timed on its own: `NAME:warp` is `btd_kernel`
(through `btd_solve_f32`), `NAME:small` the small-batch kernel (through
`btd_small_solve_f32`).  A version whose entries take the LM damping `lm`
(their last argument) is launched undamped; with `--damped` each of its
kernels is also timed damped by an lm of the batch's size, as
`NAME:warp+lm` and `NAME:small+lm`, and held bit for bit to the first
kernel's x on the damped copy D + diag_embed(lm * diag(D) + 1e-8).  The
script prints each build's registers and spills
and, where the toolkit has `cuobjdump`, each kernel's SASS instructions and
local-memory instructions (LDL, STL); each kernel's max |x - plain| at a few
shapes and whether its x equals the first kernel's bit for bit there; its time
at (B, 41, 36) for every B of `--batches` (default 1, 2, 4, 20, 64, 132, 264,
1024, 2640), CUDA events over 20 launches, the kernels in the order k1, k2,
..., k2, k1 at each B; and, unless `--no-bench`, its time at the bench shape
(8192, 41, 36) in the same turns; then the card's name, power limit and
clock.  It needs a card and exits non-zero without one, or when a build or a
launch fails.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from qtos_torch.ops.btd import _nvcc
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve
from qtos_torch.tools.check_tick import _cuobjdump, _sources

DEFAULT_BATCHES = (1, 2, 4, 20, 64, 132, 264, 1024, 2640)
# Shapes of the bit-for-bit and plain comparisons: odd widths, one row per
# lane and two, K = 1 and 2, and the path's widths.
CHECK_SHAPES = [(9, 3, 36), (4, 3, 33), (2, 4, 64), (3, 1, 7), (2, 2, 5), (1, 41, 36), (4, 41, 36),
                (20, 25, 36), (300, 3, 36)]
ENTRIES = {"warp": "btd_solve_f32", "small": "btd_small_solve_f32"}


def _build(name: str, src: str, out_dir: str) -> tuple:
    """Builds one version; returns (library path, report lines)."""
    out = os.path.join(out_dir, f"lib_{name}.so")
    proc = subprocess.run(
        [_nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, src],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    report = [f"{name}: " + line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if re.search(r"Compiling entry|registers|stack frame", line)]
    tool = _cuobjdump()
    if tool:
        sass = subprocess.run([tool, "-sass", out], capture_output=True, text=True).stdout
        for part in sass.split("Function : ")[1:]:
            fn = part.split("\n", 1)[0].strip()
            ldl = len(re.findall(r"\bLDL\b", part))
            stl = len(re.findall(r"\bSTL\b", part))
            instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
            report.append(f"{name}: SASS {fn}: {instr} instructions, {ldl} LDL, {stl} STL")
    else:
        report.append(f"{name}: no cuobjdump in the toolkit: local-memory instructions not counted")
    return out, report


def _takes_lm(src: str) -> bool:
    """Whether the version's entries take the LM damping as their last argument."""
    with open(src) as f:
        return re.search(r"int btd_solve_f32\([^)]*\blm\)", f.read()) is not None


def _load(path: str, takes_lm: bool):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for entry in ENTRIES.values():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp] + [vp] * takes_lm
            fn.restype = ci
    if hasattr(lib, "btd_packed_floats"):
        lib.btd_packed_floats.argtypes = [ci]
    return lib


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_btd: needs a CUDA card")
    batches, bench, damped, specs = DEFAULT_BATCHES, True, False, []
    for arg in argv:
        if arg.startswith("--batches="):
            batches = tuple(int(b) for b in arg.split("=", 1)[1].split(","))
        elif arg == "--no-bench":
            bench = False
        elif arg == "--damped":
            damped = True
        else:
            specs.append(arg)
    with tempfile.TemporaryDirectory(prefix="compare_btd_") as tmp:
        sources = _sources(specs, tmp)
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            builds = {name: pool.submit(_build, name, src, tmp) for name, src in sources.items()}
            built = {name: b.result() for name, b in builds.items()}
        for name, (_, report) in built.items():
            print("\n".join(report), flush=True)
        kernels = {}
        for name, (path, _) in built.items():
            takes_lm = _takes_lm(sources[name])
            lib = _load(path, takes_lm)
            for kind, entry in ENTRIES.items():
                if hasattr(lib, entry):
                    kernels[f"{name}:{kind}"] = (lib, getattr(lib, entry), takes_lm, False)
                    if damped and takes_lm:
                        kernels[f"{name}:{kind}+lm"] = (lib, getattr(lib, entry), True, True)
        _compare(kernels, batches, bench)


def _compare(kernels: dict, batches, bench: bool) -> None:
    dev = torch.device("cuda")

    def solve(name, D, L, b):
        lib, fn, takes_lm, damped = kernels[name]
        B, K, n, _ = D.shape
        x = torch.empty_like(b)
        C = (torch.empty((B, K, lib.btd_packed_floats(n)), device=dev) if hasattr(lib, "btd_packed_floats")
             else torch.empty_like(D))
        lm = damping(B) if damped else None
        err = fn(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(), C.data_ptr(), B, K, n,
                 torch.cuda.current_stream().cuda_stream, *([None if lm is None else lm.data_ptr()] * takes_lm))
        if err:
            raise RuntimeError(f"{name}: launch failed at ({B}, {K}, {n}) with CUDA error {err}")
        return x

    lms = {}

    def damping(B):
        """lm (B,) from 1e-4 to 2, one per batch size."""
        if B not in lms:
            gen = torch.Generator(device=dev).manual_seed(B)
            lms[B] = 10.0 ** (torch.rand((B,), generator=gen, device=dev) * 4.3 - 4.0)
        return lms[B]

    def system(B, K, n, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn((B, K, n, n), generator=gen, device=dev)
        D = (A @ A.transpose(-1, -2) + (n + 8) * torch.eye(n, device=dev)).contiguous()
        L = (0.3 * torch.randn((B, K - 1, n, n), generator=gen, device=dev)).contiguous()
        xt = torch.randn((B, K, n), generator=gen, device=dev)
        return D, L, block_tridiag_matvec(D, L, xt).contiguous()

    def ms(name, D, L, b, reps=20):
        solve(name, D, L, b)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            solve(name, D, L, b)
        end.record()
        torch.cuda.synchronize()
        return round(start.elapsed_time(end) / reps, 4)

    first = next(iter(kernels))
    for B, K, n in CHECK_SHAPES:
        D, L, b = system(B, K, n, 1)
        lm = damping(B)
        Dd = D + torch.diag_embed(lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8)
        xp = {False: block_tridiag_solve(D, L, b), True: block_tridiag_solve(Dd, L, b)}
        ref = {False: solve(first, D, L, b), True: solve(first, Dd, L, b)}
        xs = {name: solve(name, D, L, b) for name in kernels}
        torch.cuda.synchronize()
        damped = {name: kernels[name][3] for name in kernels}
        print(f"max |x - plain| at ({B}, {K}, {n}) (+lm: of the damped copy):",
              {name: float((x - xp[damped[name]]).abs().max()) for name, x in xs.items()},
              f"x equal to {first}'s (+lm: on the damped copy) bit for bit:",
              {name: bool(torch.equal(x, ref[damped[name]])) for name, x in xs.items() if name != first}, flush=True)
    order = list(kernels) + list(kernels)[::-1]
    for B in batches:
        D, L, b = system(B, 41, 36, 2)
        times = {name: [] for name in kernels}
        for name in order:
            times[name].append(ms(name, D, L, b))
        print(f"ms at ({B}, 41, 36), in turns:", times, flush=True)
        del D, L, b
    if bench:
        D, L, b = system(8192, 41, 36, 2)
        times = {name: [] for name in kernels}
        for name in order:
            times[name].append(ms(name, D, L, b, 10))
        print("ms at (8192, 41, 36), in turns:", times, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
