r"""Build several versions of the BTD kernel source and time them in turns on
one CUDA card.

    python3 -m qtos_torch.tools.compare_btd [--batches B,B,...] [--horizon K] [--no-bench] [--damped] \
        NAME=PATH[!REGEX[!TEXT]] ...

Each version of `qtos_torch/csrc/btd.cu` is given as `qtos_torch.tools.kit`
takes them (PATH, or an ablated copy of it) and must have the current C
entry points of `btd.cu` (`btd_solve_f32`, `btd_small_solve_f32` and
`btd_reduce_solve_f32`, each taking the LM damping as its last argument, and
`btd_packed_floats` and `btd_reduce_scratch_floats`); it is
built with the kernel's own flags (`qtos_torch.ops.btd.KERNEL`).  For
example

    python3 -m qtos_torch.tools.compare_btd full=qtos_torch/csrc/btd.cu \
        no_rank='qtos_torch/csrc/btd.cu!rank_update\(CS'

Each kernel of a version is timed on its own: `NAME:warp` is `btd_kernel`
(through `btd_solve_f32`), `NAME:small` the small-batch kernel (through
`btd_small_solve_f32`), `NAME:reduce` the long-horizon kernel (through
`btd_reduce_solve_f32`, which eliminates in another order: its x is not
btd_kernel's bit for bit), launched undamped; with `--damped` each kernel is
also timed damped by an lm of the batch's size, as `NAME:warp+lm` and
`NAME:small+lm`, and held bit for bit to the first kernel's x on the
damped copy D + diag_embed(lm * diag(D) + 1e-8).  The script prints each
build's registers and spills and, where the toolkit has `cuobjdump`, each
kernel's SASS instructions and
local-memory instructions (LDL, STL); each kernel's max |x - plain| at a few
shapes and whether its x equals the first kernel's bit for bit there; its time
at (B, K, 36) for every B of `--batches` (default 1, 2, 4, 20, 64, 132, 264,
1024, 2640) and K of `--horizon` (default 41), CUDA events over 20 launches,
the kernels in the order k1, k2, ..., k2, k1 at each B; and, unless
`--no-bench`, its time at the bench shape (8192, 41, 36) in the same turns.
The small kernel sits out the shapes whose factors its shared memory cannot
hold; then the card's name, power limit and
clock.  It needs a card and exits non-zero without one, or when a build or a
launch fails.
"""

from __future__ import annotations

import concurrent.futures
import sys
import tempfile

import torch

from qtos_torch.ops import btd
from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve
from qtos_torch.tools import kit

DEFAULT_BATCHES = (1, 2, 4, 20, 64, 132, 264, 1024, 2640)
# Shapes of the bit-for-bit and plain comparisons: odd widths, one row per
# lane and two, K = 1 and 2, and the path's widths.
CHECK_SHAPES = [(9, 3, 36), (4, 3, 33), (2, 4, 64), (3, 1, 7), (2, 2, 5), (1, 41, 36), (4, 41, 36),
                (20, 25, 36), (300, 3, 36), (1, 154, 36)]
ENTRIES = {"warp": "btd_solve_f32", "small": "btd_small_solve_f32", "reduce": "btd_reduce_solve_f32"}


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        sys.exit("compare_btd: needs a CUDA card")
    batches, horizon, bench, damped, specs = DEFAULT_BATCHES, 41, True, False, []
    for arg in argv:
        if arg.startswith("--batches="):
            batches = tuple(int(b) for b in arg.split("=", 1)[1].split(","))
        elif arg.startswith("--horizon="):
            horizon = int(arg.split("=", 1)[1])
        elif arg == "--no-bench":
            bench = False
        elif arg == "--damped":
            damped = True
        else:
            specs.append(arg)
    with tempfile.TemporaryDirectory(prefix="compare_btd_") as tmp:
        sources = kit.sources(specs, tmp)
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            builds = {name: pool.submit(kit.build_version, btd.KERNEL, name, src, tmp)
                      for name, src in sources.items()}
            built = {name: b.result() for name, b in builds.items()}
        for name, (_, report) in built.items():
            print("\n".join(report), flush=True)
        kernels = {}
        for name, (path, _) in built.items():
            lib = btd.load_library(path)
            for kind, entry in ENTRIES.items():
                kernels[f"{name}:{kind}"] = (lib, getattr(lib, entry), False)
                if damped:
                    kernels[f"{name}:{kind}+lm"] = (lib, getattr(lib, entry), True)
        _compare(kernels, batches, horizon, bench)


def _compare(kernels: dict, batches, horizon: int, bench: bool) -> None:
    dev = torch.device("cuda")

    def runs(name, K, n):
        """Whether the kernel `name` takes K knots at width n: the small
        kernel only where its shared memory holds their factors."""
        lib = kernels[name][0]
        return not name.split("+")[0].endswith(":small") or lib.btd_pick_small(1, K, n) == 1

    def solve(name, D, L, b):
        lib, fn, damped = kernels[name]
        B, K, n, _ = D.shape
        x = torch.empty_like(b)
        if name.split("+")[0].endswith(":reduce"):
            C = torch.empty((lib.btd_reduce_scratch_floats(B, K, n),), device=dev)
        else:
            C = torch.empty((B, K, lib.btd_packed_floats(n)), device=dev)
        lm = damping(B) if damped else None
        err = fn(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(), C.data_ptr(), B, K, n,
                 torch.cuda.current_stream().cuda_stream, None if lm is None else lm.data_ptr())
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
        return round(kit.event_ms(lambda: solve(name, D, L, b), reps), 4)

    first = next(iter(kernels))
    for B, K, n in CHECK_SHAPES:
        D, L, b = system(B, K, n, 1)
        lm = damping(B)
        Dd = D + torch.diag_embed(lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8)
        xp = {False: block_tridiag_solve(D, L, b), True: block_tridiag_solve(Dd, L, b)}
        ref = {False: solve(first, D, L, b), True: solve(first, Dd, L, b)}
        xs = {name: solve(name, D, L, b) for name in kernels if runs(name, K, n)}
        torch.cuda.synchronize()
        damped = {name: kernels[name][2] for name in kernels}
        print(f"max |x - plain| at ({B}, {K}, {n}) (+lm: of the damped copy):",
              {name: float((x - xp[damped[name]]).abs().max()) for name, x in xs.items()},
              f"x equal to {first}'s (+lm: on the damped copy) bit for bit:",
              {name: bool(torch.equal(x, ref[damped[name]])) for name, x in xs.items() if name != first}, flush=True)
    timed = [name for name in kernels if runs(name, horizon, 36)]
    order = timed + timed[::-1]
    for B in batches:
        D, L, b = system(B, horizon, 36, 2)
        times = {name: [] for name in timed}
        for name in order:
            times[name].append(ms(name, D, L, b))
        print(f"ms at ({B}, {horizon}, 36), in turns:", times, flush=True)
        del D, L, b
    if bench:
        D, L, b = system(8192, 41, 36, 2)
        order = list(kernels) + list(kernels)[::-1]
        times = {name: [] for name in kernels}
        for name in order:
            times[name].append(ms(name, D, L, b, 10))
        print("ms at (8192, 41, 36), in turns:", times, flush=True)
    print(kit.card(("name", "power.limit", "clocks.sm")))


if __name__ == "__main__":
    main(sys.argv[1:])
