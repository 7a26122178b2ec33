"""The LM loop's restore kernel on one CUDA card: `chip_smoke.py`'s phase 3c
runs `check_all`; after an edit of `qtos_torch/csrc/lm_restore.cu` the same
check runs alone (builds the kernel with `-Xptxas -v` and prints the report
first):

    python3 -m qtos_torch.tools.check_restore

At the sweep's (8192, 41), the replan's (4, 41) and the TOWR window's
(1, 41) shapes, with every step accepted, every one rejected, a random mix,
and the mix with no kept system yet (zero fill), it holds the kernel to its
plain version and to `torch.where` bit for bit and times, by CUDA events:
the kernel (inputs packed once, as the loop calls it), the plain version,
and the three `torch.where` calls that the LM loop made before (which also
write a third copy), beside the bound (the rejected windows' bytes read and
written once, zero-filled ones written once, and the B flags, at
3.35 TB/s).  Last the host time of one wrapper call against the three
`torch.where` calls at B=4.  Alone it prints the card's name and power
limit and exits non-zero without a card or when a check fails.
"""

from __future__ import annotations

import sys
import time

import torch

from qtos_torch.ops import lm_restore
from qtos_torch.ops.lm_restore import restore_rejected, restore_rejected_plain
from qtos_torch.solver.spec import NV
from qtos_torch.tools.kit import card, event_ms

PEAK_BYTES_S = 3.35e12
SHAPES = ((8192, 41), (4, 41), (1, 41))
CASES = ("accepted", "rejected", "mixed", "zero_fill")


def problem(B, K, case, dev, seed=0):
    """(accept, fresh (D, L, g), kept or None) at (B, K): the mix rejects
    about half of the windows, the last one always."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    fresh = (torch.randn(B, K, NV, NV, device=dev, generator=gen),
             torch.randn(B, K - 1, NV, NV, device=dev, generator=gen),
             torch.randn(B, K, NV, device=dev, generator=gen))
    kept = None if case == "zero_fill" else tuple(torch.randn_like(t) for t in fresh)
    if case in ("accepted", "rejected"):
        accept = torch.full((B,), case == "accepted", device=dev)
    else:
        accept = torch.rand(B, device=dev, generator=gen) < 0.5
        accept[-1] = False
    return accept, fresh, kept


def bound_ms(accept, fresh, kept) -> float:
    per_window = sum(t[0].numel() for t in fresh) * 4
    rejected = int((~accept).sum())
    return 1e3 * (rejected * per_window * (1 if kept is None else 2) + accept.numel()) / PEAK_BYTES_S


def where_three(accept, fresh, kept):
    """The LM loop's selection before the restore: three full copies."""
    a3, a4 = accept[:, None, None], accept[:, None, None, None]
    return (torch.where(a4, fresh[0], kept[0]), torch.where(a4, fresh[1], kept[1]),
            torch.where(a3, fresh[2], kept[2]))


def check_shape(lib, B, K, case, dev) -> dict:
    accept, fresh, kept = problem(B, K, case, dev)
    dst, plain = tuple(t.clone() for t in fresh), tuple(t.clone() for t in fresh)
    restore_rejected(accept, dst, kept)
    restore_rejected_plain(accept, plain, kept)
    other = kept if kept is not None else tuple(torch.zeros_like(t) for t in fresh)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) and torch.equal(a, w)
                for a, b, w in zip(dst, plain, where_three(accept, fresh, other)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    reps = 20 if B > 64 else 200
    return dict(B=B, K=K, case=case, rejected=int((~accept).sum()), bit_for_bit=equal,
                kernel_ms=event_ms(lambda: lm_restore.run(lib, accept, dst, kept, stream), reps),
                bound_ms=bound_ms(accept, fresh, kept),
                plain_ms=event_ms(lambda: restore_rejected_plain(accept, dst, kept), max(reps // 10, 3)),
                where_ms=event_ms(lambda: where_three(accept, fresh, other), reps))


def describe(row: dict) -> str:
    return " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items())


def host_us(fn, reps=2000) -> float:
    """Host microseconds per call (enqueue only; synchronised at the end)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def check_all(dev) -> tuple:
    """(rows, host): one `check_shape` row per shape and case (each says
    whether the kernel was bit for bit), and the host us per call of the
    wrapper and of the three `torch.where` calls at B=4."""
    lib = lm_restore.KERNEL.load()
    rows = [check_shape(lib, B, K, case, dev) for B, K in SHAPES for case in CASES]
    torch.cuda.empty_cache()
    accept, fresh, kept = problem(4, 41, "mixed", dev)
    dst = tuple(t.clone() for t in fresh)
    host = dict(wrapper_us=host_us(lambda: restore_rejected(accept, dst, kept)),
                where_us=host_us(lambda: where_three(accept, fresh, kept)))
    return rows, host


def main() -> int:
    if not torch.cuda.is_available():
        print("check_restore needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    try:
        name = card()
    except RuntimeError:
        name = torch.cuda.get_device_name(0)
    print(f"# card: {name}", flush=True)
    t0 = time.time()
    lm_restore.build(verbose=True)
    print(f"# built in {time.time() - t0:.1f} s", flush=True)
    rows, host = check_all(dev)
    for row in rows:
        print(describe(row), flush=True)
    print(f"# host us per call at B=4: wrapper {host['wrapper_us']:.2f}, three torch.where {host['where_us']:.2f}",
          flush=True)
    ok = all(r["bit_for_bit"] for r in rows)
    print("check_restore: OK" if ok else "check_restore: FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
