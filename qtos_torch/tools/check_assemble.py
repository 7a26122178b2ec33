r"""The assembly kernel against its plain version on the card, and versions
of its source side by side.

    python3 -m qtos_torch.tools.check_assemble [--shapes 4x41 8192x41] [--device cuda]
    python3 -m qtos_torch.tools.check_assemble --versions NAME=PATH[!REGEX[!TEXT]] ...

Builds `qtos_torch/csrc/assemble.cu` (printing ptxas's registers and spills),
then for each (B, K) holds `qtos_torch.ops.assemble.assemble_kernel` to the
plain version (`knot_normal` + `interval_normal`, run on the same device) on
two iterates: the bench distribution's first one (plane x3, goals 0.3-0.8 m,
`initial_guess`), and a perturbed one over step terrain with every hinge
family active (`problem(..., "steps")`, the problem of
tests/test_torch_assemble_emu.py at any size).  It checks that two launches
on one input agree bit for bit and times both versions with CUDA events at
the shapes the main path gives the kernel: the kernel's launches on inputs
packed once (`ops.assemble.prepare`), and the wrapper's whole call, whose
packing on the host sets the time at small B.  One JSON line at the end.

With `--versions` it builds each version of `assemble.cu` (given as
`qtos_torch.tools.kit` takes them: PATH, or an ablated copy of it; each must
have the current C entry points of `assemble.cu`) with the kernel's own
flags, prints each one's registers and spills, its shared memory and blocks
per SM at K=41, whether its outputs equal the first version's bit for bit
at every shape of `SHAPES` on both iterates, and its ms per launch at (4,
41), (1024, 41) and (8192, 41), timed in turns (v1, v2, ..., v2, v1; CUDA
events over 10 launches on inputs packed once).  An ablation's answers are
wrong; its time says what the removed work costs.

Tolerance: atol=rtol=2e-4 (tests/test_torch_assemble.py's) plus ROUNDING =
1e-5 of each entry's rounding scale (`rounding_scales`).  On the perturbed
iterate the blocks' terms reach 1e6 and cancel, so two float32 summation
orders of one entry part by up to ~1e-6 of the scale of its terms, which is
more than 2e-4 of a small entry; on the CPU stand-in the kernel's source was
within 7.2e-7 of that scale of the plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import tempfile

import numpy as np
import torch

from qtos_torch.device import resolve_device
from qtos_torch.ops import assemble as asm
from qtos_torch.ops.cuda_lib import ptxas_registers
from qtos_torch.solver.assemble import assemble_plain
from qtos_torch.solver.spec import NV, SolverConfig, default_spec
from qtos_torch.solver.transcription import initial_guess, knot_aux
from qtos_torch.terrain import make_terrain
from qtos_torch.terrain.heightfield import height_at, slope_terrain
from qtos_torch.tools import assemble_floor, kit

ATOL = RTOL = 2e-4
ROUNDING = 1e-5
# The shapes the paths give the kernel: the quick start (1, 33), a replan
# (4, 41), the feasibility probe (20, 25), the card-vs-CPU solve (64, 41),
# phases 4 and 9 (1024, 41), the bench batch (8192, 41), the ranks'
# slices of phase 9's two-card run (3, 13) and (512, 13), and the TOWR
# window's solve (1, 41).
SHAPES = [(1, 33), (4, 41), (20, 25), (64, 41), (1024, 41), (8192, 41), (3, 13), (512, 13), (1, 41)]
TIMED = [(1, 41), (4, 41), (1024, 41), (8192, 41)]
# H100 SXM (NVIDIA data sheet): HBM bandwidth and non-tensor-core float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def perturb(x, terr, aux, slope):
    """x with knots moved so that each hinge family is active somewhere: a
    stance foot past its first stance on the slope grid's steepest cell, a
    swing foot 3 cm below the ground, a foot 25 cm ahead of its place, forces
    outside the friction pyramid and above the cap, a base 5 cm above the
    ground."""
    x = x.clone()
    B, K = x.shape[:2]
    c, first = aux.contact, aux.first_stance
    spots = torch.nonzero((c[0] > 0) & (first[0] == 0))
    if len(spots):
        k, i = spots[0].tolist()
        iy, ix = np.unravel_index(int(slope.height.argmax()), tuple(slope.height.shape))
        x[0, k, 12 + 3 * i] = terr.origin[0] + (ix + 0.5) * terr.resolution
        x[0, k, 13 + 3 * i] = terr.origin[1] + (iy + 0.5) * terr.resolution
    b = 1 % B
    spots = torch.nonzero(c[b] == 0)
    if len(spots):
        k, i = spots[0].tolist()
        x[b, k, 14 + 3 * i] = height_at(terr, x[b, k, 12 + 3 * i], x[b, k, 13 + 3 * i]) - 0.03
    x[2 % B, K // 2, 12] += 0.25
    x[0, min(4, K - 1), 24:36] = torch.tensor([3.0, -2.0, 0.5] * 4, device=x.device)
    x[1 % B, min(5, K - 1), 26] = 8.0
    x[2 % B, min(3, K - 1), 29] = -0.5
    b, k = 1 % B, min(8, K - 1)
    x[b, k, 2] = height_at(terr, x[b, k, 0], x[b, k, 1]) + 0.05
    return x.contiguous()


def problem(kind: str, B: int, K: int, device, seed: int = 2) -> dict:
    """The assembly's inputs at (B, K): "bench" (the first iterate of the
    bench distribution) or "steps" (tests/test_torch_assemble_emu.py's
    perturbed iterate over `step` + `feasibility`)."""
    dev = resolve_device(device)
    cfg = SolverConfig(max_iters=3, rescue_iters=12)
    if kind == "bench":
        terr = make_terrain(["plane"] * 3, device=dev)
        specs = default_spec(terr, goal_xy=(torch.linspace(0.3, 0.8, B, device=dev), 0.0), K=K, device=dev)
        x = initial_guess(specs, terr, cfg)
    elif kind == "steps":
        terr = make_terrain(["step", "feasibility"], device=dev)
        goals = np.linspace(0.3, 0.6, B).astype(np.float32)
        duration = 1.5 if K <= 13 else 2.5
        specs = default_spec(terr, start_xy=(0.0, 0.08), goal_xy=(goals, 0.08), K=K, duration=duration,
                             device=dev)
        x0 = initial_guess(specs, terr, cfg)
        noise = 0.05 * np.random.default_rng(seed).normal(size=tuple(x0.shape)).astype(np.float32)
        x = x0 + torch.from_numpy(noise).to(dev)
    else:
        raise ValueError(f"kind is 'bench' or 'steps', not {kind!r}")
    aux, slope = knot_aux(specs, terr, cfg), slope_terrain(terr, cfg.slope_probe_d)
    if kind == "steps":
        x = perturb(x, terr, aux, slope)
    return dict(x=x.contiguous(), specs=specs, terrain=terr, cfg=cfg, aux=aux, slope=slope)


def plain(p: dict):
    """The plain version on the problem's own device."""
    return assemble_plain(p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])


def kernel(p: dict):
    return asm.assemble_kernel(p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])


def gram_flops(B: int, K: int) -> int:
    """Operations of one assembly at (B, K): the multiply-adds of the three
    12-row Gram products and two matrix-vector products of every interval
    (the closed forms, a few percent more, are left out)."""
    return B * (K - 1) * 2 * (3 * NV * NV * 12 + 2 * NV * 12)


def bound(p: dict) -> dict:
    """The least time the card could take for one assembly of this problem:
    each input read once (x, the per-knot aux and contacts, the per-window
    start and goal, both grids), each output written once, against
    `gram_flops`."""
    B, K, _ = p["x"].shape
    hw = p["terrain"].height.numel()
    inputs = B * K * (NV + 4 * 7) + K * 2 + B * 28 + 2 * hw
    outputs = B * K * NV * NV + B * (K - 1) * NV * NV + B * K * NV + B
    nbytes = 4 * (inputs + outputs)
    flops = gram_flops(B, K)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def rounding_scales(ref):
    """Per entry of (D, L, g) a bound on the sum of the magnitudes of the
    terms that make it: D = J^T J is a Gram matrix, so the terms of D_ij sum
    in magnitude to at most sqrt(D_ii D_jj) (Cauchy-Schwarz), those of
    L_k,ij = (Jb^T Ja)_ij to sqrt(D_k+1,ii D_k,jj), and those of g_i =
    (J^T rho)_i to sqrt(D_ii |rho|^2) with |rho|^2 = 2 merit.  A float32 sum
    of such terms carries ~1e-7 of that scale whatever its own size."""
    D, _, _, merit = ref
    d = torch.diagonal(D, dim1=-2, dim2=-1).clamp(min=0.0)
    return (torch.sqrt(d[..., :, None] * d[..., None, :]), torch.sqrt(d[:, 1:, :, None] * d[:, :-1, None, :]),
            torch.sqrt(2.0 * merit.clamp(min=0.0)[:, None, None] * d), merit.abs())


def compare(kind: str, B: int, K: int, device, timed: bool = False) -> dict:
    """Kernel against plain version at (B, K) on `kind`'s iterate, both on
    the card: per output the largest |kernel - plain|, its largest share of
    atol + rtol |plain| (2e-4 each) and of that plus ROUNDING times the
    entry's rounding scale (`rounding_scales`), which decides; whether two
    launches agree bit for bit; and (``timed``) the kernel's ms per launch,
    the wrapper's per call, the plain version's, the bound and this
    design's floor.  Launches made here are not counted in
    `assemble_kernel.launches`."""
    p = problem(kind, B, K, device)
    before = asm.assemble_kernel.launches
    out, again, ref = kernel(p), kernel(p), plain(p)
    torch.cuda.synchronize()
    row = dict(kind=kind, B=B, K=K, bitwise_repeatable=all(torch.equal(a, b) for a, b in zip(out, again)))
    del again
    errs, shares, gated, scaled = {}, {}, {}, {}
    for name, o, r, sc in zip(("D", "L", "g", "merit"), out, ref, rounding_scales(ref)):
        d = (o - r).abs()
        tol = ATOL + RTOL * r.abs()
        errs[name] = float(d.max())
        shares[name] = float((d / tol).max())
        gated[name] = float((d / (tol + ROUNDING * sc)).max())
        scaled[name] = float((d / sc.clamp(min=1e-30)).max())
        del d, tol
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    row.update(max_abs_err=max(errs.values()), errors=errs, tolerance_shares=shares, gate_shares=gated,
               error_over_scale=scaled, finite=finite,
               ok=finite and row["bitwise_repeatable"] and max(gated.values()) <= 1.0)
    del out, ref
    if timed:
        launch, _ = asm.prepare(asm.KERNEL.load(), p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
        stream = torch.cuda.current_stream(device).cuda_stream
        row.update(ms=kit.event_ms(lambda: launch(stream), 10), call_ms=kit.event_ms(lambda: kernel(p), 10),
                   plain_ms=kit.event_ms(lambda: plain(p), 2), **bound(p),
                   **assemble_floor.design_floor(B, K, assemble_floor.max_sm_clock_mhz()))
    asm.assemble_kernel.launches = before
    torch.cuda.empty_cache()
    return row


def describe(row: dict) -> str:
    errs = ", ".join(f"{k} {v:.3e} ({row['tolerance_shares'][k]:.3f} of the tolerance)"
                     for k, v in row["errors"].items())
    gate = ", ".join(f"{k} {v:.3f} ({row['error_over_scale'][k]:.2e} of its scale)"
                     for k, v in row["gate_shares"].items())
    line = (f"assembly kernel vs plain, {row['kind']} iterate, B={row['B']} K={row['K']}: {errs}; share of the "
            f"gate with the rounding scale: {gate}; two launches equal bit for bit {row['bitwise_repeatable']}, "
            f"finite {row['finite']}, ok {row['ok']}")
    if "ms" in row:
        line += (f"; kernel {row['ms']:.3f} ms (the wrapper's whole call {row['call_ms']:.3f} ms), plain "
                 f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by "
                 f"{row['bound_by']} ({row['bytes'] / 1e9:.3f} GB, {row['flops'] / 1e9:.2f} GFLOP), this design's floor "
                 f"{row['floor_ms']:.4f} ms by {row['floor_by']} (float32 {row['fp32_ms']:.4f}, shared memory "
                 f"{row['smem_ms']:.4f})")
    return line


def versions(specs: list, device) -> list:
    """`--versions`: build, compare with the first and time each version."""
    out_dir = tempfile.mkdtemp(prefix="asm_versions_")
    libs, rows = {}, []
    for name, path in kit.sources(specs, out_dir).items():
        lib_path, report = kit.build_version(asm.KERNEL, name, path, out_dir)
        print("\n".join(report), flush=True)
        regs, spills = ptxas_registers("\n".join(report), "assemble_kernel")
        libs[name] = asm.load_library(lib_path)
        rows.append(dict(name=name, source=path, registers=regs, spill_stores=spills))
    stream = torch.cuda.current_stream(device).cuda_stream
    order = list(libs) + list(libs)[::-1]
    for row in rows:
        occ = occupancy(libs[row["name"]], 41)
        row.update(smem_bytes_k41=occ["smem_bytes"], blocks_per_sm_k41=occ["blocks_per_sm"], bitwise_first=True,
                   bitwise_shapes=[])
    for B, K in SHAPES:
        for kind in ("bench", "steps"):
            p = problem(kind, B, K, device)
            args = (p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
            first = asm.run(libs[order[0]], *args, stream=stream)
            for row in rows:
                out = asm.run(libs[row["name"]], *args, stream=stream)
                same = all(torch.equal(a, b) for a, b in zip(first, out))
                row["bitwise_first"] = row["bitwise_first"] and same
                row["bitwise_shapes"].append(dict(kind=kind, B=B, K=K, equal=same))
                del out
            del first, p, args
            torch.cuda.empty_cache()
    for B, K in TIMED:
        p = problem("bench", B, K, device)
        args = (p["x"], p["specs"], p["terrain"], p["cfg"], p["aux"], p["slope"])
        times = {}
        for name in order:
            launch = asm.prepare(libs[name], *args)[0]
            times.setdefault(name, []).append(kit.event_ms(lambda: launch(stream), 10))
            del launch
        for row in rows:
            row[f"ms_{B}x{K}"] = times[row["name"]]
        torch.cuda.empty_cache()
    for row in rows:
        print(f"# version {row['name']} ({row['source']}): {row['registers']} registers, {row['spill_stores']} B "
              f"spill stores, K=41: {row['smem_bytes_k41']} B shared memory per block, {row['blocks_per_sm_k41']} "
              f"blocks per SM; bit for bit the first at {len(row['bitwise_shapes'])} shapes and iterates "
              f"{row['bitwise_first']}; ms per launch in turns "
              + ", ".join(f"(B={B}, K={K}) {[round(t, 3) for t in row[f'ms_{B}x{K}']]}" for B, K in TIMED),
              flush=True)
    return rows


def occupancy(lib, K: int) -> dict:
    """Shared memory per block and blocks per SM of the kernel in `lib` for
    windows of K knots."""
    return dict(smem_bytes=lib.assemble_smem_bytes(K), blocks_per_sm=lib.assemble_blocks_per_sm(K))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=[f"{B}x{K}" for B, K in SHAPES])
    ap.add_argument("--versions", nargs="+", default=None, metavar="NAME=PATH[!REGEX[!TEXT]]")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("check_assemble needs a CUDA card: the kernel has no CPU mode")
    print(kit.card(("name", "power.limit", "clocks.sm")), flush=True)
    if args.versions:
        rows = versions(args.versions, dev)
        print(json.dumps({"check_assemble_versions": rows}), flush=True)
        return 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        asm.build(verbose=True)
    regs, spills = ptxas_registers(buf.getvalue(), "assemble_kernel")
    print(buf.getvalue().rstrip(), flush=True)
    occ = occupancy(asm.KERNEL.load(), 41)
    print(f"# assemble_kernel: {regs} registers, {spills} B spill stores; K=41: {occ['smem_bytes']} B shared memory "
          f"per block, {occ['blocks_per_sm']} blocks per SM", flush=True)
    rows = []
    for shape in args.shapes:
        B, K = (int(v) for v in shape.split("x"))
        for kind in ("bench", "steps"):
            rows.append(compare(kind, B, K, dev, timed=kind == "bench" and (B, K) in TIMED))
            print("# " + describe(rows[-1]), flush=True)
    print(json.dumps({"check_assemble": rows, "registers": regs, "spill_stores": spills, **occ}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
