#!/usr/bin/env python3
"""Smoke run of qtos_torch on one CUDA card: builds the kernel from the
checkout, holds it against its plain PyTorch version, drives the batched
gait-NLP solve at bench width, and checks the results.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/btd.cu with nvcc for sm_90a;
  3. kernel vs plain version on random SPD systems (the shapes of the
     tests, and B=8192, K=41, n=36) and on a Levenberg-Marquardt system of
     the main path; times of the kernel, the plain version, the library
     Thomas loop, and the bound;
  4. the main path: solve_batch on the bench distribution (plane x3, K=41,
     goals 0.3..0.8, max_iters=3, rescue_iters=12) at B=1024 and B=8192,
     with the kernel's launch counter, convergence and the 1 kHz table;
  5. the port on CUDA against the port on CPU at B=64, K=41.
The second-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor-core f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KERNEL_ATOL = 5e-4          # random diagonally dominant systems, O(1) solutions
SHAPES = [(3, 7, 12), (2, 5, 36), (1, 9, 5), (5, 4, 6), (8192, 41, 36)]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")

    import qtos_torch  # noqa: F401  (sets TF32 off)
    from qtos_torch.ops import btd as btd_mod
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
    from qtos_torch.solver.assemble import assemble
    from qtos_torch.solver.spec import index_spec
    from qtos_torch.solver.transcription import initial_guess, knot_aux
    from qtos_torch.terrain import make_terrain

    dev = torch.device("cuda")

    # ---- 1. card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    path = btd_mod.build(verbose=True)
    log(f"# phase 2 build: {path} in {time.time() - t0:.1f} s")

    # ---- 3. kernel vs plain ----------------------------------------------
    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def library_thomas(D, L, b):
        """Block Thomas over torch.linalg.cholesky / torch.cholesky_solve:
        the library yardstick (the port never calls it)."""
        K = D.shape[1]
        Cs, ys = [torch.linalg.cholesky(D[:, 0])], [b[:, 0, :, None]]
        for k in range(1, K):
            Lk = L[:, k - 1]
            Wt = torch.cholesky_solve(Lk.transpose(-1, -2), Cs[-1])
            u = torch.cholesky_solve(ys[-1], Cs[-1])
            ys.append(b[:, k, :, None] - Lk @ u)
            Cs.append(torch.linalg.cholesky(D[:, k] - Lk @ Wt))
        xs = [None] * K
        xn = torch.cholesky_solve(ys[-1], Cs[-1])
        xs[-1] = xn
        for k in range(K - 2, -1, -1):
            xn = torch.cholesky_solve(ys[k] - L[:, k].transpose(-1, -2) @ xn, Cs[k])
            xs[k] = xn
        return torch.stack(xs, 1)[..., 0]

    def bound(B, K, n):
        nbytes = 4 * (B * K * n * n + B * (K - 1) * n * n + 2 * B * K * n)
        per = (K * (n**3 / 3 + 4 * n * n)               # Cholesky + two vector solves
               + (K - 1) * ((n + 1) * n * n              # M C^T = L and C z = y
                            + n * n * (n + 1)            # S_k = D_k - M M^T (lower)
                            + 4 * n * n))                # M z and L^T x
        flops = B * per
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops

    def spd_system(B, K, n, seed):
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        A = torch.randn((B, K, n, n), generator=gen, device=dev)
        D = (A @ A.transpose(-1, -2) + (n + 8) * torch.eye(n, device=dev)).contiguous()
        del A
        L = (0.3 * torch.randn((B, K - 1, n, n), generator=gen, device=dev)).contiguous()
        xt = torch.randn((B, K, n), generator=gen, device=dev)
        return D, L, block_tridiag_matvec(D, L, xt).contiguous(), xt

    def rel_residual(D, L, x, b):
        return float(torch.linalg.norm(block_tridiag_matvec(D, L, x) - b) / torch.linalg.norm(b))

    t0 = time.time()
    kernel_row = None
    max_err_all = 0.0
    for i, (B, K, n) in enumerate(SHAPES):
        D, L, b, xt = spd_system(B, K, n, i)
        x = btd_solve(D, L, b)
        torch.cuda.synchronize()
        xp = block_tridiag_solve(D, L, b)
        torch.cuda.synchronize()
        err = float((x - xp).abs().max())
        err_true = float((x - xt).abs().max())
        res = rel_residual(D, L, x, b)
        max_err_all = max(max_err_all, err)
        line = (f"# phase 3 kernel vs plain B={B} K={K} n={n}: max_abs_err {err:.3e} "
                f"(vs true x {err_true:.3e}), |Hx-b|/|b| {res:.3e}")
        if not (math.isfinite(err) and err <= KERNEL_ATOL and err_true <= KERNEL_ATOL):
            fail(line + f" exceeds atol {KERNEL_ATOL}")
        if (B, K, n) == (8192, 41, 36):
            ms = event_ms(lambda: btd_solve(D, L, b), 10)
            plain_ms = event_ms(lambda: block_tridiag_solve(D, L, b), 1)
            lib_ms = event_ms(lambda: library_thomas(D, L, b), 3)
            xl = library_thomas(D, L, b)
            bms, bby, nbytes, flops = bound(B, K, n)
            line += (f"\n# phase 3 times B={B} K={K} n={n} on {card}: kernel {ms:.3f} ms, "
                     f"plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms "
                     f"(library vs true x {float((xl - xt).abs().max()):.3e}), "
                     f"bound {bms:.3f} ms by {bby} ({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)")
            kernel_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=bby)
        log(line)
        del D, L, b, xt, x, xp
    torch.cuda.empty_cache()

    # An LM system of the main path: first-iteration system at the bench
    # distribution, damped as solve_batch damps it.
    terrain = make_terrain(["plane"] * 3)
    cfg = SolverConfig(max_iters=3, rescue_iters=12)
    K = 41
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, 8192, device=dev), 0.0), K=K)
    x0 = initial_guess(specs, terrain, cfg)
    Dm, Lm, gm, _ = assemble(x0, specs, terrain, cfg, knot_aux(specs, terrain, cfg))
    lm = cfg.lm_init * cfg.lm_down
    Dm = Dm + torch.diag_embed(lm * torch.diagonal(Dm, dim1=-2, dim2=-1) + 1e-8)
    bm = -gm
    xk = btd_solve(Dm, Lm, bm)
    xp = block_tridiag_solve(Dm, Lm, bm)
    torch.cuda.synchronize()
    scale = float(xp.abs().max())
    err = float((xk - xp).abs().max())
    res_k, res_p = rel_residual(Dm, Lm, xk, bm), rel_residual(Dm, Lm, xp, bm)
    line = (f"# phase 3 kernel vs plain on the main path's LM system (B=8192, K=41): "
            f"max_abs_err {err:.3e} of max|x| {scale:.3e}; |Hx-b|/|b| kernel {res_k:.3e}, plain {res_p:.3e}")
    # These LM systems are badly conditioned (weights up to 60, damping
    # 7.5e-5): two correct float32 solvers differ by ~cond * 1e-7 relative,
    # measured 2.2e-3 of max|x| on an H100.  So the kernel is held to the
    # plain version at 1e-2 of max|x|, and its residual to the plain one's.
    if not (math.isfinite(err) and err <= 1e-2 * scale and res_k <= max(2 * res_p, 1e-5)):
        fail(line)
    log(line)
    del Dm, Lm, gm, bm, xk, xp, x0
    torch.cuda.empty_cache()
    log(f"# phase 3 done in {time.time() - t0:.1f} s")

    # ---- 4. main path ----------------------------------------------------
    t0 = time.time()
    main_launches = None
    for B in (1024, 8192):
        goals = torch.linspace(0.3, 0.8, B, device=dev)
        specs = default_spec(terrain, goal_xy=(goals, 0.0), K=K)
        res = solve_batch(specs, terrain, cfg)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        btd_solve.launches = 0
        t1 = time.perf_counter()
        res = solve_batch(specs, terrain, cfg)
        n_conv = int((res.status == 0).sum())               # host read ends the timing
        dt = time.perf_counter() - t1
        launches = btd_solve.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"# phase 4 B={B}: {dt:.3f} s -> {B / dt:.1f} solves/s ({n_conv}/{B} converged), "
            f"btd launches {launches}, max violation {float(res.max_violation.max()):.3e}, "
            f"peak memory {peak:.2f} GiB on {card}")
        if launches < cfg.max_iters:
            fail(f"the main path launched the kernel {launches} times, < max_iters {cfg.max_iters}")
        if n_conv != B:
            fail(f"{B - n_conv}/{B} scenarios did not converge")
        if not bool(torch.isfinite(res.x).all()):
            fail("non-finite solution")
        table, contact = sample_trajectory(res.x[0], index_spec(specs, 0))
        if tuple(table.shape) != (2501, 37) or not bool(torch.isfinite(table).all()):
            fail(f"sample_trajectory gave {tuple(table.shape)}, finite={bool(torch.isfinite(table).all())}")
        main_launches = launches

    # where the time goes at B=8192: one assembly and one solve
    x0 = initial_guess(specs, terrain, cfg)
    aux = knot_aux(specs, terrain, cfg)
    asm_ms = event_ms(lambda: assemble(x0, specs, terrain, cfg, aux), 3)
    Dm, Lm, gm, _ = assemble(x0, specs, terrain, cfg, aux)
    before = btd_solve.launches
    solve_ms = event_ms(lambda: btd_solve(Dm, Lm, gm), 3)
    btd_solve.launches = before
    log(f"# phase 4 breakdown B=8192: assemble {asm_ms:.3f} ms, btd_solve {solve_ms:.3f} ms per iteration")
    del Dm, Lm, gm
    torch.cuda.empty_cache()
    log(f"# phase 4 done in {time.time() - t0:.1f} s")

    # ---- 5. CUDA vs CPU --------------------------------------------------
    t0 = time.time()
    B = 64
    goals_np = np.linspace(0.3, 0.8, B).astype(np.float32)
    out = {}
    for d in ("cuda", "cpu"):
        terr_d = make_terrain(["plane"] * 3, device=d)
        specs_d = default_spec(terr_d, goal_xy=(goals_np, 0.0), K=K, device=d)
        r = solve_batch(specs_d, terr_d, cfg)
        out[d] = (r.status.cpu().numpy(), r.x.cpu().numpy())
    same = bool((out["cuda"][0] == out["cpu"][0]).all())
    xdiff = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    line = f"# phase 5 CUDA vs CPU B={B} K={K}: statuses equal {same}, max |dx| {xdiff:.3e}"
    if not (same and xdiff <= 5e-3):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")

    # ---- result lines ----------------------------------------------------
    row = dict(
        name="btd",
        route="cuda",
        source="qtos_torch/csrc/btd.cu",
        replaces="qtos_tpu/ops/pallas/btd.py:153 (_btd_kernel)",
        launches=main_launches,
        max_abs_err=max_err_all,
        max_err=max_err_all,
        **kernel_row,
    )
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
