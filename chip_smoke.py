#!/usr/bin/env python3
"""Smoke run of qtos_torch on one CUDA card: builds its kernels from the
checkout (the BTD solve's two, the tick's and the assembly's), holds each
against its plain PyTorch version, drives the batched
gait-NLP solve at bench width, plays solved trajectories through the physics,
probes a feasibility map and plans over it, walks the exp_1 preset to its goal
with the receding-horizon runner, paces a walk in real time, and checks the
results.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/btd.cu, csrc/tick.cu, csrc/assemble.cu, csrc/lm_restore.cu
     and the tick's latency probe (tools/op_cycles.cu) with nvcc for sm_90a,
     one nvcc each, all at once (ptxas report: registers, spills);
  3. BTD kernel vs plain version on random SPD systems (the shapes of the
     tests and those of the driven paths: B=1, K=33; B=20, K=25; B=1, B=4,
     B=64, B=1024 and B=8192, K=41; B=3 and B=512, K=13; n=36) and on a
     Levenberg-Marquardt system of the main path; times of the kernel, the
     plain version, the library Thomas loop (over torch.linalg.cholesky and
     over cholesky_ex, each call's time), and the bound at B=8192, and of
     the kernel on inputs packed once, the wrapper's call, the plain version,
     the library loop over cholesky_ex, the dense system's cholesky_ex and
     cholesky_solve, and the bound at (4, 41, 36) and (1, 41, 36), the
     library calls held to the plain version; the kernel's GB/s against the bound's bytes
     and against the bytes its design moves, its GFLOP/s, registers, shared
     memory per block and resident warps per SM; the small-batch kernel
     (btd_small_kernel, the same source) at every shape btd_pick_small
     gives it, held to the plain version and to btd_kernel bit for bit, its
     times at (4, 41, 36) and (1, 41, 36) in turns with btd_kernel's and
     beside the dense library call's, its design floor
     (tools/btd_floor.py), and both kernels at B = 1 .. 396 for the
     crossover; at every shape the solve damped by lm (the LM loop's
     damping, added by the kernel) held bit for bit to the undamped solve of
     the damped copy D + diag_embed(lm * diag(D) + 1e-8), D left as it was
     and each damped call counted in btd_solve.damped_launches, and its
     times beside the undamped ones at (8192, 41, 36), (4, 41, 36) and
     (1, 41, 36);
  3b. the assembly kernel vs its plain version (tools/check_assemble.py) at
     every shape a path gives it ((1, 33), (4, 41), (20, 25), (64, 41),
     (1024, 41), (8192, 41), (3, 13), (512, 13), (1, 41)) on the bench
     distribution's first iterate and on a perturbed iterate over step
     terrain with every hinge family active, two launches bit for bit;
     kernel, plain and bound ms at (1, 41), (4, 41), (1024, 41) and
     (8192, 41), its design's floor
     (tools/assemble_floor.py), registers, spills, shared memory and blocks
     per SM, beside the first design's recorded numbers;
  3c. the LM restore kernel vs its plain version and torch.where
     (tools/check_restore.py) at (8192, 41), (4, 41) and (1, 41), every
     step accepted, every one rejected, a mix, and the mix with no kept
     system (zero fill), bit for bit; kernel, plain, torch.where and bound
     ms, and the host time of one call at B=4;
  4. the main path: solve_batch on the bench distribution (plane x3, K=41,
     goals 0.3..0.8, max_iters=3, rescue_iters=12) at B=1024 and B=8192,
     timed by bench_torch.time_solves (a warm-up, then 5 calls: min / median
     / max), with the solver kernels' launch counters in each call (one
     launch each of the BTD, assembly and LM restore kernels per LM
     iteration), convergence and the 1 kHz table;
  5. the port on CUDA against the port on CPU at B=64, K=41;
  6. physics playback, through the tick kernel: (a) the library quick start
     (plan, solve, sample, 500 warm-up ticks, 1 kHz playback) on the card;
     (b) 256 episodes of phase 4's B=1024 result played in one batched call,
     with wall time, ms per tick and episode-ticks per second; (c) 4 of
     those episodes, 500 ticks, on the card against the CPU;
     (d) exp_2's first riser: one window over step_2's riser, solved on the
     CPU, played on the card and on the CPU from the same table and start
     state in lock step with the plain tick: the first tick and leaf at
     which they part, and how far apart they end;
     (e) the tick kernel against its plain version: B=1 and B=256 over 6b's
     2,501-tick tables, both on the card, with ms per tick of each; the
     kernel on the card against the plain loop on the CPU over 6d's window;
     the kernel's device launches per playback, playback_recorded and
     stance_warmup call, and the assembly kernel's per solve_batch call,
     counted in a torch.profiler trace of each (in a process of its own:
     `python3 chip_smoke.py --device-launches`); the
     kernel's bound, and its design's floor from the latencies of the
     operations on the chain's loop-carried cycles, probed on the card;
  7. planner: the solver-probed feasibility map of the pillar tile (one
     solve_batch over every candidate hop, K=25), the kernels' launches (the
     BTD solve's on the kernel btd_pick_small picks for its batch) and the
     failed hops, then A* and the global planner over that map;
  8. the receding-horizon runner: one replan timed alone (5 calls; its BTD solves all
     on the small-batch kernel, its results equal bit for bit to those by
     btd_kernel), the exp_1 preset walked to its goal (the same kernel), a
     two-window checkpoint restored bit for bit, and
     (d) `qtos_tpu`'s real-time canary walk (plane x2 to (0.8, 0),
     `realtime=True`, 6 windows) paced at 1 kHz;
  9. scenario sharding: solve_batch_sharded under NCCL at world size 1 on
     the bench distribution at B=1024, equal bit for bit to solve_batch,
     its gathered statuses equal to the local ones, and the kernel's
     launches; over two ranks with an uneven batch when the host has two
     cards;
  10. the TOWR-window entry point (scripts/towr_deviation_torch.py's
     `measure`) on the card and on the CPU, from a golden written here (one
     converged window of phase 4, sampled at 1 kHz): statuses, card vs CPU
     deviation figures, ms per call, and one launch of each solver kernel
     per LM iteration (120; the BTD solve's on the small-batch kernel, the
     card's figures equal bit for bit to those by btd_kernel);
  11. the benchmark: `python3 bench_torch.py` in a child process at its
     default sizes; its exit code, convergence, launches and last line
     (bench.py's four keys).
Phase 4 also profiles one solve_batch call at B=8192 (kernel time by name,
the BTD kernel's and assembly's shares, the device's idle share).
The second-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

from qtos_torch.ops.cuda_lib import ptxas_registers
from qtos_torch.tools import kit


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor-core f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KERNEL_ATOL = 5e-4          # random diagonally dominant systems, O(1) solutions
# The shapes of the tests, then those the driven paths give the kernel: the
# quick start's single K=33 window (phase 6a), the feasibility probe's 20 K=25
# windows (phase 7; its rescue pass gathers all 20), the runner's 4 candidate
# windows per replan (phase 8), phase 5's B=64, the ranks' slices of phase 9's
# two-card run (B=5 and 1023 over two ranks, K=13: 3 and 512 each), phase 4's
# and phase 9's B=1024, the bench batch (phase 4), which is timed, and the
# TOWR window's single K=41 system (phase 10).
SHAPES = [(3, 7, 12), (2, 5, 36), (1, 9, 5), (5, 4, 6), (1, 33, 36), (20, 25, 36), (4, 41, 36),
          (64, 41, 36), (3, 13, 36), (512, 13, 36), (1024, 41, 36), (8192, 41, 36), (1, 41, 36)]
# The small shapes timed besides the bench batch: a replan's (phase 8) and the
# TOWR window's (phase 10).
SMALL_TIMED = [(4, 41, 36), (1, 41, 36)]
# Batches at which both BTD kernels are timed for the crossover (K=41, n=36).
CROSSOVER_BATCHES = (1, 2, 4, 20, 64, 132, 264, 265, 396)


def _asm_launches() -> int:
    """The assembly kernel's launches since its count was last set to 0."""
    from qtos_torch.ops.assemble import assemble_kernel

    return assemble_kernel.launches


def _restore_launches() -> int:
    """The LM restore kernel's launches since its count was last set to 0."""
    from qtos_torch.ops.lm_restore import restore_rejected

    return restore_rejected.launches


def _zero_solver_counts():
    """Sets the BTD, assembly and LM restore kernels' counts to 0: one LM
    iteration launches each once (the BTD solve's btd_kernel or its
    small-batch kernel)."""
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.ops.lm_restore import restore_rejected

    btd_solve.launches = btd_solve.small_launches = assemble_kernel.launches = restore_rejected.launches = 0


@contextlib.contextmanager
def _warp_kernel_only():
    """btd_solve on btd_kernel at every batch while inside: a path's results
    by the small-batch kernel are held to btd_kernel's with it (a device of
    this script's, not an option of the port).  The replans inside start
    from an empty graph cache, so they run the patched path and do not
    replay a graph captured on the small kernel."""
    from qtos_torch.control import replan
    from qtos_torch.control.graphs import GraphCache
    from qtos_torch.ops import btd

    picks, graphs = btd.picks_small, replan._GRAPHS
    btd.picks_small = lambda B, K, n: False
    replan._GRAPHS = GraphCache(graphs.size)
    try:
        yield
    finally:
        btd.picks_small, replan._GRAPHS = picks, graphs


def _zero_tick_counts():
    from qtos_torch.ops.tick import tick_hold, tick_scan

    tick_scan.launches = tick_hold.launches = 0


def _replan_inputs(terrain, k, dev) -> tuple:
    """(rows, goals, goal yaws) of phase 8a's replan: k standing start rows on
    `terrain` and goals 0.55, 0.50, ... m ahead of them."""
    import torch

    from qtos_torch.solver.spec import RobotState

    st = RobotState.standing((torch.zeros(k, device=dev), torch.zeros(k, device=dev)), terrain=terrain, device=dev)
    zeros = torch.zeros((k, 12), device=dev)
    rows = torch.cat([zeros[:, :1], st.r, st.eul, st.feet.reshape(k, 12), st.v, st.omega, zeros], dim=-1)
    goals = st.r + torch.stack([0.55 - 0.05 * torch.arange(k, device=dev),
                                torch.zeros(k, device=dev), torch.zeros(k, device=dev)], dim=-1)
    return rows, goals, torch.zeros(k, device=dev)


def count_device_launches() -> None:
    """`python3 chip_smoke.py --device-launches`, which phase 6e runs in a
    process of its own: one call each of `playback`, `playback_recorded` and
    `stance_warmup` on 8 solved trot windows (plane x3, K=41), each under
    `torch.profiler`, and one JSON line with the device launches of
    `tick_kernel` in each call's trace and the trace's device events; and
    one `solve_batch` call on those windows (the bench distribution at B=8),
    with the device launches of `assemble_kernel` and of the BTD solve's
    kernels (`btd_kernel`, `btd_small_kernel`, which takes B=8) in its
    trace beside the wrappers' counts; and one replayed `plan_windows_batch`
    call at phase 8a's shape (exp_1, after an eager call and a capture),
    with the device launches of the BTD, assembly and LM restore kernels in
    its trace beside what the replay added to the wrappers' counts, which is
    what its capture counted.  (In
    the smoke's own process, after phase 4's profile, later traces held no
    device events at all; a fresh process records them.)"""
    import torch

    from qtos_torch.builder import build
    from qtos_torch.control.loop import gait_control_params, playback, playback_recorded, stance_warmup, state_from_row
    from qtos_torch.control.replan import plan_windows_batch
    from qtos_torch.ops.assemble import assemble_kernel
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.ops.lm_restore import restore_rejected
    from qtos_torch.ops.tick import tick_hold, tick_scan
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
    from qtos_torch.terrain import make_terrain

    dev = torch.device("cuda")
    terrain = make_terrain(["plane"] * 3)
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, 8, device=dev), 0.0), K=41)
    cfg = SolverConfig(max_iters=3, rescue_iters=12)
    tables = sample_trajectory(solve_batch(specs, terrain, cfg).x, specs)[0]
    tables = tables.contiguous()
    params = gait_control_params("trot")
    s0 = stance_warmup(state_from_row(tables[:, 0], terrain, params), terrain, params, 100)
    playback(tables, s0, terrain, params)                 # the library is loaded and warm
    calls = dict(playback=lambda: playback(tables, s0, terrain, params),
                 playback_recorded=lambda: playback_recorded(tables, s0, terrain, params),
                 stance_warmup=lambda: stance_warmup(s0, terrain, params, 100))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, fn in calls.items():
        tick_scan.launches = tick_hold.launches = 0
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = dict(device=sum("tick_kernel" in n for n in names), events=len(names),
                         wrapper=tick_scan.launches + tick_hold.launches)
    btd_solve.launches = btd_solve.small_launches = assemble_kernel.launches = 0
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        solve_batch(specs, terrain, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["solve_batch"] = dict(device=sum("assemble_kernel" in n for n in names), events=len(names),
                              wrapper=assemble_kernel.launches, btd_device=sum("btd_kernel" in n for n in names),
                              small_device=sum("btd_small_kernel" in n for n in names),
                              btd_wrapper=btd_solve.launches, small_wrapper=btd_solve.small_launches)
    bundle = build("exp_1", device=dev)
    rcfg, rterrain = bundle.runner.cfg, bundle.terrain
    args = (*_replan_inputs(rterrain, rcfg.n_candidates, dev), rterrain, rcfg)
    plan_windows_batch(*args)                             # the key's first call: eager
    plan_windows_batch(*args)                             # its second: captured, then replayed
    replays = plan_windows_batch.replays
    btd_solve.launches = btd_solve.small_launches = assemble_kernel.launches = restore_rejected.launches = 0
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        plan_windows_batch(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["replan"] = dict(replayed=plan_windows_batch.replays - replays, k=rcfg.n_candidates, K=rcfg.K,
                         iters=rcfg.solver.max_iters, events=len(names),
                         btd_device=sum("btd_kernel" in n for n in names),
                         small_device=sum("btd_small_kernel" in n for n in names),
                         asm_device=sum("assemble_kernel" in n for n in names),
                         restore_device=sum("lm_restore_kernel" in n for n in names),
                         btd_wrapper=btd_solve.launches, small_wrapper=btd_solve.small_launches,
                         asm_wrapper=assemble_kernel.launches, restore_wrapper=restore_rejected.launches)
    print(json.dumps(out), flush=True)


def _tick_counts() -> tuple:
    """(playback launches, hold launches) of the tick kernel."""
    from qtos_torch.ops.tick import tick_hold, tick_scan

    return tick_scan.launches, tick_hold.launches


def phase_playback(dev, card, terrain, x, specs, warmup=500, compare_ticks=500) -> dict:
    """Phase 6 (a-c).  `x` (B, K, NV) and `specs` are solved windows on
    `terrain` (phase 4's, every fourth scenario).  Returns 6b's tables,
    warmed-up start states and kernel launches for phase 6e."""
    import torch

    from qtos_torch.control import ControlParams, playback, stance_warmup
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve
    from qtos_torch.solver.spec import map_tensors
    from qtos_torch.terrain import make_terrain

    params = ControlParams()

    on_card = dev.type == "cuda"          # main() always passes the card

    def episode(tables, terr):
        """Warm-up and playback, each one launch of the tick kernel on the
        card; (final, metrics, warm-up s, playback s, start state)."""
        _zero_tick_counts()
        t0 = kit.synced(tables.device)
        s0 = stance_warmup(state_from_row(tables[..., 0, :], terr, params), terr, params, warmup)
        t1 = kit.synced(tables.device)
        final, m = playback(tables, s0, terr, params)
        t2 = kit.synced(tables.device)
        if tables.device.type == "cuda" and _tick_counts() != (1, 1):
            fail(f"phase 6: warm-up and playback launched the tick kernel {_tick_counts()} times, not (1, 1)")
        return final, m, t1 - t0, t2 - t1, s0

    # 6a: the library quick start
    t0 = time.time()
    terr2 = make_terrain(["plane", "plane"], device=dev)
    spec = default_spec(terr2, goal_xy=(0.5, 0.0), K=33, device=dev)
    _zero_solver_counts()
    res = solve(spec, terr2, SolverConfig(max_iters=30))
    launches, iters, asm_launches = btd_solve.launches, int(res.iters.max()), _asm_launches()
    restore_launches = _restore_launches()
    if dev.type == "cuda" and not launches == asm_launches == restore_launches >= iters:  # main() passes the card
        fail(f"phase 6a: the quick start's solve launched the BTD, assembly and LM restore kernels {launches}, "
             f"{asm_launches} and {restore_launches} times in {iters} iterations")
    status = int(res.status)
    table, _ = sample_trajectory(res.x, spec)
    final, m, warm_s, play_s, _ = episode(table, terr2)
    T1 = table.shape[0]
    ms_tick_1 = play_s / T1 * 1e3
    plan_end = table[-1, 1:4].cpu()
    pos = final.pos.cpu()
    err_s = float(m.avg_com_err_per_s)
    line = (f"# phase 6a quick start (K=33, {T1} rows): status {status}, btd, assembly and LM restore launches "
            f"{launches}, {asm_launches} and {restore_launches} in "
            f"{iters} iterations, avg_com_err_per_s {err_s:.2f}, "
            f"final pos ({pos[0]:.4f}, {pos[1]:.4f}, {pos[2]:.4f}) vs plan end "
            f"({plan_end[0]:.4f}, {plan_end[1]:.4f}, {plan_end[2]:.4f}); warm-up {warmup} ticks "
            f"{warm_s:.3f} s, playback {play_s:.3f} s = {ms_tick_1:.4f} ms per tick at B=1 on {card}; tick kernel "
            f"launches (playback, hold) {_tick_counts() if on_card else 'none: the CPU runs the plain loop'}")
    if not (status == 0 and err_s < 60.0 and abs(float(pos[0] - plan_end[0])) < 0.12
            and abs(float(pos[2] - plan_end[2])) < 0.03):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")

    # 6b: full width, B episodes in one batched call
    t0 = time.time()
    B = x.shape[0]
    tables, _ = sample_trajectory(x, specs)
    tables = tables.contiguous()
    T = tables.shape[1]
    final, m, warm_s, play_s, s0_b = episode(tables, terrain)
    counts_b = _tick_counts()
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (m.com_err, m.ee_err, m.pos, m.feet, m.yaw, final.pos, final.q, final.qd))
    goal_x = specs.goal_r[:, 0]
    z_ok = bool(((final.pos[:, 2] > 0.1) & (final.pos[:, 2] < 0.4)).all())
    x_ok = bool((final.pos[:, 0] > 0.5 * goal_x).all())
    mean_err = m.com_err.mean(dim=-1)
    ms_tick = play_s / T * 1e3
    line = (f"# phase 6b playback B={B} (K={x.shape[1]}, tables {tuple(tables.shape)}): warm-up {warmup} ticks "
            f"{warm_s:.3f} s, playback {play_s:.3f} s = {ms_tick:.4f} ms per tick, "
            f"{B * T / play_s:.0f} episode-ticks/s (B=1: {ms_tick_1:.4f} ms per tick) on {card}; "
            f"finite {finite}, final z in [{float(final.pos[:, 2].min()):.3f}, {float(final.pos[:, 2].max()):.3f}], "
            f"min final x / goal {float((final.pos[:, 0] / goal_x).min()):.3f}, "
            f"mean com_err max {float(mean_err.max()):.4f} m, "
            f"avg_com_err_per_s in [{float(m.avg_com_err_per_s.min()):.2f}, {float(m.avg_com_err_per_s.max()):.2f}]")
    if not (finite and z_ok and x_ok and bool((mean_err < 0.15).all())):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")

    # 6c: the card against the CPU on 4 of those episodes
    t0 = time.time()
    short = tables[:4, :compare_ticks].contiguous()
    cpu_terr = map_tensors(terrain, lambda t: t.cpu())
    f_dev, m_dev, *_ = episode(short, terrain)
    f_cpu, m_cpu, *_ = episode(short.cpu(), cpu_terr)
    dpos = float((f_dev.pos.cpu() - f_cpu.pos).abs().max())
    dq = float((f_dev.q.cpu() - f_cpu.q).abs().max())
    rel = float(((m_dev.avg_com_err_per_s.cpu() - m_cpu.avg_com_err_per_s).abs()
                 / m_cpu.avg_com_err_per_s).max())
    line = (f"# phase 6c CUDA (tick kernel) vs CPU (plain loop), 4 episodes, {warmup} warm-up + {short.shape[1]} "
            f"ticks: max |dpos| {dpos:.3e} m, "
            f"max |dq| {dq:.3e} rad, avg_com_err_per_s differs by {100 * rel:.3f} %")
    # The card runs the tick kernel and the CPU the plain loop, the same
    # float32 operations in the same order; on flat ground every run of the
    # plain loop on an H100 against the CPU gave 4.5e-7 m, 2.2e-6 rad and
    # 0.001 %.  The gates leave two orders of magnitude above that for other
    # cards and library versions.
    if not (dpos <= 1e-4 and dq <= 5e-4 and rel <= 0.005):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")
    return {"tables": tables, "s0": s0_b, "terrain": terrain, "launches": counts_b,
            "restore_quick_start": restore_launches}


# Phase 6d's gates: card against CPU over exp_2's first riser.  On an H100 the
# position and contact leaves agreed to 1e-6 until tick 562 (the first
# touchdown after a front foot has borne load on the riser's ramp) and ended
# 7.9e-3 m and 2.65e-2 rad apart after the window's 2,501 ticks, where flat
# ground holds 4.5e-7 m (6c).  The gates leave a margin of ~5x at the end and
# require agreement until the feet reach the riser.
RISER_DPOS, RISER_DQ, RISER_FIRST_TICK = 4e-2, 0.15, 400


def phase_riser(dev, card, ticks=None) -> tuple:
    """Phase 6d.  The window is solved and warmed up on the CPU and copied
    to the card bit for bit, so only the playback differs.  Both devices
    step the plain tick (`riser.divergence`).  Returns the window (terrain,
    table, start state on the CPU) for phase 6e."""
    from qtos_torch.tools import riser

    t0 = time.time()
    terrain, table, status, s0 = riser.riser_window("cpu")
    rep = riser.divergence(table, s0, terrain, dev, ticks=ticks)
    leaves = ", ".join(f"{k} {v['first_tick']} / {v['max_abs_diff']:.2e}" for k, v in rep["leaves"].items())
    line = (f"# phase 6d exp_2's first riser (window solved on the CPU from x {riser.START_X} to "
            f"{riser.START_X + riser.GOAL_DX:g}, status {status}; {rep['ticks']} ticks on {card} against the CPU "
            f"from one table and start state): first tick past {rep['threshold']:g}: {rep['first_tick']}, "
            f"leaf {rep['first_leaf']}; of the position and contact leaves: {rep['first_position_tick']}; "
            f"per leaf, first tick / largest |diff|: {leaves}; at the end "
            f"|dpos| {rep['final_dpos']:.3e} m, |dq| {rep['final_dq']:.3e} rad, x {rep['final_x'][1]:.4f} on the "
            f"card, {rep['final_x'][0]:.4f} on the CPU")
    first = rep["first_position_tick"]
    if not (status == 0 and rep["final_dpos"] <= RISER_DPOS and rep["final_dq"] <= RISER_DQ
            and (first is None or first >= RISER_FIRST_TICK)):
        fail(line + f" (gates: |dpos| <= {RISER_DPOS} m, |dq| <= {RISER_DQ} rad, position leaves agree "
                    f"until tick {RISER_FIRST_TICK})")
    log(line + f" ({time.time() - t0:.1f} s)")
    return terrain, table, s0


# Phase 6e's gates on flat ground: 6c's (|dpos| m, |dq| rad, relative
# avg_com_err_per_s) over 6c's 500 ticks of playback.  Past ~500 ticks two
# float32 versions of the loop part as the gait starts: on an H100 the plain
# loop on the card and on the CPU ended 6b's 2,501 ticks 4.4e-2 m apart at
# worst over 256 episodes, the kernel and the card's plain loop 3.5e-2 m.  So
# over the whole table the kernel is held to 6c's gates or to twice what the
# two plain loops differ by on the same inputs, whichever is larger.
FLAT_GATES = (1e-4, 5e-4, 0.005)
COMPARE_TICKS = 500

# The one-thread-per-episode tick kernel (before the table passes and the
# legs on lanes), as recorded on an H100 at 700 W: us per tick at B=1 and
# B=256 over the smoke runs, registers and spill stores.
TICK_BEFORE = "45.2-45.6 / 47.2-49.0 us per tick at B=1 / B=256, 255 registers, 132 B spill stores"
# The assembly kernel's first design (one warp per knot), as recorded on an
# H100 at 700 W in turns with its redesign: ms per launch at (8192, 41),
# (1024, 41) and (4, 41) (launches on inputs packed once), registers and
# spill stores.
ASM_BEFORE = "9.25-9.31 / 1.17 / 0.16 ms at (8192, 41) / (1024, 41) / (4, 41), 128 registers, 0 B spill stores"


def tick_ops_per_tick() -> int:
    """Floating-point results of one plain tick at B=1 on the CPU: the output
    elements of every aten operation `_tick` dispatches that is not a view
    (copies for `torch.stack` and `torch.cat` included)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from qtos_torch.control import ControlParams
    from qtos_torch.control.loop import _tick, plan_joint_targets, state_from_row
    from qtos_torch.terrain import make_terrain

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor) and t.is_floating_point():
                        Count.n += t.numel()
            return out

    terr = make_terrain(["plane"], device="cpu")
    params = ControlParams()
    row = torch.zeros(37)
    row[1:4] = torch.tensor([0.0, 0.0, 0.24])
    row[7:19] = torch.tensor([0.21, 0.19, 0.0, 0.21, -0.19, 0.0, -0.21, 0.19, 0.0, -0.21, -0.19, 0.0])
    row[[27, 30, 33, 36]] = 7.4
    state = state_from_row(row, terr, params)
    carry = (state, plan_joint_targets(row, params)[0], torch.zeros(4, 3), torch.zeros(3), torch.zeros(()))
    with Count():
        _tick(carry, row, terr, params)
    return Count.n


def _trace_spread(a: dict, b: dict, lead: int, n: int) -> tuple:
    """Two playbacks' traces over their first n ticks (T axis `lead`): the
    largest |dpos|, the largest |dq| and the largest relative difference of
    avg_com_err_per_s."""
    from qtos_torch.control.loop import _metrics

    a, b = ({k: v.narrow(lead, 0, n).cpu() for k, v in x.items()} for x in (a, b))
    ma, mb = _metrics(a, n), _metrics(b, n)
    rel = ((ma.avg_com_err_per_s - mb.avg_com_err_per_s).abs() / mb.avg_com_err_per_s).max()
    return float((a["pos"] - b["pos"]).abs().max()), float((a["q"] - b["q"]).abs().max()), float(rel)


def _parting(a: dict, b: dict, T: int) -> tuple:
    """Per episode the largest |dpos| over the T ticks, and the first tick
    past 1e-6: (the median of the first, the earliest of the second)."""
    import torch

    d = (a["pos"].cpu() - b["pos"].cpu()).abs().amax(dim=-1).reshape(-1, T)
    past = d > 1e-6
    first = int(torch.nonzero(past.any(dim=0))[0]) if bool(past.any()) else None
    return float(d.amax(dim=1).median()), first


def phase_tick(dev, card, played: dict, riser_window: tuple, peak_bytes, peak_flops) -> dict:
    """Phase 6e: the tick kernel against its plain version, with the
    runner's trot controller.  `played` is phase 6's 6b (tables (256, 2501,
    37) and warmed-up states), `riser_window` phase 6d's window.  Returns the
    kernel's row of the result line."""
    import dataclasses

    import torch

    from qtos_torch.control.loop import _scan_ticks, gait_control_params
    from qtos_torch.control.replan import RunnerConfig
    from qtos_torch.ops import tick as tick_mod
    from qtos_torch.ops.tick import tick_scan
    from qtos_torch.solver.spec import map_tensors
    from qtos_torch.tools import riser, tick_floor

    t0 = time.time()
    params = gait_control_params("trot")
    tables, s0 = played["tables"], played["s0"]
    ep = lambda s, i: dataclasses.replace(s, **{f.name: getattr(s, f.name)[i].contiguous()  # noqa: E731
                                                for f in dataclasses.fields(s)})
    out = {}
    max_err = 0.0
    cpu = lambda t: t.cpu()                                                  # noqa: E731
    terr_cpu = map_tensors(played["terrain"], cpu)
    for B in (1, tables.shape[0]):
        tab = tables[0] if B == 1 else tables               # B=1 is one unbatched episode, as the runner's
        st = ep(s0, 0) if B == 1 else s0
        T = tab.shape[-2]
        _zero_tick_counts()
        t1 = kit.synced(dev)
        fk, tk = tick_scan(tab, st, played["terrain"], params)
        kernel_s = kit.synced(dev) - t1
        launches = _tick_counts()
        t1 = kit.synced(dev)
        fp, tp = _scan_ticks(tab, st, played["terrain"], params)
        plain_s = kit.synced(dev) - t1
        fc, tc = _scan_ticks(tab.cpu(), map_tensors(st, cpu), terr_cpu, params)   # the yardstick of rounding
        ms = kernel_s * 1e3                 # a CPU rehearsal runs the plain loop thrice
        if dev.type == "cuda":              # main() always passes the card
            if launches != (1, 0) or _tick_counts() != (1, 0):
                fail(f"phase 6e B={B}: the kernel launched {launches} times for one call, "
                     f"{_tick_counts()} after the plain loops")
            # the kernel's time without the host's first-call work: CUDA events over 3 calls
            ms = kit.event_ms(lambda: tick_scan(tab, st, played["terrain"], params), 3)

        lead = tab.dim() - 2                               # the T axis of every trace
        early = _trace_spread(tk, tp, lead, COMPARE_TICKS)
        full_k, full_pp = _trace_spread(tk, tp, lead, T), _trace_spread(tp, tc, lead, T)
        part_k, part_pp = _parting(tk, tp, T), _parting(tp, tc, T)
        allowed = [max(g, 2 * v) for g, v in zip(FLAT_GATES, full_pp)]
        max_err = max(max_err, *early[:2])
        line = (f"# phase 6e tick kernel vs plain loop, both on the card, B={B}, {T} ticks on flat ground: first "
                f"{COMPARE_TICKS} ticks |dpos| {early[0]:.3e} m, |dq| {early[1]:.3e} rad, avg_com_err_per_s "
                f"{100 * early[2]:.4f} % apart (6c's gates {FLAT_GATES}); all {T} ticks {full_k[0]:.3e} m, "
                f"{full_k[1]:.3e} rad, {100 * full_k[2]:.4f} %, where the plain loop on the card and on the CPU are "
                f"{full_pp[0]:.3e} m, {full_pp[1]:.3e} rad, {100 * full_pp[2]:.4f} % apart (gates: the larger of 6c's and "
                f"twice that); per episode the median largest |dpos| {part_k[0]:.3e} m and the earliest tick past "
                f"1e-6 {part_k[1]} (the plain loops: {part_pp[0]:.3e} m, tick {part_pp[1]}); kernel {ms:.3f} ms per "
                f"call (CUDA events, 3 calls) = {ms / T * 1e3:.3f} us per tick ({kernel_s * 1e3:.3f} ms host clock, "
                f"first call; before the redesign {TICK_BEFORE}), plain loop {plain_s * 1e3:.1f} ms = "
                f"{plain_s / T * 1e3:.3f} ms per tick, on {card}")
        if not (all(e <= g for e, g in zip(early, FLAT_GATES)) and all(f <= g for f, g in zip(full_k, allowed))):
            fail(line)
        log(line)
        out[B] = dict(ms=ms, plain_ms=plain_s * 1e3, T=T)

    # Device launches per call of each entry point, from a profiler trace
    # of one call each (in a process of its own: `count_device_launches`):
    # the wrapper's count says how often it launched, the trace what the
    # card ran.  A replayed replan's counts are its capture's, so only its
    # trace shows which kernels the graph runs.
    device_launches = asm_device_launches = replay_device_launches = None
    if dev.type == "cuda":
        t1 = time.time()
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--device-launches"],
                               capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            fail(f"phase 6e: the device-launch count failed:\n{child.stderr[-3000:]}")
        counted = json.loads(child.stdout.strip().splitlines()[-1])
        solve = counted.pop("solve_batch")
        replay = counted.pop("replan")
        line = (f"# phase 6e device launches of assemble_kernel in one solve_batch call (bench distribution, B=8, "
                f"torch.profiler trace, the same process): {solve['device']} (wrapper {solve['wrapper']}), "
                f"btd_kernel {solve['btd_device']} and btd_small_kernel {solve['small_device']} (wrapper "
                f"{solve['btd_wrapper']}, of them the small kernel's {solve['small_wrapper']}), {solve['events']} "
                f"device events")
        if not (solve["device"] == solve["wrapper"] == solve["btd_device"] + solve["small_device"]
                == solve["btd_wrapper"] >= 3 and solve["small_device"] == solve["small_wrapper"]):
            fail(line + " (gate: one assembly and one BTD launch per LM iteration, on the device and by the "
                        "wrappers' counts, the BTD solve's on the kernel the wrapper counted)")
        log(line)
        asm_device_launches = solve["device"]
        line = (f"# phase 6e device launches in one replayed plan_windows_batch call (exp_1, B={replay['k']}, "
                f"K={replay['K']}, max_iters={replay['iters']}, after an eager call and a capture; replays "
                f"{replay['replayed']}): btd_small_kernel {replay['small_device']}, btd_kernel "
                f"{replay['btd_device']}, assemble_kernel {replay['asm_device']}, lm_restore_kernel "
                f"{replay['restore_device']} (the wrappers' counts: btd {replay['btd_wrapper']}, of them the "
                f"small kernel's {replay['small_wrapper']}, assembly {replay['asm_wrapper']}, LM restore "
                f"{replay['restore_wrapper']}), {replay['events']} device events")
        if not (replay["replayed"] == 1 and replay["btd_device"] == 0
                and replay["small_device"] == replay["small_wrapper"] == replay["btd_wrapper"]
                == replay["asm_device"] == replay["asm_wrapper"] == replay["restore_device"]
                == replay["restore_wrapper"] == replay["iters"]):
            fail(line + " (gate: a replay; per LM iteration one BTD solve on the small-batch kernel, one "
                        "assembly and one LM restore on the device, and the wrappers' counts equal to them)")
        log(line)
        replay_device_launches = replay["small_device"]
        line = (f"# phase 6e device launches of tick_kernel per call (torch.profiler trace of one call each, B=8, "
                f"a process of its own, {time.time() - t1:.1f} s): "
                + ", ".join(f"{k} {v['device']} (wrapper {v['wrapper']}, {v['events']} device events)"
                            for k, v in counted.items()))
        if any(v["device"] != 1 or v["wrapper"] != 1 for v in counted.values()):
            fail(line)
        log(line)
        device_launches = {k: v["device"] for k, v in counted.items()}

    # The kernel on the card against the plain loop on the CPU over 6d's window.
    terrain, table, s_cpu = riser_window
    rparams = gait_control_params(RunnerConfig().gait)
    to_dev = lambda t: t.to(dev)                                              # noqa: E731
    fk, tk = tick_scan(to_dev(table), map_tensors(s_cpu, to_dev), map_tensors(terrain, to_dev), rparams)
    fp, tp = _scan_ticks(table, s_cpu, terrain, rparams)
    T = table.shape[0]
    d = torch.maximum((tk["pos"].cpu() - tp["pos"]).abs().amax(dim=-1), (tk["q"].cpu() - tp["q"]).abs().amax(dim=-1))
    parted = torch.nonzero(d > riser.THRESHOLD).flatten()
    first = int(parted[0]) if parted.numel() else None
    dpos = float((fk.pos.cpu() - fp.pos).abs().max())
    dq = float((fk.q.cpu() - fp.q).abs().max())
    line = (f"# phase 6e exp_2's first riser, tick kernel on {card} vs plain loop on the CPU, {T} ticks: "
            f"pos and q first past {riser.THRESHOLD:g} at tick {first}; at the end |dpos| {dpos:.3e} m, |dq| {dq:.3e} rad, "
            f"x {float(fk.pos[0]):.4f} on the card, {float(fp.pos[0]):.4f} on the CPU")
    if not (dpos <= RISER_DPOS and dq <= RISER_DQ and (first is None or first >= RISER_FIRST_TICK)):
        fail(line + f" (gates: |dpos| <= {RISER_DPOS} m, |dq| <= {RISER_DQ} rad, agree until tick {RISER_FIRST_TICK})")
    log(line)

    # The bound at B=256: the bytes a launch must move, and its operations.
    B, T = tables.shape[0], tables.shape[1]
    # a launch reads each table row and writes each trace row once, reads and
    # writes the state, and reads n_valid
    nbytes = 4 * (B * T * (tick_mod.ROW + tick_mod.TRACE_FLOATS) + 2 * B * tick_mod.STATE_FLOATS + B)
    ops = B * T * tick_ops_per_tick()
    t_bytes, t_ops = nbytes / peak_bytes * 1e3, ops / peak_flops * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    # This design's floor: T times the largest mean of the chain's
    # loop-carried cycles at the probed latencies (tools/tick_floor.py).
    floor_ms = floor_cycles = cycle = None
    if dev.type == "cuda":
        cycles = tick_floor.op_cycles(tick_floor.PROBE.load())
        clock = tick_floor.sm_clock_mhz()
        floor_ms, floor_cycles, cycle = tick_floor.design_floor(cycles, T, clock)
        log(f"# phase 6e dependent cycles per operation (probe, {clock:g} MHz): "
            + ", ".join(f"{k} {v:.1f}" for k, v in cycles.items())
            + f"; the largest mean of a loop-carried cycle, {cycle!r}, {floor_cycles:.0f} cycles per tick: the "
            f"design's floor {floor_ms:.4f} ms per {T}-tick call")
    log(f"# phase 6e bound B={B} T={T}: {nbytes / 1e6:.1f} MB ({t_bytes:.4f} ms at {peak_bytes / 1e12:g} TB/s), "
        f"{ops / 1e9:.3f} GFLOP ({t_ops:.4f} ms at {peak_flops / 1e12:g} TFLOP/s): {bound_ms:.4f} ms by {bound_by}; "
        f"the kernel takes {out[B]['ms'] / bound_ms:.0f}x that"
        + (f" and {out[B]['ms'] / floor_ms:.2f}x its design's floor: the ticks of an episode depend on each other"
           if floor_ms else "") + f" (phase 6e done in {time.time() - t0:.1f} s)")
    return dict(ms=out[B]["ms"], plain_ms=out[B]["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, max_abs_err=max_err, ms_b1=out[1]["ms"], plain_ms_b1=out[1]["plain_ms"],
                floor_ms=floor_ms, floor_cycles_per_tick=floor_cycles, floor_cycle=cycle,
                device_launches_per_call=None if device_launches is None else device_launches["playback"],
                device_launches_per_hold=None if device_launches is None else device_launches["stance_warmup"],
                asm_device_launches_per_solve=asm_device_launches,
                small_device_launches_per_replay=replay_device_launches)


def phase_planner(dev, card) -> None:
    """Phase 7."""
    import numpy as np
    import torch

    from qtos_torch.ops.btd import btd_solve, picks_small
    from qtos_torch.planner import GlobalPlanner, astar, feasibility_map
    from qtos_torch.planner.feasibility import probe_specs
    from qtos_torch.solver import SolverConfig, solve_batch
    from qtos_torch.terrain import make_terrain

    t0 = time.time()
    tiles, goal, K, max_iters = ["feasibility", "plane"], (2.6, 0.0), 25, 25
    terrain = make_terrain(tiles, device=dev)
    cfg = SolverConfig(max_iters=max_iters, tol=6e-3)
    _zero_solver_counts()
    t1 = kit.synced(dev)
    fmap = feasibility_map(terrain, cfg=cfg, K=K)
    probe_s = kit.synced(dev) - t1
    launches, asm_launches, small = btd_solve.launches, _asm_launches(), btd_solve.small_launches
    restore_launches = _restore_launches()

    # The probe's windows once more, for the counts the map does not carry.
    _, specs = probe_specs(terrain, K=K)
    res = solve_batch(specs, terrain, cfg)
    n_pairs = int(res.status.numel())
    obst = torch.maximum(res.viol["terrain"], res.viol["body"])
    n_failed = int((obst >= 3e-2).sum())
    n_unconverged = int((res.status != 0).sum())

    grid = terrain.height.cpu().numpy()
    blocked = fmap > 0.5
    H, W = blocked.shape
    route = astar(blocked, (H // 2, 0), (H // 2, W - 2))
    line = (f"# phase 7 feasibility probe {'+'.join(tiles)} (K={K}, max_iters={max_iters}): {n_pairs} pairs, "
            f"{n_failed} failed the obstacle gate, {n_unconverged} unconverged at tol {cfg.tol}, "
            f"btd launches {launches} (of them the small-batch kernel's {small}), assembly launches "
            f"{asm_launches}, LM restore launches {restore_launches}, {probe_s:.3f} s on {card}; "
            f"{int(blocked.sum())}/{blocked.size} cells blocked")
    if dev.type == "cuda" and not launches == asm_launches == restore_launches >= max_iters:
        fail(line + f": the probe launched the kernels {launches}, {asm_launches} and {restore_launches} times, "
                    f"not equal and >= max_iters {max_iters}")
    if dev.type == "cuda" and small != (launches if picks_small(n_pairs, K, 36) else 0):
        fail(line + ": the BTD solves did not go to the kernel that btd_pick_small picks at this batch")
    if not blocked[grid > 0.1].all():
        fail(line + ": a pillar cell is not blocked")
    if blocked.all(axis=0).any():
        fail(line + ": some column is fully blocked")
    if route is None:
        fail(line + ": the map sealed the corridor shut")
    log(line)

    # The rescue pass on the probe's windows: its first scenarios that fail
    # pass 1 (phase 4's distribution converges whole, so it never enters).
    t1 = kit.synced(dev)
    res2 = solve_batch(specs, terrain, cfg.replace(rescue_iters=12))
    rescue_s = kit.synced(dev) - t1
    n_rescued = n_unconverged - int((res2.status != 0).sum())
    log(f"# phase 7 rescue pass on the probe's windows (rescue_iters=12): {n_unconverged} gathered, "
        f"{n_rescued} converged by it, {rescue_s:.3f} s on {card}")
    if not bool(torch.isfinite(res2.x).all()):
        fail("phase 7: non-finite solution after the rescue pass")

    planner = GlobalPlanner(terrain, (0.0, 0.0), goal, blocked=fmap)
    x, y, yaw = planner.point_at(np.linspace(0.0, planner.total_time, 200))
    path = torch.stack([x, y, yaw], dim=1).cpu().numpy()
    line = (f"# phase 7 planner: path length {planner.path_length:.3f} m, {planner.total_time:.2f} s, "
            f"max |y| {np.abs(path[:, 1]).max():.3f} m, ends at ({path[-1, 0]:.4f}, {path[-1, 1]:.4f})")
    if not (np.isfinite(path).all() and abs(path[-1, 0] - goal[0]) < 1e-3 and abs(path[-1, 1] - goal[1]) < 1e-3):
        fail(line)
    log(line + f" (phase 7 done in {time.time() - t0:.1f} s)")


def phase_runner(dev, card, goal_xy=None, runner_cfg=None) -> dict:
    """Phase 8.  `goal_xy` and `runner_cfg` (a zero-argument factory of
    RunnerConfig) cut the run for a rehearsal on the CPU; main() passes
    neither, so the card walks the exp_1 preset as it is.  Returns the
    BTD kernel's launches in 8a's replan and 8b's run, and the tick
    kernel's (playback, hold) launches in 8b's run.  8d, the real-time
    walk, runs only on the card: the CPU's plain loop is slower than 1 kHz."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from qtos_torch.builder import build
    from qtos_torch.control.replan import SIM_LEAVES, RunnerConfig, plan_windows_batch
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.runtime import native_available

    exp = "exp_1"
    on_card = dev.type == "cuda"              # main() always passes the card
    make_cfg = runner_cfg or RunnerConfig
    if not native_available():
        fail("phase 8: the native host library (runtime/native/qtos_native.cpp) did not build")

    # 8a: one replan on its own, at the shape the runner gives it
    t0 = time.time()
    bundle = build(exp, goal_xy=goal_xy, runner_cfg=make_cfg(), device=dev)
    cfg, terrain = bundle.runner.cfg, bundle.terrain
    k = cfg.n_candidates
    rows, goals, gyaws = _replan_inputs(terrain, k, dev)
    times, counts = [], []
    graphs0 = (plan_windows_batch.captures, plan_windows_batch.replays)
    # A warm-up, then the timed calls (one on the CPU).  On the card the
    # warm-up is the key's first call, which runs eagerly; the first timed
    # call captures the graph and replays it (its time is the capture's
    # cost), and the others replay.
    for i in range(1 + (5 if on_card else 1)):
        _zero_solver_counts()
        t1 = kit.synced(dev)
        res, tables, _ = plan_windows_batch(rows, goals, gyaws, terrain, cfg)
        if i:
            times.append(kit.synced(dev) - t1)
        counts.append((btd_solve.launches, _asm_launches(), btd_solve.small_launches, _restore_launches()))
    replan_s = statistics.median(times)
    captures, replays = (n - n0 for n, n0 in zip((plan_windows_batch.captures, plan_windows_batch.replays), graphs0))
    # The eager call's counts are the kernels' own launches; a replay's are
    # what its capture counted, and phase 6e's trace of a replay holds them
    # to the device's.
    replan_launches, replan_asm, replan_small, replan_restore = counts[0]
    n_conv = int((res.status == 0).sum())
    line = (f"# phase 8a replan (plan_windows_batch, B={k}, K={cfg.K}, max_iters={cfg.solver.max_iters}): "
            f"{replan_s * 1e3:.1f} ms on {card} (median of {len(times)} calls, {min(times) * 1e3:.1f} to "
            f"{max(times) * 1e3:.1f}, the first of them {times[0] * 1e3:.1f}; graphs captured {captures}, calls "
            f"replayed {replays}), the eager call's "
            f"btd launches {replan_launches} (of them the small-batch kernel's {replan_small}), assembly launches "
            f"{replan_asm}, LM restore launches {replan_restore}; the replayed calls' counts (their capture's) "
            f"{sorted(set(counts[1:]))}; {n_conv}/{k} converged, "
            f"tables {tuple(tables.shape)}; the kernel against its plain version at "
            f"({k}, {cfg.K}, 36) is phase 3's row of that shape, a replay's device launches phase 6e's trace")
    if on_card and not (replan_launches == replan_asm == replan_restore == replan_small == cfg.solver.max_iters
                        and (captures, replays) == (1, len(times)) and set(counts) == {counts[0]}):
        fail(line + f": expected an eager call, then a capture and {len(times)} replays, each counting "
                    f"{cfg.solver.max_iters} launches of each kernel, the BTD solve's all of the small-batch kernel")
    with _warp_kernel_only():
        res_w, tables_w, _ = plan_windows_batch(rows, goals, gyaws, terrain, cfg)
    same = torch.equal(res.x, res_w.x) and torch.equal(tables, tables_w) and torch.equal(res.status, res_w.status)
    line += f"; x, statuses and tables equal to the replan's by btd_kernel bit for bit: {same}"
    if not same:
        fail(line)
    if not (n_conv >= 1 and bool(torch.isfinite(tables).all())):
        fail(line)
    log(line)

    # 8b: the preset, start to goal
    runner = bundle.runner
    _zero_solver_counts()
    _zero_tick_counts()
    graphs0 = (plan_windows_batch.captures, plan_windows_batch.replays)
    t1 = kit.synced(dev)
    rep = runner.run(verbose=True)
    wall = kit.synced(dev) - t1
    walk_captures, walk_replays = (n - n0 for n, n0 in
                                   zip((plan_windows_batch.captures, plan_windows_batch.replays), graphs0))
    launches, runner_asm, runner_small = btd_solve.launches, _asm_launches(), btd_solve.small_launches
    runner_restore = _restore_launches()
    tick_launches = _tick_counts()
    chunks = len(runner._st["com_errs"])
    want = cfg.solver.max_iters * rep.windows + cfg.escalate_iters * runner.escalations
    plan_s = rep.windows * replan_s
    loops = max(runner._st["window"], 1)
    line = (f"# phase 8b {exp} (K={cfg.K}, {cfg.window_duration} s windows, f_steps {cfg.f_steps}, "
            f"{cfg.n_candidates} candidates, goal {tuple(float(g) for g in runner.goal_xy)}): "
            f"reached_goal {rep.reached_goal}, aborted {rep.aborted}, {rep.windows} windows, "
            f"{rep.sim_ticks} ticks, statuses {rep.statuses}, stance holds {rep.stance_holds}, "
            f"escalations {runner.escalations}, final pos ({rep.final_pos[0]:.4f}, {rep.final_pos[1]:.4f}, "
            f"{rep.final_pos[2]:.4f}), avg_com_err_per_s {rep.avg_com_err_per_s:.2f}, "
            f"btd launches {launches} (= {cfg.solver.max_iters} x {rep.windows} solves"
            f"{' + escalations' if runner.escalations else ''}; of them the small-batch kernel's {runner_small}), "
            f"assembly launches {runner_asm}, LM restore launches {runner_restore} (graphs captured "
            f"{walk_captures}, replans replayed {walk_replays}: a replay counts its capture's launches, which "
            f"phase 6e's trace holds to the device's), tick kernel launches (playback, hold) "
            f"{tick_launches} for {chunks} executed chunks and 1 warm-up; wall {wall:.2f} s on {card} = "
            f"{wall / loops:.2f} s per window over {loops} windows of the loop, of which replans "
            f"{plan_s:.2f} s in all (8a's {replan_s * 1e3:.1f} ms each) and warm-up + execution the rest: "
            f"{(wall - plan_s) / max(rep.sim_ticks, 1) * 1e3:.3f} ms per tick; time from dispatch to "
            f"usable plan per window {[round(t, 2) for t in rep.solve_wall_times]} s; "
            f"native host library in use {runner.host_buf.is_native}.  "
            f"For comparison of behaviour only, never of time: the TPU package's committed exp_1 run "
            f"took 5 windows and 12,465 ticks")
    ok = (rep.reached_goal and not rep.aborted and rep.windows >= 2 and all(s == 0 for s in rep.statuses)
          and rep.stance_holds == 0 and runner.host_buf.is_native
          and np.isfinite(rep.final_pos).all() and rep.avg_com_err_per_s < 120.0)
    if goal_xy is None:
        ok = ok and rep.final_pos[0] > 1.9
    if on_card:
        ok = (ok and launches == want == runner_asm == runner_restore == runner_small
              and tick_launches == (chunks, 1))
    if not ok:
        fail(line)
    log(line)

    # 8c: checkpoint after each of two windows, restore into a fresh runner
    t1 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.npz")
        cut = dataclasses.replace(make_cfg(), max_windows=2, checkpoint_every=1, checkpoint_path=path)
        first = build(exp, goal_xy=goal_xy, runner_cfg=cut, device=dev).runner
        first.run(verbose=False)
        fresh = build(exp, goal_xy=goal_xy, runner_cfg=cut, device=dev).runner
        fresh.restore(path)
    same = (torch.equal(first.buffer, fresh.buffer) and torch.equal(first.contact_buf, fresh.contact_buf)
            and first.buffer_end == fresh.buffer_end
            and first._st["exec_idx"] == fresh._st["exec_idx"]
            and np.array_equal(first._row_shift, fresh._row_shift)
            and all(torch.equal(getattr(first._st["sim"], n), getattr(fresh._st["sim"], n))
                    for n in SIM_LEAVES)
            and np.array_equal(first.host_buf.read(0, first.buffer_end),
                               fresh.host_buf.read(0, fresh.buffer_end)))
    line = (f"# phase 8c checkpoint: 2 windows, cursor {first._st['exec_idx']}, buffer_end {first.buffer_end}; "
            f"buffers, cursor, row shifts, host mirror and sim state equal bit for bit after restore: {same}")
    if not (same and first.buffer.data_ptr() != fresh.buffer.data_ptr() and first._st["exec_idx"] > 0):
        fail(line)
    log(line + f" ({time.time() - t1:.1f} s)")

    # 8d: qtos_tpu's real-time canary (tests/test_realtime.py), paced at 1 kHz
    if on_card:
        from qtos_torch.control.replan import RecedingHorizonRunner
        from qtos_torch.terrain import make_terrain

        t1 = time.time()
        rt_cfg = RunnerConfig(realtime=True, max_windows=6)
        rt_runner = RecedingHorizonRunner(make_terrain(["plane", "plane"], device=dev), (0.8, 0.0), cfg=rt_cfg)
        _zero_tick_counts()
        rt = rt_runner.run(verbose=False)
        line = (f"# phase 8d real-time walk (plane x2 to (0.8, 0), realtime=True, max_windows 6) on {card}: "
                f"underruns {rt.underruns}, realtime_factor {rt.realtime_factor:.4f}, {rt.sim_ticks} ticks, "
                f"{rt.windows} windows, statuses {rt.statuses}, reached_goal {rt.reached_goal}, time from dispatch "
                f"to usable plan per window {[round(t, 3) for t in rt.solve_wall_times]} s, tick kernel launches "
                f"(playback, hold) {_tick_counts()}")
        if not (rt.underruns == 0 and 0.99 <= rt.realtime_factor < 1.5 and rt.sim_ticks > 2000):
            fail(line + " (gates, those of qtos_tpu's tests/test_realtime.py: underruns == 0, "
                        "0.99 <= realtime_factor < 1.5, sim_ticks > 2000)")
        log(line + f" ({time.time() - t1:.1f} s)")
    else:
        log("# phase 8d real-time walk: on the card only")
    log(f"# phase 8 done in {time.time() - t0:.1f} s")
    return {"replan": replan_launches, "runner": launches, "tick_runner": tick_launches,
            "asm_replan": replan_asm, "asm_runner": runner_asm, "small_replan": replan_small,
            "small_runner": runner_small, "restore_replan": replan_restore, "restore_runner": runner_restore}


def phase_sharded(dev, card, B=1024, two_rank_batches=(5, 1023)) -> int:
    """Phase 9.  Returns the BTD and assembly kernels' launches in the
    sharded solve.  On the
    CPU (a rehearsal, at smaller batches) the backend is gloo and the
    two-rank run always goes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.parallel.distributed import global_scenario_mesh, initialize_multihost, solve_batch_collective
    from qtos_torch.parallel.mesh import solve_batch_sharded
    from qtos_torch.parallel.worker import free_port, run_ranks, solve_cases
    from qtos_torch.solver import SolverConfig, default_spec, solve_batch
    from qtos_torch.terrain import make_terrain

    t0 = time.time()
    K = 41
    terrain = make_terrain(["plane"] * 3, device=dev)
    cfg = SolverConfig(max_iters=3, rescue_iters=12)
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, B, device=dev), 0.0), K=K, device=dev)
    plain = solve_batch(specs, terrain, cfg)
    on_card = dev.type == "cuda"
    dev = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev.type)
    try:
        mesh = global_scenario_mesh(device=dev)
        backend = dist.get_backend()
        _zero_solver_counts()
        sharded = solve_batch_sharded(specs, terrain, cfg, mesh)
        launches, asm_launches, restore_launches = btd_solve.launches, _asm_launches(), _restore_launches()
        x_loc, st_loc, st_all = solve_batch_collective(specs, terrain, cfg, mesh)
    finally:
        dist.destroy_process_group()
    same_x, same_st = torch.equal(sharded.x, plain.x), torch.equal(sharded.status, plain.status)
    gathered = torch.equal(st_all, st_loc) and torch.equal(st_all, plain.status) and torch.equal(x_loc, plain.x)
    line = (f"# phase 9 solve_batch_sharded ({backend}, world size {mesh.world}, B={B}, K={K}) on {card}: "
            f"x equal to solve_batch's bit for bit {same_x}, statuses {same_st}; gathered statuses equal the "
            f"local ones {gathered}; {int((sharded.status == 0).sum())}/{B} converged; btd launches {launches}, "
            f"assembly launches {asm_launches}, LM restore launches {restore_launches}")
    if not (backend == ("nccl" if on_card else "gloo") and same_x and same_st and gathered
            and ((launches == asm_launches == restore_launches >= cfg.max_iters) or not on_card)):
        fail(line)
    log(line)
    if not on_card or torch.cuda.device_count() >= 2:
        outs = run_ranks(solve_cases, 2, dev.type, two_rank_batches, timeout=600)
        ok = all(np.array_equal(o["status_gathered"], np.concatenate([r[i]["status_local"] for r in outs]))
                 for i in range(len(two_rank_batches)) for o in (outs[0][i], outs[1][i]))
        log(f"# phase 9 two ranks ({backend}, B={' and '.join(map(str, two_rank_batches))}, K=13): "
            f"gathered statuses equal the ranks' own {ok}")
        if not ok:
            fail("phase 9: two ranks disagree")
    else:
        log("# phase 9 two ranks: skipped, fewer than two cards")
    log(f"# phase 9 done in {time.time() - t0:.1f} s")
    return {"btd": launches, "assemble": asm_launches, "restore": restore_launches}


# Card vs CPU on the TOWR-window entry point: both solve the same float32 NLP
# for 120 LM iterations from the same golden window.  The goal pins end_dev
# (2.5e-6 m apart on an H100), but the interior is a feasibility manifold on
# which rounding moves the converged point: com_rms parted by 5.5e-4 m there,
# and by 5.2e-4 m between two CPUs.  The gate is 1 mm.
TOWR_GATE_M = 1e-3


def phase_towr(dev, card, golden_table) -> dict:
    """Phase 10: `scripts/towr_deviation_torch.py`'s `measure` on the card and
    on the CPU, from a golden written here: `golden_table` (2501, 37), one
    converged window of phase 4's bench solve (K=41, 2.5 s) sampled at 1 kHz,
    saved as CSV in a temporary directory.  Its schedule comes from the
    table's force profile, not from `trot_schedule`, and the solve runs 120
    LM iterations at B=1.  Returns the solver kernels' launches on the card."""
    import tempfile

    import numpy as np

    from qtos_torch.ops.btd import btd_solve
    from scripts import towr_deviation_torch as towr

    t0 = time.time()
    on_card = dev.type == "cuda"          # main() always passes the card
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        golden = os.path.join(tmp, "golden.csv")
        np.savetxt(golden, golden_table, delimiter=",")
        for name, d in (("card", dev), ("cpu", "cpu")):
            _zero_solver_counts()
            t1 = kit.synced(dev)
            fig, res, spec = towr.measure(golden=golden, device=d)
            t2 = kit.synced(dev)
            out[name] = dict(fig=fig, ms=(t2 - t1) * 1e3, iters=int(res.iters), btd=btd_solve.launches,
                             small=btd_solve.small_launches, asm=_asm_launches(), restore=_restore_launches(),
                             double_support=int((spec.schedule.contact.sum(-1) == 4).sum()))
    if on_card:
        with tempfile.TemporaryDirectory() as tmp, _warp_kernel_only():
            golden = os.path.join(tmp, "golden.csv")
            np.savetxt(golden, golden_table, delimiter=",")
            fig_w, _, _ = towr.measure(golden=golden, device=dev)
    card_run, cpu_run = out["card"], out["cpu"]
    gaps = {k: abs(card_run["fig"][k] - cpu_run["fig"][k]) for k in ("com_rms", "end_dev")}
    line = (f"# phase 10 TOWR window (measure, K=41, 2.5 s, {card_run['double_support']} knots of four-foot "
            f"support from the force profile, B=1) on {card}: " + "; ".join(
                f"{name}: status {r['fig']['status']}, max_violation {r['fig']['max_violation']:.3e}, com_rms "
                f"{r['fig']['com_rms']:.4e}, end_dev {r['fig']['end_dev']:.4e}, feet_rms {r['fig']['feet_rms']:.4e} m, "
                f"{r['iters']} LM iterations, btd, assembly and LM restore launches {r['btd']}, {r['asm']} and "
                f"{r['restore']} (the small-batch kernel's {r['small']}), "
                f"{r['ms']:.1f} ms per measure" for name, r in out.items())
            + f"; card vs CPU com_rms {gaps['com_rms']:.2e}, end_dev {gaps['end_dev']:.2e} m (gate {TOWR_GATE_M})"
            + (f"; the card's figures equal those by btd_kernel bit for bit: {card_run['fig'] == fig_w}"
               if on_card else ""))
    ok = (all(r["fig"]["status"] == 0 and r["fig"]["max_violation"] < 3e-3
              and all(math.isfinite(v) for v in r["fig"].values()) for r in out.values())
          and all(g <= TOWR_GATE_M for g in gaps.values())
          and cpu_run["btd"] == cpu_run["asm"] == cpu_run["restore"] == 0
          and (not on_card or (card_run["btd"] == card_run["asm"] == card_run["restore"] == card_run["small"]
                               == card_run["iters"] == 120
                               and card_run["fig"] == fig_w)))
    if not ok:
        fail(line)
    log(line + f" (phase 10 done in {time.time() - t0:.1f} s)")
    return {"btd": card_run["btd"], "assemble": card_run["asm"], "small": card_run["small"],
            "restore": card_run["restore"],
            "figures": card_run["fig"], "ms": card_run["ms"]}


BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]          # bench.py's last line


def bench_line_ok(line: str) -> bool:
    """Phase 11's gate on one `# B=` line of `bench_torch.py`
    (`bench_torch.describe`): every scenario converged, and in every timed
    call the BTD, assembly and LM restore kernels launched equally often, at
    least 3 times, none of it on the small-batch BTD kernel."""
    conv = re.search(r"\((\d+)/(\d+) converged\)", line)
    counts = re.search(r"btd \[([\d, ]+)\], assembly \[([\d, ]+)\], LM restore \[([\d, ]+)\], of the btd the "
                       r"small-batch kernel's \[([\d, ]+)\]", line)
    if not (conv and counts) or conv.group(1) != conv.group(2):
        return False
    btd, asm, restore, small = ([int(v) for v in g.split(",")] for g in counts.groups())
    return btd == asm == restore and min(btd) >= 3 and max(small) == 0


def phase_bench(card) -> str:
    """Phase 11: `python3 bench_torch.py` in a child process with the
    default sizes (B=1024 and 8192).  It must exit 0, print one `# B=`
    line per size with every scenario converged and each kernel launched
    once per LM iteration in every timed call (the BTD solve's btd_kernel,
    not its small-batch kernel), and end in a line with exactly `bench.py`'s
    keys.  Returns that line."""
    t0 = time.time()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "QTOS_BENCH_BATCHES"}
    child = subprocess.run([sys.executable, os.path.join(here, "bench_torch.py")], cwd=here, env=env,
                           capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"# phase 11 bench_torch.py: {line.lstrip('# ')}")
    sizes = [line for line in lines if line.startswith("# B=")]
    try:
        out = json.loads(lines[-1])
    except (IndexError, ValueError):
        out = None

    ok = (child.returncode == 0 and isinstance(out, dict) and list(out) == BENCH_KEYS
          and out["metric"] == "gait_nlp_solves_per_s" and out["value"] > 0
          and len(sizes) == 2 and all(bench_line_ok(line) for line in sizes))
    if not ok:
        fail(f"phase 11: bench_torch.py exited {child.returncode} (gates: exit 0, two sizes, every scenario "
             f"converged, one launch of each kernel per LM iteration, bench.py's keys):\n{child.stdout[-3000:]}\n"
             f"{child.stderr[-3000:]}")
    log(f"# phase 11 bench_torch.py on {card}, last line: {lines[-1]} ({time.time() - t0:.1f} s)")
    return lines[-1]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")

    import bench_torch
    import qtos_torch  # noqa: F401  (sets TF32 off)
    from qtos_torch.ops import assemble as asm_mod
    from qtos_torch.ops import btd as btd_mod
    from qtos_torch.ops import lm_restore as restore_mod
    from qtos_torch.ops import tick as tick_mod
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.ops.tridiag import block_tridiag_matvec, block_tridiag_solve
    from qtos_torch.solver import default_spec, sample_trajectory, solve_batch
    from qtos_torch.solver.assemble import assemble
    from qtos_torch.solver.spec import index_spec
    from qtos_torch.solver.transcription import initial_guess, knot_aux
    from qtos_torch.terrain import make_terrain
    from qtos_torch.terrain.heightfield import slope_terrain
    from qtos_torch.tools import btd_floor, check_assemble, check_restore, profile_solve, tick_floor

    dev = torch.device("cuda")

    # ---- 1. card --------------------------------------------------------
    try:
        card = kit.card()
    except RuntimeError as e:
        fail(str(e))
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    # One nvcc for each source, all at once; each prints its ptxas report.
    t0 = time.time()
    report = io.StringIO()
    with contextlib.redirect_stdout(report), concurrent.futures.ThreadPoolExecutor(5) as pool:
        builds = [pool.submit(fn, verbose=True)
                  for fn in (btd_mod.build, tick_mod.build, asm_mod.build, tick_floor.PROBE.build, restore_mod.build)]
        paths = [b.result() for b in builds]
    report = report.getvalue()
    log(report.rstrip())

    regs, _ = ptxas_registers(report, "btd_kernel")
    tick_regs, tick_spills = ptxas_registers(report, "tick_kernel")
    small_regs, small_spills = ptxas_registers(report, "btd_small_kernel")
    asm_regs, asm_spills = ptxas_registers(report, "assemble_kernel")
    log(f"# phase 2 build: {', '.join(paths)} in {time.time() - t0:.1f} s; registers per thread: "
        f"btd_kernel {regs}, btd_small_kernel {small_regs} with {small_spills} B spill stores, "
        f"tick_kernel {tick_regs} with {tick_spills} B spill stores (before the tick "
        f"kernel's redesign: {TICK_BEFORE}), assemble_kernel {asm_regs} with {asm_spills} B spill stores")

    # ---- 3. kernel vs plain ----------------------------------------------
    def cholesky_ex(A):
        """The factor alone: no check of `info`, so no wait for the host."""
        return torch.linalg.cholesky_ex(A).L

    def library_thomas(D, L, b, chol=torch.linalg.cholesky):
        """Block Thomas over `chol` (torch.linalg.cholesky, which reads each
        factorisation's `info` back to the host, or `cholesky_ex`) and
        torch.cholesky_solve: the library yardstick (the port never calls
        it)."""
        K = D.shape[1]
        Cs, ys = [chol(D[:, 0])], [b[:, 0, :, None]]
        for k in range(1, K):
            Lk = L[:, k - 1]
            Wt = torch.cholesky_solve(Lk.transpose(-1, -2), Cs[-1])
            u = torch.cholesky_solve(ys[-1], Cs[-1])
            ys.append(b[:, k, :, None] - Lk @ u)
            Cs.append(chol(D[:, k] - Lk @ Wt))
        xs = [None] * K
        xn = torch.cholesky_solve(ys[-1], Cs[-1])
        xs[-1] = xn
        for k in range(K - 2, -1, -1):
            xn = torch.cholesky_solve(ys[k] - L[:, k].transpose(-1, -2) @ xn, Cs[k])
            xs[k] = xn
        return torch.stack(xs, 1)[..., 0]

    def dense_system(D, L):
        """H of (B, K n, K n): the same block-tridiagonal system, dense."""
        B, K, n, _ = D.shape
        H = torch.zeros((B, K, n, K, n), device=D.device)
        for k in range(K):
            H[:, k, :, k, :] = D[:, k]
        for k in range(K - 1):
            H[:, k + 1, :, k, :] = L[:, k]
            H[:, k, :, k + 1, :] = L[:, k].transpose(-1, -2)
        return H.reshape(B, K * n, K * n)

    def dense_solve(H, b):
        """One dense Cholesky and solve of H x = b (b (B, K, n))."""
        return torch.cholesky_solve(b.reshape(b.shape[0], -1, 1), cholesky_ex(H)).reshape(b.shape)

    def bound(B, K, n):
        nbytes, flops = btd_mod.work(B, K, n)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops

    def design_bytes(B, K, n):
        """Bytes the kernel's design moves: D once, L twice (forward and back
        pass), the packed factors C_0..C_{K-2} written (n(n+1)/2 floats each)
        and read back (padded to a multiple of 4 floats), b read, y_k written
        and read back, x written."""
        packed = n * (n + 1) // 2
        return 4 * (B * K * n * n + 2 * B * (K - 1) * n * n
                    + B * (K - 1) * (packed + (packed + 3) // 4 * 4) + 4 * B * K * n)

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

    def packed_launcher(D, L, b, small=False, lm=None):
        """(launch, x): one launch of btd_kernel, or of the small-batch
        kernel, on inputs packed once (the output and the factors' scratch
        allocated once, no wrapper, no count), damped by `lm` if given."""
        lib = btd_mod.KERNEL.load()
        B, K, n = b.shape
        x = torch.empty_like(b)
        scratch = torch.empty((B, K - 1, lib.btd_packed_floats(n)), dtype=D.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = lib.btd_small_solve_f32 if small else lib.btd_solve_f32

        def launch():
            err = fn(D.data_ptr(), L.data_ptr(), b.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, K, n, stream,
                     None if lm is None else lm.data_ptr())
            if err != 0:
                fail(f"phase 3: {'small-batch' if small else 'btd'} kernel launch failed at ({B}, {K}, {n}): "
                     f"CUDA error {err}")

        return launch, x

    def packed_launch_ms(D, L, b, small=False, lm=None):
        """ms per launch of one kernel alone, on inputs packed once."""
        launch, _ = packed_launcher(D, L, b, small, lm)
        launch()
        return kit.event_ms(launch, 20)

    def damping(B, seed):
        """lm (B,) from 1e-4 to 2 on the card."""
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        return 10.0 ** (torch.rand((B,), generator=gen, device=dev) * 4.3 - 4.0)

    def damped_copy(D, lm):
        """The damped copy the LM loop made before the kernel took lm."""
        return D + torch.diag_embed(lm[:, None, None] * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8)

    # The small-batch kernel's design floor at the probe's latencies
    # (tools/btd_floor.py; the probe was built in phase 2).
    op_cycles = tick_floor.op_cycles(tick_floor.load_probe(paths[3]))
    sm_clock = tick_floor.sm_clock_mhz()

    t0 = time.time()
    kernel_row = None
    small_rows = {}
    max_err_all = small_err = 0.0
    small_shapes = []
    damped_shapes = []
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
        # damped by lm: bit for bit the undamped solve of the damped copy, D untouched
        lm = damping(B, i)
        Dd, D0 = damped_copy(D, lm), D.clone()
        before = btd_solve.damped_launches
        xd, xc = btd_solve(D, L, b, lm=lm), btd_solve(Dd, L, b)
        torch.cuda.synchronize()
        same, untouched = torch.equal(xd, xc), torch.equal(D, D0)
        counted = btd_solve.damped_launches - before
        line += (f"; damped by lm in [{float(lm.min()):.2e}, {float(lm.max()):.2e}]: x equal to the undamped "
                 f"solve of the damped copy bit for bit {same}, D untouched {untouched}, damped launches {counted}, "
                 f"{float((xd - x).abs().max()):.3e} from the undamped x")
        if not (same and untouched and counted == 1):
            fail(line + " (gates: the damped copy's x bit for bit, D untouched, one damped launch)")
        damped_shapes.append((B, K, n))
        del Dd, D0, xd, xc
        if btd_mod.picks_small(B, K, n):
            # the shape goes to the small-batch kernel: held to the plain
            # version and to btd_kernel, bit for bit
            (run_s, xs), (run_w, xw) = packed_launcher(D, L, b, True), packed_launcher(D, L, b)
            run_s()
            run_w()
            torch.cuda.synchronize()
            serr, same = float((xs - xp).abs().max()), torch.equal(xs, xw)
            small_err = max(small_err, serr)
            small_shapes.append((B, K, n))
            line += (f"\n# phase 3 small-batch kernel B={B} K={K} n={n}: max_abs_err {serr:.3e}, x equal to "
                     f"btd_kernel's bit for bit {same}, btd_solve's call took it {bool(torch.equal(x, xs))}")
            if not (math.isfinite(serr) and serr <= KERNEL_ATOL and same and torch.equal(x, xs)):
                fail(line + f" (gates: within atol {KERNEL_ATOL} of the plain version, btd_kernel's x bit for bit)")
            del xs, xw
        if (B, K, n) == (8192, 41, 36):
            ms = kit.event_ms(lambda: btd_solve(D, L, b), 10)
            damped_ms = [kit.event_ms(lambda: btd_solve(D, L, b, lm=lm), 10) for _ in range(2)]
            damped_ms.append(kit.event_ms(lambda: btd_solve(D, L, b), 10))
            plain_ms = kit.event_ms(lambda: block_tridiag_solve(D, L, b), 1)
            lib_calls = kit.event_ms_calls(lambda: library_thomas(D, L, b), 3)
            lib_ex_calls = kit.event_ms_calls(lambda: library_thomas(D, L, b, cholesky_ex), 3)
            lib_ms, lib_ex_ms = sum(lib_calls) / 3, sum(lib_ex_calls) / 3
            lib_err = float((library_thomas(D, L, b, cholesky_ex) - xp).abs().max())
            xl = library_thomas(D, L, b)
            bms, bby, nbytes, flops = bound(B, K, n)
            line += (f"\n# phase 3 times B={B} K={K} n={n} on {card}: kernel {ms:.3f} ms, "
                     f"plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms "
                     f"(calls {', '.join(f'{t:.1f}' for t in lib_calls)}; "
                     f"library vs true x {float((xl - xt).abs().max()):.3e}), "
                     f"library with cholesky_ex {lib_ex_ms:.3f} ms (calls "
                     f"{', '.join(f'{t:.1f}' for t in lib_ex_calls)}; vs plain x {lib_err:.3e}), "
                     f"bound {bms:.3f} ms by {bby} ({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)")
            if not lib_err <= KERNEL_ATOL:
                fail(line + f": the library loop with cholesky_ex exceeds atol {KERNEL_ATOL}")
            kernel_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_ex_ms=lib_ex_ms, bound_ms=bms,
                              bound_by=bby, damped_ms=damped_ms[0], undamped_ms_again=damped_ms[2])
            line += (f"\n# phase 3 damped B={B} K={K} n={n} on {card}: btd_solve with lm {damped_ms[0]:.3f} / "
                     f"{damped_ms[1]:.3f} ms, without {ms:.3f} / {damped_ms[2]:.3f} ms, in turns (undamped, damped, "
                     f"damped, undamped)")
            occ = btd_mod.occupancy(n)
            dbytes = design_bytes(B, K, n)
            line += (f"\n# phase 3 rates B={B} K={K} n={n} on {card}: "
                     f"{nbytes / ms / 1e6:.1f} GB/s of the bound's {nbytes / 1e9:.3f} GB, "
                     f"{dbytes / ms / 1e6:.1f} GB/s of the design's {dbytes / 1e9:.3f} GB "
                     f"(design floor {dbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms), "
                     f"{flops / ms / 1e6:.1f} GFLOP/s; {regs} registers per thread, "
                     f"{occ['smem_per_block']} B shared memory per block, "
                     f"{occ['warps_per_sm']} resident warps per SM")
        if (B, K, n) in SMALL_TIMED:
            bms, bby, nbytes, flops = bound(B, K, n)
            H = dense_system(D, L)                     # built once, outside the timing
            lib_err = float((library_thomas(D, L, b, cholesky_ex) - xp).abs().max())
            dense_err = float((dense_solve(H, b) - xp).abs().max())
            floor_ms, _, floor_stages = btd_floor.design_floor(op_cycles, K, n, sm_clock)
            warp_ms = packed_launch_ms(D, L, b)
            small_ms = packed_launch_ms(D, L, b, small=True)
            small_rows[B] = dict(ms=warp_ms, small_ms=small_ms,
                                 small_damped_ms=packed_launch_ms(D, L, b, small=True, lm=lm),
                                 small_ms_again=packed_launch_ms(D, L, b, small=True),
                                 ms_again=packed_launch_ms(D, L, b),
                                 call_ms=kit.event_ms(lambda: btd_solve(D, L, b), 20),
                                 plain_ms=kit.event_ms(lambda: block_tridiag_solve(D, L, b), 3),
                                 library_ms=kit.event_ms(lambda: library_thomas(D, L, b, cholesky_ex), 3),
                                 dense_ms=kit.event_ms(lambda: dense_solve(H, b), 5), bound_ms=bms, bound_by=bby,
                                 small_floor_ms=floor_ms)
            del H
            r = small_rows[B]
            line += (f"\n# phase 3 times B={B} K={K} n={n} on {card}: small-batch kernel {r['small_ms']:.4f} / "
                     f"{r['small_ms_again']:.4f} ms (damped by lm between them {r['small_damped_ms']:.4f} ms) and "
                     f"btd_kernel {r['ms']:.4f} / {r['ms_again']:.4f} ms on inputs "
                     f"packed once, in turns (the wrapper's whole call {r['call_ms']:.4f} ms), plain "
                     f"{r['plain_ms']:.3f} ms, library loop with cholesky_ex {r['library_ms']:.3f} ms (vs plain x "
                     f"{lib_err:.3e}), dense cholesky_ex + cholesky_solve on ({B}, {K * n}, {K * n}) "
                     f"{r['dense_ms']:.3f} ms (vs plain x {dense_err:.3e}), bound {bms:.5f} ms by {bby} "
                     f"({nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP), {r['small_ms'] / bms:.0f}x the bound; the "
                     f"small kernel's design floor {floor_ms:.4f} ms ({r['small_ms'] / floor_ms:.1f}x; cycles by "
                     f"stage " + ", ".join(f"{k} {v:.0f}" for k, v in floor_stages.items()) + f" at {sm_clock:g} MHz)")
            if not (lib_err <= KERNEL_ATOL and dense_err <= KERNEL_ATOL):
                fail(line + f": a library call exceeds atol {KERNEL_ATOL} against the plain version")
            faster = (r["small_ms"] < r["dense_ms"]) if B == 1 else (r["small_ms"] < r["ms"])
            if not faster:
                fail(line + ": the small-batch kernel is not faster than the " +
                     ("dense library call" if B == 1 else "btd_kernel"))
        log(line)
        del D, L, b, xt, x, xp
    torch.cuda.empty_cache()

    # The crossover: both kernels at (B, 41, 36) in turns (btd_kernel, small,
    # small, btd_kernel), against the rule fixed in btd.cu (btd_pick_small).
    crossover = {}
    for i, B in enumerate(CROSSOVER_BATCHES):
        D, L, b, _ = spd_system(B, 41, 36, 100 + i)
        w1, s1, s2, w2 = (packed_launch_ms(D, L, b, small) for small in (False, True, True, False))
        crossover[B] = dict(btd_kernel_ms=(w1 + w2) / 2, small_ms=(s1 + s2) / 2,
                            picked="small" if btd_mod.picks_small(B, 41, 36) else "btd_kernel")
        del D, L, b
    faster = [B for B, c in crossover.items() if c["small_ms"] < c["btd_kernel_ms"]]
    crossover_batch = max(faster) if faster else 0
    log(f"# phase 3 crossover at K=41, n=36 on {card} (ms per launch, btd_kernel / small-batch kernel, mean of two "
        f"in turns; the kernel btd_pick_small picks): " + ", ".join(
            f"B={B} {c['btd_kernel_ms']:.4f} / {c['small_ms']:.4f} ({c['picked']})" for B, c in crossover.items())
        + f"; the small kernel is faster up to B={crossover_batch} of these; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    log(f"# phase 3 small-batch kernel: held to btd_kernel bit for bit and to the plain version at "
        f"{small_shapes}, max_abs_err {small_err:.3e}")
    log(f"# phase 3 damped solves: bit for bit the damped copy's at {damped_shapes}, each counted once in "
        f"btd_solve.damped_launches and the undamped solve of the copy not")

    # An LM system of the main path: first-iteration system at the bench
    # distribution, damped as solve_batch damps it (by the kernel, from lm).
    specs, terrain = bench_torch.build_specs(8192, dev)
    cfg = bench_torch.solver_config()
    K = bench_torch.K
    x0 = initial_guess(specs, terrain, cfg)
    Dm, Lm, gm, _ = assemble(x0, specs, terrain, cfg, knot_aux(specs, terrain, cfg))
    lm = torch.full((Dm.shape[0],), cfg.lm_init * cfg.lm_down, device=dev)
    bm = -gm
    xk = btd_solve(Dm, Lm, bm, lm=lm)
    Dm = damped_copy(Dm, lm)
    same = torch.equal(xk, btd_solve(Dm, Lm, bm))
    xp = block_tridiag_solve(Dm, Lm, bm)
    torch.cuda.synchronize()
    scale = float(xp.abs().max())
    err = float((xk - xp).abs().max())
    res_k, res_p = rel_residual(Dm, Lm, xk, bm), rel_residual(Dm, Lm, xp, bm)
    line = (f"# phase 3 kernel vs plain on the main path's LM system (B=8192, K=41): "
            f"max_abs_err {err:.3e} of max|x| {scale:.3e}; |Hx-b|/|b| kernel {res_k:.3e}, plain {res_p:.3e}; "
            f"the kernel's damped x equal to its x on the damped copy bit for bit {same}")
    # These LM systems are badly conditioned (weights up to 60, damping
    # 7.5e-5): two correct float32 solvers differ by ~cond * 1e-7 relative,
    # measured 2.2e-3 of max|x| on an H100.  So the kernel is held to the
    # plain version at 1e-2 of max|x|, and its residual to the plain one's.
    if not (same and math.isfinite(err) and err <= 1e-2 * scale and res_k <= max(2 * res_p, 1e-5)):
        fail(line)
    log(line)
    del Dm, Lm, gm, bm, xk, xp, x0
    torch.cuda.empty_cache()
    log(f"# phase 3 done in {time.time() - t0:.1f} s")

    # ---- 3b. assembly kernel vs plain --------------------------------------
    # Every shape a path gives the kernel, on the bench distribution's first
    # iterate and on a perturbed iterate over step terrain with every hinge
    # family active; times at (1, 41), (4, 41), (1024, 41) and (8192, 41).
    t0 = time.time()
    asm_rows = []
    for shape in check_assemble.SHAPES:  # phase 4 goes on with this function's K
        for iterate in ("bench", "steps"):
            r = check_assemble.compare(iterate, *shape, dev,
                                       timed=iterate == "bench" and shape in check_assemble.TIMED)
            line = f"# phase 3b {check_assemble.describe(r)} on {card}"
            if not r["ok"]:
                fail(line + f" (gates: within atol=rtol={check_assemble.ATOL}, finite, two launches bit for bit)")
            log(line)
            asm_rows.append(r)
    timed = {r["B"]: r for r in asm_rows if "ms" in r}
    share = max(max(r["tolerance_shares"].values()) for r in asm_rows)
    gate = max(max(r["gate_shares"].values()) for r in asm_rows)
    occ = check_assemble.occupancy(asm_mod.KERNEL.load(), 41)
    log(f"# phase 3b assemble_kernel on {card}: {asm_regs} registers, {asm_spills} B spill stores, "
        f"{occ['smem_bytes']} B shared memory per block and {occ['blocks_per_sm']} blocks per SM at K=41; ms per launch "
        + ", ".join(f"(B={B}, K=41) {r['ms']:.3f} (bound {r['bound_ms']:.4f} by {r['bound_by']}, "
                    f"{r['ms'] / r['bound_ms']:.1f}x; this design's floor {r['floor_ms']:.4f} by {r['floor_by']}, "
                    f"{r['ms'] / r['floor_ms']:.1f}x; the wrapper's whole call {r['call_ms']:.3f}; plain "
                    f"{r['plain_ms']:.3f})" for B, r in sorted(timed.items()))
        + f" (the first design: {ASM_BEFORE}); the largest share of the gate {gate:.3f} (of atol=rtol="
        f"{check_assemble.ATOL} alone {share:.3f}: entries whose terms cancel, on the perturbed iterate) "
        f"(phase 3b done in {time.time() - t0:.1f} s)")
    asm_row = dict(ms=timed[8192]["ms"], call_ms=timed[8192]["call_ms"], plain_ms=timed[8192]["plain_ms"],
                   bound_ms=timed[8192]["bound_ms"],
                   bound_by=timed[8192]["bound_by"], floor_ms=timed[8192]["floor_ms"],
                   floor_by=timed[8192]["floor_by"], library_ms=None,
                   max_abs_err=max(r["max_abs_err"] for r in asm_rows), max_gate_share=gate,
                   max_plain_tolerance_share=share,
                   ms_b1024=timed[1024]["ms"], plain_ms_b1024=timed[1024]["plain_ms"],
                   bound_ms_b1024=timed[1024]["bound_ms"], floor_ms_b1024=timed[1024]["floor_ms"],
                   ms_b4=timed[4]["ms"], call_ms_b4=timed[4]["call_ms"], plain_ms_b4=timed[4]["plain_ms"],
                   bound_ms_b4=timed[4]["bound_ms"],
                   floor_ms_b4=timed[4]["floor_ms"],
                   ms_b1=timed[1]["ms"], call_ms_b1=timed[1]["call_ms"], plain_ms_b1=timed[1]["plain_ms"],
                   bound_ms_b1=timed[1]["bound_ms"], floor_ms_b1=timed[1]["floor_ms"], smem_bytes=occ["smem_bytes"],
                   blocks_per_sm=occ["blocks_per_sm"])

    # ---- 3c. LM restore kernel vs plain -----------------------------------
    # The shapes of the sweep, the replan and the TOWR window, every step
    # accepted, every one rejected, a mix, and the mix with no kept system
    # (zero fill); held to the plain version and torch.where bit for bit.
    t0 = time.time()
    restore_rows, restore_host = check_restore.check_all(dev)
    for r in restore_rows:
        line = f"# phase 3c {check_restore.describe(r)} on {card}"
        if not r["bit_for_bit"]:
            fail(line + " (gate: the kernel equals its plain version and torch.where bit for bit)")
        log(line)
    restore_regs, restore_spills = ptxas_registers(report, "lm_restore_kernel")
    log(f"# phase 3c lm_restore_kernel on {card}: {restore_regs} registers, {restore_spills} B spill stores; host us "
        f"per call at B=4: the wrapper {restore_host['wrapper_us']:.2f}, the three torch.where calls it replaced "
        f"{restore_host['where_us']:.2f} (phase 3c done in {time.time() - t0:.1f} s)")
    rr = {(r["B"], r["case"]): r for r in restore_rows}
    restore_row = dict(
        ms=rr[8192, "accepted"]["kernel_ms"], plain_ms=rr[8192, "accepted"]["plain_ms"],
        bound_ms=rr[8192, "accepted"]["bound_ms"], where_ms=rr[8192, "accepted"]["where_ms"],
        ms_rejected=rr[8192, "rejected"]["kernel_ms"], plain_ms_rejected=rr[8192, "rejected"]["plain_ms"],
        bound_ms_rejected=rr[8192, "rejected"]["bound_ms"], where_ms_rejected=rr[8192, "rejected"]["where_ms"],
        ms_b4=rr[4, "mixed"]["kernel_ms"], plain_ms_b4=rr[4, "mixed"]["plain_ms"],
        bound_ms_b4=rr[4, "mixed"]["bound_ms"], where_ms_b4=rr[4, "mixed"]["where_ms"],
        rejected_b4=rr[4, "mixed"]["rejected"],
        ms_b1=rr[1, "rejected"]["kernel_ms"], plain_ms_b1=rr[1, "rejected"]["plain_ms"],
        bound_ms_b1=rr[1, "rejected"]["bound_ms"], where_ms_b1=rr[1, "rejected"]["where_ms"],
        host_us_b4=restore_host["wrapper_us"], where_host_us_b4=restore_host["where_us"],
        registers=restore_regs, spill_stores_bytes=restore_spills)
    torch.cuda.empty_cache()

    # ---- 4. main path ----------------------------------------------------
    t0 = time.time()
    main_launches = main_asm_launches = main_restore_launches = None
    played = None
    for B in (1024, 8192):
        specs, terrain = bench_torch.build_specs(B, dev)
        torch.cuda.reset_peak_memory_stats()
        # a warm-up call, then REPEATS timed calls, each ended by a host read
        # of the statuses; the counts are set to 0 before each call
        t = bench_torch.time_solves(specs, terrain, cfg)
        res, s = t.pop("result"), t["seconds"]
        n_conv, med = t["converged"], statistics.median(s)
        launches, asm_launches = t["btd_launches"][-1], t["assemble_launches"][-1]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"# phase 4 B={B}: median {med:.3f} s -> {B / med:.1f} solves/s ({n_conv}/{B} converged in every call), "
            f"{len(s)} calls min / median / max {min(s):.4f} / {med:.4f} / {max(s):.4f} s, "
            f"btd launches per call {t['btd_launches']}, assembly launches per call {t['assemble_launches']}, "
            f"LM restore launches per call {t['restore_launches']}, "
            f"max violation {float(res.max_violation.max()):.3e}, peak memory {peak:.2f} GiB on {card}")
        if not all(a == b == c >= cfg.max_iters
                   for a, b, c in zip(t["btd_launches"], t["assemble_launches"], t["restore_launches"])):
            fail(f"the main path launched the BTD, assembly and LM restore kernels {t['btd_launches']}, "
                 f"{t['assemble_launches']} and {t['restore_launches']} times, not one each per LM iteration "
                 f"(>= max_iters {cfg.max_iters})")
        if any(t["small_btd_launches"]):
            fail(f"the main path at B={B} launched the small-batch BTD kernel {t['small_btd_launches']} times: "
                 f"this batch is btd_kernel's")
        if n_conv != B:
            fail(f"{B - n_conv}/{B} scenarios did not converge")
        if not bool(torch.isfinite(res.x).all()):
            fail("non-finite solution")
        table, contact = sample_trajectory(res.x[0], index_spec(specs, 0))
        if tuple(table.shape) != (2501, 37) or not bool(torch.isfinite(table).all()):
            fail(f"sample_trajectory gave {tuple(table.shape)}, finite={bool(torch.isfinite(table).all())}")
        main_launches, main_asm_launches = launches, asm_launches
        main_restore_launches = t["restore_launches"][-1]
        if B == 1024:
            played = (res.x[::4].clone(), index_spec(specs, slice(None, None, 4)))
            golden_table = table.cpu().numpy()           # phase 10's golden window

    # where the time goes at B=8192: one assembly and one solve
    x0 = initial_guess(specs, terrain, cfg)
    aux, slope = knot_aux(specs, terrain, cfg), slope_terrain(terrain, cfg.slope_probe_d)
    asm_ms = kit.event_ms(lambda: assemble(x0, specs, terrain, cfg, aux, slope), 3)
    Dm, Lm, gm, _ = assemble(x0, specs, terrain, cfg, aux, slope)
    solve_ms = kit.event_ms(lambda: btd_solve(Dm, Lm, gm), 3)
    log(f"# phase 4 breakdown B=8192: assemble (the kernel) {asm_ms:.3f} ms, btd_solve {solve_ms:.3f} ms per "
        f"iteration")
    del Dm, Lm, gm
    torch.cuda.empty_cache()
    t1 = time.time()
    prof = profile_solve.profile_once(8192, K, dev)
    profile_solve.report(prof)
    if prof["idle_share"] == "not measured":
        log("# phase 4 profile: the profiler reported no device activity")
    torch.cuda.empty_cache()
    log(f"# phase 4 profile took {time.time() - t1:.1f} s")
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

    playback_out = phase_playback(dev, card, terrain, *played)
    window = phase_riser(dev, card)
    tick_row = phase_tick(dev, card, playback_out, window, PEAK_BYTES_PER_S, PEAK_F32_FLOPS)
    phase_planner(dev, card)
    runner_launches = phase_runner(dev, card)
    sharded_launches = phase_sharded(dev, card)
    towr_launches = phase_towr(dev, card, golden_table)
    torch.cuda.empty_cache()                      # the child process needs the card's memory
    phase_bench(card)

    # ---- result lines ----------------------------------------------------
    row = dict(
        name="btd",
        route="cuda",
        source="qtos_torch/csrc/btd.cu",
        replaces="qtos_tpu/ops/pallas/btd.py:153 (_btd_kernel)",
        launches=main_launches,
        # the later paths' counts, each read after its own run
        launches_replan=runner_launches["replan"],
        launches_runner=runner_launches["runner"],
        launches_sharded=sharded_launches["btd"],
        launches_towr=towr_launches["btd"],
        max_abs_err=max_err_all,
        max_err=max_err_all,
        **kernel_row,
        **{f"{key}_b{B}": v for B, r in small_rows.items() for key, v in r.items()},
        crossover_batch=crossover_batch,
        crossover_ms={B: [c["btd_kernel_ms"], c["small_ms"]] for B, c in crossover.items()},
    )
    # The small-batch kernel of the same source: its path is the replan
    # (phase 8a; 8b's walk and phase 10's TOWR window too); its times at
    # the replan's shape (4, 41, 36), and at the TOWR window's (1, 41, 36).
    r4, r1 = small_rows[4], small_rows[1]
    small_row = dict(
        name="btd_small",
        route="cuda",
        source="qtos_torch/csrc/btd.cu",
        replaces="qtos_tpu/ops/pallas/btd.py:153 (_btd_kernel), at batches of up to two scenarios per SM",
        launches=runner_launches["small_replan"],
        launches_runner=runner_launches["small_runner"],
        launches_towr=towr_launches["small"],
        device_launches_per_replay=tick_row.pop("small_device_launches_per_replay"),
        max_abs_err=small_err,
        ms=r4["small_ms"],
        plain_ms=r4["plain_ms"],
        bound_ms=r4["bound_ms"],
        bound_by=r4["bound_by"],
        library_ms=r4["dense_ms"],
        floor_ms=r4["small_floor_ms"],
        btd_kernel_ms=r4["ms"],
        ms_b1=r1["small_ms"],
        plain_ms_b1=r1["plain_ms"],
        bound_ms_b1=r1["bound_ms"],
        library_ms_b1=r1["dense_ms"],
        floor_ms_b1=r1["small_floor_ms"],
        btd_kernel_ms_b1=r1["ms"],
        crossover_batch=crossover_batch,
        registers=small_regs,
        spill_stores_bytes=small_spills,
    )
    asm_row = dict(
        name="assemble",
        route="cuda",
        source="qtos_torch/csrc/assemble.cu",
        replaces="qtos_tpu/solver/assemble_lanes.py:610 (assemble_lanes, run by _solve_batch_lanes in "
                 "qtos_tpu/solver/solve.py:209); no Pallas kernel: XLA fuses it",
        # phase 4's B=8192 solve: one launch per LM iteration
        launches=main_asm_launches,
        launches_replan=runner_launches["asm_replan"],
        launches_runner=runner_launches["asm_runner"],
        launches_sharded=sharded_launches["assemble"],
        launches_towr=towr_launches["assemble"],
        device_launches_per_solve=tick_row.pop("asm_device_launches_per_solve"),
        registers=asm_regs,
        spill_stores_bytes=asm_spills,
        **asm_row,
    )
    scan_launches, hold_launches = runner_launches["tick_runner"]
    tick_row = dict(
        name="tick",
        route="cuda",
        source="qtos_torch/csrc/tick.cu",
        replaces="qtos_tpu/control/loop.py:275 (_scan_ticks, the jax.lax.scan of the jitted playback and "
                 "playback_recorded; stance_warmup's scan at :348); no Pallas kernel: XLA compiles the scan",
        # the exp_1 walk (phase 8b): one playback launch per executed chunk, one warm-up
        launches=scan_launches + hold_launches,
        launches_playback=scan_launches,
        launches_hold=hold_launches,
        launches_batched_playback=sum(playback_out["launches"]),
        registers=tick_regs,
        spill_stores_bytes=tick_spills,
        **tick_row,
    )
    restore_row = dict(
        name="lm_restore",
        route="cuda",
        source="qtos_torch/csrc/lm_restore.cu",
        replaces="no Pallas kernel: the torch.where accept/select of the LM loop (qtos_tpu's jnp.where in the "
                 "loop of qtos_tpu/solver/solve.py, fused by XLA)",
        # phase 4's B=8192 solve: one launch per LM iteration, like the assembly's
        launches=main_restore_launches,
        launches_quick_start=playback_out["restore_quick_start"],
        launches_replan=runner_launches["restore_replan"],
        launches_runner=runner_launches["restore_runner"],
        launches_sharded=sharded_launches["restore"],
        launches_towr=towr_launches["restore"],
        **restore_row,
    )
    print(json.dumps({"kernels": [row, small_row, tick_row, asm_row, restore_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--device-launches"]:
        count_device_launches()
    else:
        main()
