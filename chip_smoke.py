#!/usr/bin/env python3
"""Smoke run of qtos_torch on one CUDA card: builds the kernel from the
checkout, holds it against its plain PyTorch version, drives the batched
gait-NLP solve at bench width, plays solved trajectories through the physics,
probes a feasibility map and plans over it, walks the exp_1 preset to its goal
with the receding-horizon runner, and checks the results.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/btd.cu with nvcc for sm_90a (ptxas report: registers);
  3. kernel vs plain version on random SPD systems (the shapes of the
     tests and those of the driven paths: B=1, K=33; B=20, K=25; B=4, B=64,
     B=1024 and B=8192, K=41; B=3 and B=512, K=13; n=36) and on a Levenberg-Marquardt system of the main path;
     times of the kernel, the plain version, the library Thomas loop, and
     the bound; the kernel's GB/s against the bound's bytes
     and against the bytes its design moves, its GFLOP/s, registers, shared
     memory per block and resident warps per SM;
  4. the main path: solve_batch on the bench distribution (plane x3, K=41,
     goals 0.3..0.8, max_iters=3, rescue_iters=12) at B=1024 and B=8192,
     with the kernel's launch counter, convergence and the 1 kHz table;
  5. the port on CUDA against the port on CPU at B=64, K=41;
  6. physics playback: (a) the library quick start (plan, solve, sample,
     500 warm-up ticks, 1 kHz playback) on the card; (b) 256 episodes of
     phase 4's B=1024 result played in one batched call, with wall time, ms
     per tick and episode-ticks per second; (c) 4 of those episodes, 500
     ticks, on the card against the CPU;
     (d) exp_2's first riser: one window over step_2's riser, solved on the
     CPU, played on the card and on the CPU from the same table and start
     state in lock step: the first tick and leaf at which they part, and
     how far apart they end;
  7. planner: the solver-probed feasibility map of the pillar tile (one
     solve_batch over every candidate hop, K=25), the kernel's launches and
     the failed hops, then A* and the global planner over that map;
  8. the receding-horizon runner: one replan timed alone, the exp_1 preset
     walked to its goal, a two-window checkpoint restored bit for bit;
  9. scenario sharding: solve_batch_sharded under NCCL at world size 1 on
     the bench distribution at B=1024, equal bit for bit to solve_batch,
     its gathered statuses equal to the local ones, and the kernel's
     launches; over two ranks with an uneven batch when the host has two
     cards.
Phase 4 also profiles one solve_batch call at B=8192 (kernel time by name,
the BTD kernel's and assembly's shares, the device's idle share).
The second-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
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
# The shapes of the tests, then those the driven paths give the kernel: the
# quick start's single K=33 window (phase 6a), the feasibility probe's 20 K=25
# windows (phase 7; its rescue pass gathers all 20), the runner's 4 candidate
# windows per replan (phase 8), phase 5's B=64, the ranks' slices of phase 9's
# two-card run (B=5 and 1023 over two ranks, K=13: 3 and 512 each), phase 4's
# and phase 9's B=1024, and the bench batch (phase 4), which is the one timed.
SHAPES = [(3, 7, 12), (2, 5, 36), (1, 9, 5), (5, 4, 6), (1, 33, 36), (20, 25, 36), (4, 41, 36),
          (64, 41, 36), (3, 13, 36), (512, 13, 36), (1024, 41, 36), (8192, 41, 36)]


def _synced(dev) -> float:
    """The host clock once the device has drained its queue."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def phase_playback(dev, card, terrain, x, specs, warmup=500, compare_ticks=500) -> None:
    """Phase 6.  `x` (B, K, NV) and `specs` are solved windows on `terrain`
    (phase 4's, every fourth scenario)."""
    import torch

    from qtos_torch.control import ControlParams, playback, stance_warmup
    from qtos_torch.control.loop import state_from_row
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve
    from qtos_torch.solver.spec import map_tensors
    from qtos_torch.terrain import make_terrain

    params = ControlParams()

    def episode(tables, terr):
        """Warm-up and playback; (final, metrics, warm-up s, playback s)."""
        t0 = _synced(tables.device)
        s0 = stance_warmup(state_from_row(tables[..., 0, :], terr, params), terr, params, warmup)
        t1 = _synced(tables.device)
        final, m = playback(tables, s0, terr, params)
        return final, m, t1 - t0, _synced(tables.device) - t1

    # 6a: the library quick start
    t0 = time.time()
    terr2 = make_terrain(["plane", "plane"], device=dev)
    spec = default_spec(terr2, goal_xy=(0.5, 0.0), K=33, device=dev)
    btd_solve.launches = 0
    res = solve(spec, terr2, SolverConfig(max_iters=30))
    launches, iters = btd_solve.launches, int(res.iters.max())
    if dev.type == "cuda" and launches < iters:      # main() always passes the card
        fail(f"phase 6a: the quick start's solve launched the kernel {launches} times in {iters} iterations")
    status = int(res.status)
    table, _ = sample_trajectory(res.x, spec)
    final, m, warm_s, play_s = episode(table, terr2)
    T1 = table.shape[0]
    ms_tick_1 = play_s / T1 * 1e3
    plan_end = table[-1, 1:4].cpu()
    pos = final.pos.cpu()
    err_s = float(m.avg_com_err_per_s)
    line = (f"# phase 6a quick start (K=33, {T1} rows): status {status}, btd launches {launches} in "
            f"{iters} iterations, avg_com_err_per_s {err_s:.2f}, "
            f"final pos ({pos[0]:.4f}, {pos[1]:.4f}, {pos[2]:.4f}) vs plan end "
            f"({plan_end[0]:.4f}, {plan_end[1]:.4f}, {plan_end[2]:.4f}); warm-up {warmup} ticks "
            f"{warm_s:.2f} s, playback {play_s:.2f} s = {ms_tick_1:.3f} ms per tick at B=1 on {card}")
    if not (status == 0 and err_s < 60.0 and abs(float(pos[0] - plan_end[0])) < 0.12
            and abs(float(pos[2] - plan_end[2])) < 0.03):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")

    # 6b: full width, B episodes in one batched call
    t0 = time.time()
    B = x.shape[0]
    tables, _ = sample_trajectory(x, specs)
    T = tables.shape[1]
    final, m, warm_s, play_s = episode(tables, terrain)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (m.com_err, m.ee_err, m.pos, m.feet, m.yaw, final.pos, final.q, final.qd))
    goal_x = specs.goal_r[:, 0]
    z_ok = bool(((final.pos[:, 2] > 0.1) & (final.pos[:, 2] < 0.4)).all())
    x_ok = bool((final.pos[:, 0] > 0.5 * goal_x).all())
    mean_err = m.com_err.mean(dim=-1)
    ms_tick = play_s / T * 1e3
    line = (f"# phase 6b playback B={B} (K={x.shape[1]}, tables {tuple(tables.shape)}): warm-up {warmup} ticks "
            f"{warm_s:.2f} s, playback {play_s:.2f} s = {ms_tick:.3f} ms per tick, "
            f"{B * T / play_s:.0f} episode-ticks/s (B=1: {ms_tick_1:.3f} ms per tick) on {card}; "
            f"finite {finite}, final z in [{float(final.pos[:, 2].min()):.3f}, {float(final.pos[:, 2].max()):.3f}], "
            f"min final x / goal {float((final.pos[:, 0] / goal_x).min()):.3f}, "
            f"mean com_err max {float(mean_err.max()):.4f} m, "
            f"avg_com_err_per_s in [{float(m.avg_com_err_per_s.min()):.2f}, {float(m.avg_com_err_per_s.max()):.2f}]")
    if not (finite and z_ok and x_ok and bool((mean_err < 0.15).all())):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")

    # 6c: the card against the CPU on 4 of those episodes
    t0 = time.time()
    short = tables[:4, :compare_ticks]
    cpu_terr = map_tensors(terrain, lambda t: t.cpu())
    f_dev, m_dev, _, _ = episode(short, terrain)
    f_cpu, m_cpu, _, _ = episode(short.cpu(), cpu_terr)
    dpos = float((f_dev.pos.cpu() - f_cpu.pos).abs().max())
    dq = float((f_dev.q.cpu() - f_cpu.q).abs().max())
    rel = float(((m_dev.avg_com_err_per_s.cpu() - m_cpu.avg_com_err_per_s).abs()
                 / m_cpu.avg_com_err_per_s).max())
    line = (f"# phase 6c CUDA vs CPU, 4 episodes, {warmup} warm-up + {short.shape[1]} ticks: max |dpos| {dpos:.3e} m, "
            f"max |dq| {dq:.3e} rad, avg_com_err_per_s differs by {100 * rel:.3f} %")
    # Both devices run the same float32 operations; on flat ground every run
    # on an H100 gave 4.5e-7 m, 2.2e-6 rad and 0.001 %.  The gates leave two
    # orders of magnitude above that for other cards and library versions.
    if not (dpos <= 1e-4 and dq <= 5e-4 and rel <= 0.005):
        fail(line)
    log(line + f" ({time.time() - t0:.1f} s)")


# Phase 6d's gates: card against CPU over exp_2's first riser.  On an H100 the
# position and contact leaves agreed to 1e-6 until tick 562 (the first
# touchdown after a front foot has borne load on the riser's ramp) and ended
# 7.9e-3 m and 2.65e-2 rad apart after the window's 2,501 ticks, where flat
# ground holds 4.5e-7 m (6c).  The gates leave a margin of ~5x at the end and
# require agreement until the feet reach the riser.
RISER_DPOS, RISER_DQ, RISER_FIRST_TICK = 4e-2, 0.15, 400


def phase_riser(dev, card, ticks=None) -> None:
    """Phase 6d.  The window is solved and warmed up on the CPU and copied
    to the card bit for bit, so only the playback differs."""
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


def phase_planner(dev, card) -> None:
    """Phase 7."""
    import numpy as np
    import torch

    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.planner import GlobalPlanner, astar, feasibility_map
    from qtos_torch.planner.feasibility import probe_specs
    from qtos_torch.solver import SolverConfig, solve_batch
    from qtos_torch.terrain import make_terrain

    t0 = time.time()
    tiles, goal, K, max_iters = ["feasibility", "plane"], (2.6, 0.0), 25, 25
    terrain = make_terrain(tiles, device=dev)
    cfg = SolverConfig(max_iters=max_iters, tol=6e-3)
    btd_solve.launches = 0
    t1 = _synced(dev)
    fmap = feasibility_map(terrain, cfg=cfg, K=K)
    probe_s = _synced(dev) - t1
    launches = btd_solve.launches

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
            f"btd launches {launches}, {probe_s:.3f} s on {card}; {int(blocked.sum())}/{blocked.size} cells blocked")
    if dev.type == "cuda" and launches < max_iters:
        fail(line + f": the probe launched the kernel {launches} times, < max_iters {max_iters}")
    if not blocked[grid > 0.1].all():
        fail(line + ": a pillar cell is not blocked")
    if blocked.all(axis=0).any():
        fail(line + ": some column is fully blocked")
    if route is None:
        fail(line + ": the map sealed the corridor shut")
    log(line)

    # The rescue pass on the probe's windows: its first scenarios that fail
    # pass 1 (phase 4's distribution converges whole, so it never enters).
    t1 = _synced(dev)
    res2 = solve_batch(specs, terrain, cfg.replace(rescue_iters=12))
    rescue_s = _synced(dev) - t1
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
    kernel's launches in 8a's replan and 8b's run."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from qtos_torch.builder import build
    from qtos_torch.control.replan import SIM_LEAVES, RunnerConfig, plan_windows_batch
    from qtos_torch.ops.btd import btd_solve
    from qtos_torch.runtime import native_available
    from qtos_torch.solver.spec import RobotState

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
    st = RobotState.standing((torch.zeros(k, device=dev), torch.zeros(k, device=dev)),
                             terrain=terrain, device=dev)
    zeros = torch.zeros((k, 12), device=dev)
    rows = torch.cat([zeros[:, :1], st.r, st.eul, st.feet.reshape(k, 12), st.v, st.omega, zeros], dim=-1)
    goals = st.r + torch.stack([0.55 - 0.05 * torch.arange(k, device=dev),
                                torch.zeros(k, device=dev), torch.zeros(k, device=dev)], dim=-1)
    gyaws = torch.zeros(k, device=dev)
    for _ in range(2):                        # the second call is the timed one
        btd_solve.launches = 0
        t1 = _synced(dev)
        res, tables, _ = plan_windows_batch(rows, goals, gyaws, terrain, cfg)
        replan_s = _synced(dev) - t1
    replan_launches = btd_solve.launches
    n_conv = int((res.status == 0).sum())
    line = (f"# phase 8a replan (plan_windows_batch, B={k}, K={cfg.K}, max_iters={cfg.solver.max_iters}): "
            f"{replan_s * 1e3:.1f} ms on {card}, btd launches {replan_launches}, {n_conv}/{k} converged, "
            f"tables {tuple(tables.shape)}; the kernel against its plain version at "
            f"({k}, {cfg.K}, 36) is phase 3's row of that shape")
    if on_card and replan_launches != cfg.solver.max_iters:
        fail(line + f": expected {cfg.solver.max_iters} launches")
    if not (n_conv >= 1 and bool(torch.isfinite(tables).all())):
        fail(line)
    log(line)

    # 8b: the preset, start to goal
    runner = bundle.runner
    btd_solve.launches = 0
    t1 = _synced(dev)
    rep = runner.run(verbose=True)
    wall = _synced(dev) - t1
    launches = btd_solve.launches
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
            f"{' + escalations' if runner.escalations else ''}); wall {wall:.2f} s on {card} = "
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
        ok = ok and launches == want
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
    log(line + f" ({time.time() - t1:.1f} s; phase 8 done in {time.time() - t0:.1f} s)")
    return {"replan": replan_launches, "runner": launches}


def phase_sharded(dev, card, B=1024, two_rank_batches=(5, 1023)) -> int:
    """Phase 9.  Returns the kernel's launches in the sharded solve.  On the
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
        btd_solve.launches = 0
        sharded = solve_batch_sharded(specs, terrain, cfg, mesh)
        launches = btd_solve.launches
        x_loc, st_loc, st_all = solve_batch_collective(specs, terrain, cfg, mesh)
    finally:
        dist.destroy_process_group()
    same_x, same_st = torch.equal(sharded.x, plain.x), torch.equal(sharded.status, plain.status)
    gathered = torch.equal(st_all, st_loc) and torch.equal(st_all, plain.status) and torch.equal(x_loc, plain.x)
    line = (f"# phase 9 solve_batch_sharded ({backend}, world size {mesh.world}, B={B}, K={K}) on {card}: "
            f"x equal to solve_batch's bit for bit {same_x}, statuses {same_st}; gathered statuses equal the "
            f"local ones {gathered}; {int((sharded.status == 0).sum())}/{B} converged; btd launches {launches}")
    if not (backend == ("nccl" if on_card else "gloo") and same_x and same_st and gathered
            and (launches >= cfg.max_iters or not on_card)):
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
    return launches


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
    from qtos_torch.tools import profile_solve

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
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        path = btd_mod.build(verbose=True)
    report = report.getvalue()
    log(report.rstrip())
    regs = re.search(r"Used (\d+) registers", report)
    regs = int(regs.group(1)) if regs else None
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
            occ = btd_mod.occupancy(n)
            dbytes = design_bytes(B, K, n)
            line += (f"\n# phase 3 rates B={B} K={K} n={n} on {card}: "
                     f"{nbytes / ms / 1e6:.1f} GB/s of the bound's {nbytes / 1e9:.3f} GB, "
                     f"{dbytes / ms / 1e6:.1f} GB/s of the design's {dbytes / 1e9:.3f} GB "
                     f"(design floor {dbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms), "
                     f"{flops / ms / 1e6:.1f} GFLOP/s; {regs} registers per thread, "
                     f"{occ['smem_per_block']} B shared memory per block, "
                     f"{occ['warps_per_sm']} resident warps per SM")
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
    played = None
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
        if B == 1024:
            played = (res.x[::4].clone(), index_spec(specs, slice(None, None, 4)))

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

    phase_playback(dev, card, terrain, *played)
    phase_riser(dev, card)
    phase_planner(dev, card)
    runner_launches = phase_runner(dev, card)
    sharded_launches = phase_sharded(dev, card)

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
        launches_sharded=sharded_launches,
        max_abs_err=max_err_all,
        max_err=max_err_all,
        **kernel_row,
    )
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
