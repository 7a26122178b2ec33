"""Receding-horizon replanning: the continuous-walking loop (port of
`qtos_tpu.control.replan`).

Reference architecture (scripts/main.py:26-62 + QTOS/combiner.py): a Python
thread re-invokes the Docker TOWR solver from a predicted future state found
by scanning the trajectory CSV for an all-feet-in-contact row ~3750 rows
ahead (``lookahead``), then truncate-and-concats CSVs while the sim consumes
rows in real time (forced-execution prefix ``f_steps`` = 2500).

Here the trajectory lives in a device buffer with a host mirror (the native
ring buffer of `qtos_torch.runtime`); stitching is a slice assignment; the
stitch row search scans the mirror's contact masks; planning solves
``n_candidates`` alternative windows in ONE batched solve; execution is the
1 kHz control loop of `control.loop`.  The host loop only sequences windows:
it enqueues the planning solve, then the execution chunk, and reads the
solve's status back only after both are enqueued, so neither waits on the
other at the host level (the reference overlaps them with a thread).

Failure policy (reference: initial-solve returncode abort scripts/main.py:
93-103, horizon watchdog QTOS/combiner.py:223-225, stance as safe state
QTOS/robot/robot.py:527-561): pick the first converged candidate; else the
best candidate below ``usable_viol``; else re-solve warm-started with
escalated iterations; else stitch a stance-hold segment (the robot marks
time safely) and retry — aborting after ``max_consec_failures`` consecutive
failed windows.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from qtos_torch.control.loop import (
    ControlParams,
    decode_row,
    gait_control_params,
    playback,
    stance_warmup,
    state_from_row,
)
from qtos_torch.device import resolve_device
from qtos_torch.models.solo12 import Solo12
from qtos_torch.ops import btd
from qtos_torch.planner.global_planner import GlobalPlanner
from qtos_torch.runtime import RingBuffer
from qtos_torch.sim.engine import SimState
from qtos_torch.solver.gait import GaitSchedule, make_schedule
from qtos_torch.solver.sampler import sample_trajectory
from qtos_torch.solver.solve import STATUS_CONVERGED, _solve_pass
from qtos_torch.solver.spec import (
    NV,
    ProblemSpec,
    RobotState,
    SolverConfig,
    map_tensors,
    pack_state,
    unpack_state,
)
from qtos_torch.terrain.heightfield import Terrain, height_at, traversability_map
from qtos_torch.utils.containers import LimitedFIFOQueue, LimitedStack
from qtos_torch.utils.profiling import annotate

# Checkpoints number the simulator's leaves `sim_0`, `sim_1`, ... in this
# order: the order in which `qtos_tpu` flattens its SimState, so the
# checkpoints of the two packages stay interchangeable.
SIM_LEAVES = ("pos", "quat", "v", "w", "q", "qd", "anchor")


@dataclass
class RunnerConfig:
    lookahead: int = 3750        # rows (reference: scripts/main.py:177)
    f_steps: int = 2500          # forced-execution rows (main.py:176)
    window_duration: float = 2.5
    K: int = 41
    buffer_rows: int = 60000     # analog of TRAJ_SIZE (simulation.yml)
    goal_tol: float = 0.1        # reference: main.py:40 goal_diff < 0.1
    avg_speed: float = 0.22
    stance_warmup_steps: int = 500
    max_windows: int = 64
    gait: str = "trot"           # key into solver.gait.GAIT_REGISTRY
    # Speculative candidate windows per replan, solved in ONE batched call:
    # stitch targets at lookahead + i*candidate_stride rows.  The first
    # converged candidate wins (earliest stitch = least plan latency); later
    # candidates are fallbacks.
    n_candidates: int = 4
    candidate_stride: int = 250
    # Safety rail on the CUMULATIVE drift-following shift [m]: replan-from-
    # reality may move the plan frame at most this far from the path-anchored
    # frame (prevents a pathologically slipping controller from being chased
    # off the map; see _row_shift).  Loose by design — tightening it couples
    # into the stitch dynamics and degrades well-tracking runs.
    drift_cap_total: float = 0.6
    # Failure policy thresholds (see module docstring).
    usable_viol: float = 3e-2    # accept an unconverged window below this
    escalate_iters: int = 40     # extra warm-started iterations before fallback
    max_consec_failures: int = 3 # watchdog (reference: combiner.py:223-225)
    # Sim-health watchdog (tracking-side twin of the solver-side policy): the
    # robot is "fallen" when its base sits below fallen_z above the terrain
    # (stand height is 0.24) -> abort; a window whose MEAN CoM tracking error
    # exceeds divergence_err while upright triggers a stance-hold at the
    # measured state + replan-from-reality, aborting after
    # max_consec_failures consecutive divergent windows.
    fallen_z: float = 0.15
    divergence_err: float = 0.12
    # Gain on the replan-level heading reset: each window's start yaw is
    # rotated by gain * (filtered live-vs-plan yaw residual), so the solver
    # plans the turn-back from the robot's actual heading (0 = plan from the
    # path heading and let the live-frame controller absorb the mismatch).
    yaw_reset_gain: float = 0.3
    # Goal backoff fraction per speculative candidate: candidate i aims
    # (1 - i*backoff) of the window advance along the spine.  In steady state
    # the stitch targets clamp to the buffer tail and coincide — the backoff
    # keeps fallback candidates genuinely different (an easier, shorter-step
    # NLP), so "first converged wins" is a real fallback tier.
    candidate_goal_backoff: float = 0.12
    # Terrain-aware pacing: each window's spine advance is scaled by
    # 1 / (1 + rough_pace * height_span) of the upcoming segment — full speed
    # on flat, slower over steps.  Default OFF: on banded terrain (exp_2)
    # pacing at 8.0 made the run worse (the shorter paced steps put more
    # touchdowns near band edges while the gait cadence stays fixed).  Kept
    # as a config lever; the stair presets turn it on.
    rough_pace: float = 0.0
    # Curvature-aware pacing: window advance scaled by
    # 1 / (1 + turn_pace * total_heading_change) of the upcoming segment.
    # Every observed catastrophic obstacle-detour failure was a sharp spine
    # curve executed at full speed; straight segments are unaffected.
    turn_pace: float = 1.2
    # Terrain-adaptive swing clearance: windows whose upcoming path segment
    # spans more than rough_span_thresh of height solve with
    # rough_clearance as the swing apex instead of solver.swing_clearance.
    # Both matter: at 0.06 the toe clips exp_6's sharp 0.11 m riser, while a
    # GLOBAL 0.14 destabilizes flat-ground windows (the higher swing pumps
    # lateral momentum).  0 disables.
    rough_clearance: float = 0.0
    rough_span_thresh: float = 0.06
    # Warm-starting candidate windows from the shifted previous solution is
    # available but off by default: the fresh schedule-aware guess aligns gait
    # phases with the new window's head stance, which empirically tracks better.
    warm_start: bool = False
    # Optional dynamic-terrain hook: (window_idx, terrain) -> terrain, applied
    # before each replan (reference: exp_8 dynamic terrain / simulation.update).
    terrain_update: object = None
    # Checkpoint/resume: write a full resume snapshot every N windows (0 =
    # off) to checkpoint_path.
    checkpoint_every: int = 0
    checkpoint_path: str = "./data/checkpoint.npz"
    # Wall-clock-paced execution (reference scripts/run.py:166-169 gates
    # every sim tick on wall clock to prove the 1 kHz contract).  With
    # realtime=True each executed chunk is released at its wall-clock
    # deadline while replans keep landing; the run then REPORTS buffer
    # underruns (consumer starved because planning fell behind) and the
    # achieved wall-clock / sim-time ratio.
    realtime: bool = False
    solver: SolverConfig = field(
        default_factory=lambda: SolverConfig(max_iters=30, tol=3e-3)
    )
    # None -> resolved per gait (control.loop.gait_control_params; the
    # reference also swaps gain sets by gait, robot_motor.py:111 UPDATE_GAIT)
    control: ControlParams | None = None


@dataclass
class RunReport:
    reached_goal: bool
    windows: int
    sim_ticks: int
    final_pos: np.ndarray
    goal: np.ndarray
    mean_com_err: float
    max_com_err: float
    avg_com_err_per_s: float
    solve_wall_times: list
    statuses: list
    com_err_series: np.ndarray = None   # (T,) per-tick CoM error (plots)
    ee_err_series: np.ndarray = None    # (T,) per-tick mean foot error
    sim_pos_series: np.ndarray = None   # (T, 3) realized CoM positions
    sim_feet_series: np.ndarray = None  # (T, 4, 3) realized foot positions
    ref_table: np.ndarray = None        # (T, 37) the executed plan rows
    aborted: bool = False               # watchdog fired
    stance_holds: int = 0               # fallback segments stitched
    # --realtime mode (reference scripts/run.py:166-169 keep_time): buffer
    # starvation events while pacing consumption at 1 kHz, and achieved
    # wall-clock / sim-time ratio (1.0 = exact real time)
    underruns: int = 0
    realtime_factor: float = 0.0


def _np(t) -> np.ndarray:
    """A host numpy COPY of a tensor (`.numpy()` of a CPU tensor shares its
    storage, and snapshots must not follow the live buffers)."""
    return t.detach().cpu().numpy().copy()


def spec_from_row(row, goal_r, goal_yaw, terrain: Terrain | None, K: int, duration: float,
                  schedule: GaitSchedule | None = None) -> ProblemSpec:
    """Build the next window's spec from trajectory rows (..., 37) — the
    analog of the reference solver restart ABI (-s/-s_ang/-s_vel/-e1..e4
    flags, combiner.py:170-191).  With leading axes the result is one batched
    spec (the counterpart of `jax.vmap` over `qtos_tpu`'s `spec_from_row`):
    `goal_r` is (..., 3), `goal_yaw` (...), the schedule is shared."""
    cmd = decode_row(row)
    start = RobotState(r=cmd["r"], eul=cmd["eul"], v=cmd["v"], omega=cmd["w"], feet=cmd["feet"])
    dt = duration / (K - 1)
    if schedule is None:
        schedule = make_schedule("trot", K, dt, device=row.device)
    lead = row.shape[:-1]
    if lead:
        schedule = map_tensors(schedule, lambda t: t.expand(lead + t.shape[-2:]).contiguous())
    return ProblemSpec(
        start=start,
        goal_r=goal_r,
        goal_yaw=goal_yaw,
        duration=torch.full(lead, duration, dtype=row.dtype, device=row.device),
        schedule=schedule,
        dt=dt,
    )


def _rot_xy(v, ca, sa):
    """(..., 2) vectors rotated by the angle whose cosine and sine are given."""
    return torch.stack([ca * v[..., 0] - sa * v[..., 1],
                        sa * v[..., 0] + ca * v[..., 1]], dim=-1)


def _plan_batch_core(rows, goals_r, goals_yaw, t0s, x0, drift3, dyaw, terrain,
                     scfg: SolverConfig, K: int, duration: float, gait: str):
    """Replan core: drift shift + spec construction + batched solve + 1 kHz
    sampling, all on the rows' device with no read back to the host, so a
    replan is enqueued whole.

    `dyaw` is the measured live-vs-plan heading residual: the candidate start
    states are rotated by it (yaw, feet about the CoM, velocity) so each
    window is planned FROM the robot's actual heading while the spine
    goal-yaw pulls it back — the heading twin of the xy drift shift.  Unlike
    xy there is no double-count bookkeeping: plan rows carry absolute yaw, so
    the next residual is measured directly against the already-turned plan.

    `rows` is not written to: every step below builds new tensors."""
    k = rows.shape[0]
    with annotate("qtos::replan.start", k):
        feet_pre = rows[:, 7:19].reshape(k, 4, 3)
        r_pre = rows[:, 1:4]
        r = r_pre + drift3
        yaw = rows[:, 6] + dyaw
        feet = feet_pre + drift3
        # rotate feet about the (shifted) CoM and the velocity by the yaw residual
        ca, sa = torch.cos(dyaw), torch.sin(dyaw)
        feet_xy = r[:, None, :2] + _rot_xy(feet[:, :, :2] - r[:, None, :2], ca, sa)
        feet_z = feet[..., 2]
        r_z = r[:, 2]
        # Re-seat z on the terrain: the drift/yaw shift moves feet in xy but the
        # rows carry z from the ORIGINAL xy — on banded terrain a 0.1-0.3 m shift
        # strands a stance foot 2-7 cm off the surface, making the start state
        # terrain-infeasible.  Shifting z by the local terrain delta preserves
        # both stance seating and swing clearance; the CoM rides the same delta.
        if terrain is not None:
            with annotate("qtos::terrain.reseat", k):
                h_pre = height_at(terrain, feet_pre[..., 0], feet_pre[..., 1])
                h_post = height_at(terrain, feet_xy[..., 0], feet_xy[..., 1])
                feet_z = feet_z + (h_post - h_pre)
                hc_pre = height_at(terrain, r_pre[:, 0], r_pre[:, 1])
                hc_post = height_at(terrain, r[:, 0], r[:, 1])
                r_z = r_z + (hc_post - hc_pre)
        feet = torch.cat([feet_xy, feet_z[..., None]], dim=-1)
        v_rot = _rot_xy(rows[:, 19:21], ca, sa)
        rows = torch.cat(
            [rows[:, 0:1], r[:, :2], r_z[:, None], rows[:, 4:6], yaw[:, None],
             feet.reshape(k, 12), v_rot, rows[:, 21:]], dim=-1)
        dt = duration / (K - 1)
        schedule = make_schedule(gait, K, dt, device=rows.device)
        specs = spec_from_row(rows, goals_r, goals_yaw, None, K, duration, schedule)
    res = _solve_pass(specs, terrain, scfg, x0)
    with annotate("qtos::sample", k):
        tables, contacts = sample_trajectory(res.x, specs, hz=1000, t0=t0s)
    return res, tables, contacts


def plan_windows_batch(rows, goals_r, goals_yaw, terrain: Terrain, cfg: RunnerConfig,
                       t0s=None, x0=None, solver_cfg: SolverConfig | None = None,
                       drift3=None, dyaw=None):
    """Solve k candidate windows in ONE batched call (the multi-segment
    speculative lookahead).

    This is the runner's planning primitive: `RecedingHorizonRunner` calls it
    every replan with the stitch-target alternatives.

    Args:
      rows: (k, 37) candidate start rows, on the terrain's device.
      goals_r: (k, 3); goals_yaw: (k,).
      t0s: (k,) path times stamped into each table's column 0 (default 0).
      x0: optional (k, K, NV) warm starts.
      solver_cfg: overrides cfg.solver (e.g. escalation iterations).
      drift3: (3,) shift of the start states; dyaw: () their yaw rotation.
    Returns (SolveResult, tables (k, T, 37), contacts (k, T, 4)) — all
    tensors on that device; nothing here reads one back to the host.
    """
    with annotate("qtos::replan", rows.shape[0]):
        scfg = solver_cfg if solver_cfg is not None else cfg.solver
        f32 = dict(dtype=rows.dtype, device=rows.device)
        if t0s is None:
            t0s = torch.zeros(rows.shape[0], **f32)
        if drift3 is None:
            drift3 = torch.zeros(3, **f32)
        if dyaw is None:
            dyaw = torch.zeros((), **f32)
        return _plan_batch_core(
            rows, goals_r, goals_yaw, t0s, x0, drift3, dyaw, terrain,
            scfg=scfg.replace(rescue_iters=0), K=cfg.K,
            duration=cfg.window_duration, gait=cfg.gait,
        )


def stance_table(row, n_rows: int, t0: float):
    """A hold-position trajectory segment: the safe-state fallback (reference:
    QTOS/robot/robot.py:527-561 default_stance_control).  All feet in stance,
    gravity-balancing forces, zero velocities."""
    f32 = dict(dtype=row.dtype, device=row.device)
    cmd = decode_row(row)
    fz = Solo12.mass * 9.81 / 4.0
    forces = torch.tensor([0.0, 0.0, fz], **f32).repeat(4)
    base = torch.cat(
        [torch.zeros(1, **f32), cmd["r"], cmd["eul"], cmd["feet"].reshape(12),
         torch.zeros(6, **f32), forces]
    )
    times = t0 + torch.arange(n_rows, **f32) / 1000.0
    table = torch.cat([times[:, None], base[None, 1:].expand(n_rows, -1)], dim=-1)
    contact = torch.ones((n_rows, 4), **f32)
    return table, contact


class RecedingHorizonRunner:
    """Continuous long-distance locomotion via window stitching.

    `device=None` means CUDA; the terrain must live on that device, and
    everything the runner builds (buffers, planner, specs) is put there."""

    def __init__(
        self,
        terrain: Terrain,
        goal_xy,
        start_xy=(0.0, 0.0),
        cfg: RunnerConfig | None = None,
        blocked: np.ndarray | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if terrain.device != self.device:
            raise ValueError(f"terrain lives on {terrain.device}, the runner was asked for {self.device}")
        self.terrain = terrain
        self.cfg = cfg or RunnerConfig()
        # resolved locally — never written back into the caller's config (a
        # RunnerConfig shared across runners with different gaits must not
        # leak the first runner's resolved gains into the second)
        self.control = self.cfg.control or gait_control_params(self.cfg.gait)
        self.goal_xy = np.asarray(goal_xy, np.float32)
        # kept for global replans after dynamic-terrain events: new obstacles
        # add their own blocked cells ON TOP of the startup (possibly
        # solver-probed) map
        self._blocked0 = None if blocked is None else np.asarray(blocked)
        self.planner = GlobalPlanner(
            terrain, start_xy, goal_xy, avg_speed=self.cfg.avg_speed, blocked=blocked
        )
        c = self.cfg
        self._f32 = dict(dtype=torch.float32, device=self.device)
        self.seg_rows = int(round(c.window_duration * 1000)) + 1
        self.buffer = torch.zeros((c.buffer_rows, 37), **self._f32)
        self.contact_buf = torch.zeros((c.buffer_rows, 4), **self._f32)
        # host-side mirror of the stitched trajectory: the native C++ ring
        # buffer (qtos_torch/runtime) — serves the stitch-row scan, drift
        # lookups, candidate metadata and end-of-run readback without device
        # round trips
        self.host_buf = RingBuffer(c.buffer_rows)
        # per-row cumulative xy shift applied when that row was planned,
        # relative to the path-anchored frame.  Needed to compute the RESIDUAL
        # drift shift for a new window: measuring raw (sim - row) against an
        # older segment and applying it on top of a newer, already-shifted
        # segment double-counts the correction and runs away.
        self._row_shift = np.zeros((c.buffer_rows, 2), np.float32)
        self.buffer_end = 0
        # rolling solve-latency window + bounded (start, goal) plan history
        # (reference: QTOS/containers.py LimitedFIFOQueue windowed averages,
        # Limited_Stack of plans in QTOS/planner.py:195-230)
        self.solve_ms_window = LimitedFIFOQueue(8)
        self.plan_history = LimitedStack(32)
        self._st: dict | None = None  # live run state (see state_dict)
        self.escalations = 0          # replans that went to the escalated re-solve

        # archived (already-executed) rows dropped from the live buffer by
        # `_maybe_compact` — concatenated back for the end-of-run report
        self._archive: list = []

    # -- execution -----------------------------------------------------
    def _exec_chunk(self, start: int, n_exec: int, s0):
        """Play rows [start, start + n_exec) of the buffer through the physics
        from sim state `s0`; returns (final state, TrackingMetrics).

        The slice is exactly the rows to execute, and none of them may lie at
        or past `buffer_end`: rows there are not final (zeros before their
        stitch) and must never reach the sim — they would command the CoM to
        the origin, and the IK's workspace clamp would turn that into a
        max-torque kick at every stitch boundary."""
        if start < 0 or n_exec <= 0 or start + n_exec > self.buffer_end:
            raise ValueError(f"execution chunk [{start}, {start + n_exec}) leaves the "
                             f"stitched rows [0, {self.buffer_end})")
        return playback(self.buffer[start : start + n_exec], s0, self.terrain, self.control)

    # -- planning ------------------------------------------------------
    def _candidate_rows(self, target: int, lo: int = 0):
        """Stitch-row candidates at/after target, one per candidate slot.
        In steady state the target clamps near the buffer tail and candidates
        can coincide — duplicates are harmless (selection takes the first
        converged)."""
        c = self.cfg
        hi = self.buffer_end
        ats = []
        for i in range(c.n_candidates):
            t = max(0, lo, min(target + i * c.candidate_stride, hi - 10))
            ats.append(self._find_stitch_row(t))
        return ats

    def _plan_dispatch(self, target: int, goal_r_final, x_warm=None,
                       drift_xy=None, lo: int = 0) -> dict:
        """Enqueue one replan: batched candidate solve + sampling.

        Nothing here waits on the device — the returned dict holds tensors
        still being computed plus the host-side candidate metadata, which
        comes from the host mirror.  The run loop dispatches this FIRST, then
        the execution chunk, and reads the solve's status only afterwards
        (the reference needs a replanning thread for the same overlap,
        scripts/main.py:26-62)."""
        c = self.cfg
        ats = self._candidate_rows(target, lo=lo)
        idx = torch.as_tensor(np.asarray(ats, np.int64), device=self.device)
        rows = self.buffer[idx]                          # (k, 37), a copy
        rows_host = np.stack([self.host_buf.read(at, 1)[0] for at in ats])
        # Replan from reality: the candidate start states get shifted (inside
        # the core) by the measured sim-vs-plan drift, so tracking error
        # resets at every stitch instead of compounding across windows.  The
        # live-frame controller sees relative targets, so the stitch-row
        # transition stays smooth.  (The reference feeds the live robot state
        # from its global-state bus into the next solve the same way —
        # QTOS/combiner.py:245-296 reading ROBOT_CFG.runtime.)
        d = np.zeros(2, np.float32)
        dyaw = 0.0
        if drift_xy is not None:
            # drift_xy = (sim - row(exec_now), S_exec, dyaw): the measured
            # tracking error plus the shift already baked into the row it was
            # measured against; subtract the candidate region's own baked-in
            # shift to get the residual to apply (see _row_shift above).
            # dyaw (heading residual) needs no such bookkeeping — plan rows
            # carry absolute yaw (see _plan_batch_core).
            d_meas, s_exec, dyaw_meas = drift_xy
            s_at = self._row_shift[ats[0]]
            want = np.asarray(d_meas, np.float32) + np.asarray(s_exec, np.float32) - s_at
            cap = self.cfg.drift_cap_total
            s_new = np.clip(s_at + want, -cap, cap)   # total shift stays anchored
            d = np.clip(s_new - s_at, -0.3, 0.3)
            dyaw = float(np.clip(self.cfg.yaw_reset_gain * dyaw_meas, -0.6, 0.6))
        drift3 = torch.as_tensor(np.array([d[0], d[1], 0.0], np.float32), device=self.device)
        dyaw_t = torch.as_tensor(np.float32(dyaw), device=self.device)
        t_paths = rows_host[:, 0].copy()

        row_xy = rows_host[:, 1:3] + d[None, :]
        goals, gyaws, finals = [], [], []
        for i, xy in enumerate(row_xy):
            # progress-projected spine time: immune to path-time running
            # ahead of actual progress during stance holds / drift
            t_spine = self.planner.time_at_position(xy)
            # goal backoff keeps clamped-target candidates distinct (an
            # easier shorter-step NLP as the fallback tier — see RunnerConfig)
            horizon = c.window_duration * (1.0 - c.candidate_goal_backoff * i)
            if c.rough_pace > 0:
                span = self.planner.height_span(t_spine, horizon)
                horizon *= 1.0 / (1.0 + c.rough_pace * span)
            if c.turn_pace > 0:
                turn = self.planner.turn_in(t_spine, horizon)
                horizon *= 1.0 / (1.0 + c.turn_pace * turn)
            gv, gy = self.planner.spine_step(t_spine, horizon)
            if np.linalg.norm(gv[:2] - goal_r_final[:2]) < c.goal_tol:
                gv = goal_r_final
                finals.append(True)
            else:
                finals.append(False)
            goals.append(gv)
            gyaws.append(gy)
        goals_np = np.stack(goals).astype(np.float32)
        goals = torch.as_tensor(goals_np, device=self.device)
        gyaws = torch.as_tensor(np.asarray(gyaws, np.float32), device=self.device)

        x0 = None
        if x_warm is not None:
            sched = make_schedule(c.gait, c.K, c.window_duration / (c.K - 1), device=self.device)
            x0 = self._shift_warm_start(
                x_warm,
                spec_from_row(rows, goals[0].expand(len(ats), 3), gyaws[0].expand(len(ats)),
                              self.terrain, c.K, c.window_duration, sched),
            )
        scfg = c.solver
        if c.rough_clearance > 0:
            t_sp = self.planner.time_at_position(row_xy[0])
            if self.planner.height_span(t_sp, c.window_duration) > c.rough_span_thresh:
                scfg = scfg.replace(swing_clearance=c.rough_clearance)
        res, tables, contacts = plan_windows_batch(
            rows, goals, gyaws, self.terrain, c,
            t0s=torch.as_tensor(t_paths, device=self.device),
            x0=x0, drift3=drift3, dyaw=dyaw_t, solver_cfg=scfg,
        )
        seg_shift = self._row_shift[ats[0]] + d
        return dict(ats=ats, rows=rows, rows_host=rows_host, t_paths=t_paths, goals=goals,
                    goals_host=goals_np, gyaws=gyaws, finals=finals, res=res, tables=tables,
                    contacts=contacts, drift3=drift3, dyaw=dyaw_t,
                    seg_shift=seg_shift, scfg=scfg)

    def _plan_finish(self, p: dict):
        """Select a candidate from a dispatched plan; escalate / fall back to
        stance-hold on failure.

        Returns (at, table, contact, status, viol, x_sel, is_final, failed)
        where `failed` means no candidate (even escalated) was usable.
        `table` is a stance-hold segment when failed."""
        c = self.cfg
        ats, res = p["ats"], p["res"]
        tables, contacts = p["tables"], p["contacts"]

        status = _np(res.status)        # host read: waits on the solve
        viol = _np(res.max_violation)
        sel = self._select(status, viol)
        if sel is None:
            # escalation: warm-started extra iterations on all candidates
            # (same clearance variant the dispatch chose)
            self.escalations += 1
            cfg2 = p.get("scfg", c.solver).replace(
                max_iters=c.escalate_iters, rescue_iters=0
            )
            res, tables, contacts = plan_windows_batch(
                p["rows"], p["goals"], p["gyaws"], self.terrain, c,
                t0s=torch.as_tensor(p["t_paths"], device=self.device), x0=res.x,
                solver_cfg=cfg2, drift3=p["drift3"], dyaw=p["dyaw"],
            )
            status = _np(res.status)
            viol = _np(res.max_violation)
            sel = self._select(status, viol)

        if sel is None:
            # stance-hold fallback at the earliest stitch row (drift applied,
            # so the hold happens where the robot actually is)
            best = int(np.argmin(viol))
            fams = {k: float(_np(v)[best]) for k, v in res.viol.items()}
            top = sorted(fams, key=fams.get, reverse=True)[:3]
            self.last_fail_viol = {k: fams[k] for k in top}
            # Failure forensics: dump the plan inputs of an unusable window so
            # the exact failing NLP can be re-solved and inspected offline
            # (QTOS's analog is reading the IPOPT log after a bad returncode;
            # here the problem is data, so we keep the data).
            try:
                np.savez(
                    os.path.join("logs", "failed_window.npz"),
                    rows=_np(p["rows"]), goals=_np(p["goals"]),
                    gyaws=_np(p["gyaws"]), t_paths=np.asarray(p["t_paths"]),
                    drift3=_np(p["drift3"]), dyaw=_np(p["dyaw"]),
                    status=status, viol=viol,
                    **{f"viol_{k}": _np(v) for k, v in res.viol.items()},
                )
            except OSError:
                pass
            at = ats[0]
            row0 = _np(p["rows"][0])
            d3 = _np(p["drift3"])
            row0[1:4] += d3
            row0[7:19] += np.tile(d3, 4)
            dy = float(_np(p["dyaw"]))
            row0[6] += dy
            ca, sa = np.cos(dy), np.sin(dy)
            rel = row0[7:19].reshape(4, 3)[:, :2] - row0[1:3]
            row0[7:19].reshape(4, 3)[:, :2] = row0[1:3] + rel @ np.array(
                [[ca, sa], [-sa, ca]], np.float32)
            table, contact = stance_table(torch.as_tensor(row0, device=self.device),
                                          self.seg_rows, float(p["t_paths"][0]))
            return at, table, contact, int(status.min()), float(viol.min()), None, False, True

        return (ats[sel], tables[sel], contacts[sel], int(status[sel]),
                float(viol[sel]), res.x[sel], p["finals"][sel], False)

    def _plan(self, target: int, goal_r_final, x_warm=None):
        """Dispatch + finish in one call (initial solve, tests)."""
        return self._plan_finish(self._plan_dispatch(target, goal_r_final, x_warm))

    def _select(self, status: np.ndarray, viol: np.ndarray):
        """First converged candidate, else best usable one, else None."""
        ok = np.flatnonzero(status == STATUS_CONVERGED)
        if ok.size:
            return int(ok[0])
        best = int(np.argmin(viol))
        if viol[best] < self.cfg.usable_viol:
            return best
        return None

    @staticmethod
    def _shift_warm_start(x_prev, spec):
        """Translate the previous solution (K, NV) so its start matches the
        new window's start state.  A batched `spec` (leading axes) gives one
        warm start per window."""
        s = unpack_state(x_prev)
        lead = spec.start.r.shape[:-1]
        d_r = spec.start.r - s["r"][0]                       # (..., 3)
        r = s["r"] + d_r[..., None, :]                       # (..., K, 3)
        p = s["p"] + d_r[..., None, None, :]                 # (..., K, 4, 3)
        p = torch.cat([spec.start.feet[..., None, :, :], p[..., 1:, :, :]], dim=-3)

        def wide(t):
            return t.expand(lead + t.shape)

        return pack_state(r, wide(s["th"]), wide(s["v"]), wide(s["w"]), p, wide(s["f"]))

    def _stitch(self, at: int, table, contact, shift_xy=None):
        n = table.shape[0]
        if shift_xy is not None:
            self._row_shift[at : at + n] = np.asarray(shift_xy, np.float32)
        # In place, in stream order: an execution chunk enqueued before this
        # stitch still reads the rows as they were.
        self.buffer[at : at + n] = table
        self.contact_buf[at : at + n] = contact
        # host mirror (native ring buffer): _find_stitch_row, the candidate
        # metadata and the report readback run against it.  This copy waits
        # for the table; `run` calls it after the execution chunk is enqueued.
        self.host_buf.stitch(at, _np(table), _np(contact))
        self.buffer_end = at + n

    def _find_stitch_row(self, target: int) -> int:
        """First all-feet-in-contact row at/after target (reference:
        combiner.py:245-296 scans the CSV for a four-contact row)."""
        hi = self.buffer_end
        target = min(target, hi - 1)
        r = self.host_buf.find_contact_row(target)
        if r < 0 or r >= hi:
            return hi - 1
        return r

    def _maybe_compact(self):
        """Drop already-executed rows when the buffer tail nears capacity.

        Long runs (exp_9: 11.5 m ~ 52k rows plus any stance holds) exceed the
        fixed buffer_rows; absolute row indices only ever grow, so we shift
        everything left by the executed prefix (keeping one row for the drift
        measurement) and archive the dropped rows for the report."""
        c = self.cfg
        st = self._st
        if self.buffer_end + 2 * self.seg_rows < c.buffer_rows:
            return
        shift = st["exec_idx"] - 1
        if shift <= 0:
            return
        n_rem = self.buffer_end - shift
        self._archive.append(self.host_buf.read(0, shift))
        self.buffer = torch.roll(self.buffer, -shift, dims=0)
        self.contact_buf = torch.roll(self.contact_buf, -shift, dims=0)
        rem_rows = self.host_buf.read(shift, n_rem)
        rem_contact = _np(self.contact_buf[:n_rem])
        self.host_buf = RingBuffer(c.buffer_rows)
        self.host_buf.stitch(0, rem_rows, rem_contact)
        self._row_shift[:n_rem] = self._row_shift[shift : shift + n_rem].copy()
        self._row_shift[n_rem:] = 0.0
        self.buffer_end = n_rem
        st["exec_idx"] = 1

    def _global_replan(self, from_xy, verbose: bool = False):
        """Rebuild the global spine from the robot's current position over the
        CURRENT terrain.  Blocked cells = the startup map (solver-probed for
        bool_map_search experiments) OR the fresh traversability of the
        changed terrain, so both pre-probed pillars and newly spawned
        obstacles divert the path.  If no path exists the old spine is kept
        (the window solves will fail into the stance-hold policy)."""
        blocked = _np(traversability_map(self.terrain)) > 0.5
        if self._blocked0 is not None:
            blocked = blocked | (self._blocked0 > 0.5)
        try:
            self.planner = GlobalPlanner(
                self.terrain, tuple(from_xy), tuple(self.goal_xy),
                avg_speed=self.cfg.avg_speed, blocked=blocked,
            )
            if verbose:
                print(f"[terrain changed] global replan from "
                      f"({from_xy[0]:.2f},{from_xy[1]:.2f})")
        except RuntimeError as e:
            if verbose:
                print(f"[terrain changed] global replan failed ({e}); "
                      "keeping old spine")

    def _reality_reset(self, sim):
        """Stance-hold at the MEASURED sim state, stitched at the execution
        cursor: the recovery step of the sim-health watchdog.  The next
        window replans from this hold, so planning restarts from where the
        robot actually is instead of chasing a diverged plan."""
        st = self._st
        exec_idx = st["exec_idx"]
        pos = _np(sim.pos)
        eul = _np(sim.eul)
        feet_t = Solo12.fk_world(sim.q, sim.pos, sim.eul)
        feet = _np(feet_t)
        # Lift feet embedded INSIDE geometry (the sim's penalty contact has
        # no lateral wall force, so a foot can clip into a riser) onto the
        # surface; feet measured ABOVE the surface (resting on a bump/ledge
        # edge whose bilinear height at the foot's own xy is lower) keep
        # their measured z — yanking a load-bearing foot down collapses the
        # stance.  The hover is instead accommodated by the solver's
        # first-stance terrain slack (KnotAux.terr_slack), the same
        # boundary-condition treatment as the RoM box widening.
        h_feet = _np(height_at(self.terrain, feet_t[:, 0], feet_t[:, 1]))
        feet[:, 2] = np.maximum(feet[:, 2], h_feet - 0.005)
        plan_row = self.host_buf.read(max(exec_idx - 1, 0), 1)[0]
        t_path = float(plan_row[0])
        row = np.concatenate(
            [[t_path], pos, eul, feet.reshape(12), np.zeros(3), np.zeros(3),
             np.zeros(12)]
        ).astype(np.float32)
        table, contact = stance_table(torch.as_tensor(row, device=self.device),
                                      self.seg_rows, t_path)
        # the hold IS reality: record its total shift from the path-anchored
        # frame so the next drift measurement starts from ~zero residual
        s_prev = self._row_shift[max(exec_idx - 1, 0)]
        d = pos[:2] - plan_row[1:3]
        cap = self.cfg.drift_cap_total
        shift = np.clip(s_prev + d, -cap, cap)
        self._stitch(exec_idx, table, contact, shift_xy=shift)

    # -- checkpoint / resume -------------------------------------------
    # The resume unit is (trajectory buffer, contact buffer, sim state,
    # execution cursor, solver warm start) — the analog of the reference's
    # CSV-as-checkpoint + solver restart ABI (combiner.py:125-135, 170-191).
    # The keys are those of `qtos_tpu`'s checkpoints (the simulator's leaves
    # as sim_<i>, in SIM_LEAVES order): `qtos_torch.convert.
    # runner_state_from_reference` carries one of those into this runner.

    def state_dict(self) -> dict:
        """Full resume snapshot as host numpy arrays (copies)."""
        st = self._st
        d = dict(
            buffer=_np(self.buffer),
            contact_buf=_np(self.contact_buf),
            buffer_end=self.buffer_end,
            exec_idx=st["exec_idx"],
            window=st["window"],
            planning_done=st["planning_done"],
            prev_x=_np(st["prev_x"]),
            row_shift=self._row_shift.copy(),
            com_errs=np.concatenate(st["com_errs"]) if st["com_errs"] else np.zeros(0),
            ee_errs=np.concatenate(st["ee_errs"]) if st.get("ee_errs") else np.zeros(0),
            sim_pos=np.concatenate(st["sim_pos"]) if st.get("sim_pos") else np.zeros((0, 3)),
            sim_feet=np.concatenate(st["sim_feet"]) if st.get("sim_feet") else np.zeros((0, 4, 3)),
            solve_times=np.asarray(st["solve_times"]),
            statuses=np.asarray(st["statuses"]),
            consec_failures=st.get("consec_failures", 0),
            consec_diverged=st.get("consec_diverged", 0),
            stance_holds=st.get("stance_holds", 0),
            archive=np.concatenate(self._archive)
            if self._archive else np.zeros((0, 37), np.float32),
        )
        for i, name in enumerate(SIM_LEAVES):
            d[f"sim_{i}"] = _np(getattr(st["sim"], name))
        return d

    def _tensor(self, a) -> torch.Tensor:
        """A float32 tensor on the runner's device with storage of its own."""
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def load_state_dict(self, d: dict) -> None:
        self.buffer = self._tensor(d["buffer"])
        self.contact_buf = self._tensor(d["contact_buf"])
        end = int(d["buffer_end"])
        if "row_shift" in d:
            self._row_shift = np.asarray(d["row_shift"], np.float32).copy()
        self.host_buf = RingBuffer(self.cfg.buffer_rows)
        if end > 0:
            self.host_buf.stitch(0, np.asarray(d["buffer"][:end]),
                                 np.asarray(d["contact_buf"][:end]))
        self.buffer_end = end
        sim = SimState(**{name: self._tensor(d[f"sim_{i}"]) for i, name in enumerate(SIM_LEAVES)})
        com = np.asarray(d["com_errs"])
        ee = np.asarray(d.get("ee_errs", np.zeros(0)))
        sp = np.asarray(d.get("sim_pos", np.zeros((0, 3))))
        sf = np.asarray(d.get("sim_feet", np.zeros((0, 4, 3))))
        self._st = dict(
            sim=sim,
            exec_idx=int(d["exec_idx"]),
            window=int(d["window"]),
            planning_done=bool(d["planning_done"]),
            prev_x=self._tensor(d["prev_x"]),
            com_errs=[com] if com.size else [],
            ee_errs=[ee] if ee.size else [],
            sim_pos=[sp] if sp.size else [],
            sim_feet=[sf] if sf.size else [],
            solve_times=list(np.asarray(d["solve_times"]).tolist()),
            statuses=[int(s) for s in np.asarray(d["statuses"])],
            consec_failures=int(d.get("consec_failures", 0)),
            consec_diverged=int(d.get("consec_diverged", 0)),
            stance_holds=int(d.get("stance_holds", 0)),
        )
        arch = np.asarray(d.get("archive", np.zeros((0, 37), np.float32)))
        self._archive = [arch] if arch.size else []

    def save_checkpoint(self, path: str | None = None) -> str:
        path = path or self.cfg.checkpoint_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **self.state_dict())
        return path

    def restore(self, path: str) -> None:
        """Load a checkpoint written by `save_checkpoint` into this runner
        (must be constructed with the same terrain/goal/config)."""
        with np.load(path, allow_pickle=False) as z:
            self.load_state_dict(dict(z))

    # ------------------------------------------------------------------
    def _height_under(self, x: float, y: float) -> float:
        """Terrain height at one point, read back to the host."""
        return float(height_at(self.terrain, *(torch.as_tensor(v, **self._f32) for v in (x, y))))

    def run(self, verbose: bool = True, resume_from: str | None = None) -> RunReport:
        c = self.cfg
        goal_r_final = np.array(
            [
                self.goal_xy[0],
                self.goal_xy[1],
                self._height_under(*map(float, self.goal_xy)) + Solo12.stand_height,
            ],
            np.float32,
        )
        if verbose:
            print(f"[runner] device {self.device}, host trajectory mirror: "
                  f"{'native ring buffer' if self.host_buf.is_native else 'numpy (no native library)'}")

        if resume_from is not None:
            self.restore(resume_from)
        else:
            # Initial solve from the canonical standing start (reference:
            # main.py default start_config + combiner.plan_init).  A failed
            # initial solve aborts, as in the reference (main.py:93-103).
            x0, y0, yaw0 = float(self.planner._xk[0]), float(self.planner._yk[0]), 0.0
            start_state = RobotState.standing((x0, y0), yaw=yaw0, terrain=self.terrain,
                                              device=self.device)
            zeros = torch.zeros(12, **self._f32)
            row0 = torch.cat(
                [
                    zeros[:1],
                    start_state.r,
                    start_state.eul,
                    start_state.feet.reshape(12),
                    start_state.v,
                    start_state.omega,
                    zeros,
                ]
            )
            self.buffer[0] = row0
            self.contact_buf[0] = 1.0
            self.host_buf.stitch(0, _np(row0)[None], np.ones((1, 4), np.float32))
            self.buffer_end = 1
            # The solver's CUDA kernel is compiled at its first use: build and
            # load it here, OUTSIDE the per-window timers (no launch, so the
            # launch count stays that of the solves).
            if self.device.type == "cuda":
                btd.occupancy(NV)
            t_w = time.time()
            at, table, contact, status, viol, x_sel, _, failed = self._plan(
                0, goal_r_final
            )
            if failed:
                raise RuntimeError(
                    f"initial window solve failed (max_violation={viol:.3g}) — "
                    "aborting like the reference's returncode check (main.py:93-103)"
                )
            self._stitch(0, table, contact)

            sim = state_from_row(self.buffer[0], self.terrain, self.control)
            sim = stance_warmup(sim, self.terrain, self.control, c.stance_warmup_steps)
            self._st = dict(
                sim=sim,
                exec_idx=0,
                window=0,
                planning_done=False,
                prev_x=x_sel,
                com_errs=[],
                ee_errs=[],
                sim_pos=[],
                sim_feet=[],
                solve_times=[time.time() - t_w],
                statuses=[status],
                consec_failures=0,
                stance_holds=0,
            )

        st = self._st
        st.setdefault("ee_errs", [])
        st.setdefault("sim_pos", [])
        st.setdefault("sim_feet", [])
        st.setdefault("consec_failures", 0)
        st.setdefault("consec_diverged", 0)
        st.setdefault("stance_holds", 0)
        reached = False
        aborted = False
        underruns = 0
        rt_t0 = time.time()   # wall anchor for --realtime pacing
        while st["window"] < c.max_windows:
            window = st["window"]
            sim = st["sim"]
            exec_idx = st["exec_idx"]
            planning_done = st["planning_done"]
            solve_times = st["solve_times"]
            statuses = st["statuses"]
            # dynamic terrain (exp_8): mutate the world between windows; the
            # solver and the sim take terrain as data.  A changed world also
            # triggers a GLOBAL replan from the robot's current position — a
            # spawned obstacle on the old spine would otherwise drive every
            # window solve straight into it.
            if c.terrain_update is not None:
                new_terrain = c.terrain_update(window, self.terrain)
                if new_terrain is not self.terrain:
                    self.terrain = new_terrain
                    self._global_replan(_np(sim.pos)[:2], verbose)
                    # The buffer tail was planned on the OLD world and the
                    # OLD spine.  Executing it mid-gait while the next
                    # windows start chasing the replanned spine stitches two
                    # disagreeing plans — and if the change moved the ground
                    # under an upcoming foothold (a box spawned on the path)
                    # the old rows walk straight into the new geometry.
                    # Stance-hold at the measured state and replan from
                    # reality unconditionally: the hold is a known-stable
                    # state and costs ~2.5 s.
                    if verbose:
                        print("[terrain changed] holding stance, "
                              "replanning from reality onto the new spine")
                    self._reality_reset(sim)
                    st["stance_holds"] += 1
                    st["planning_done"] = False
            # long runs (exp_9: ~52k rows + stance holds) would overrun the
            # fixed-capacity buffer — drop already-executed rows when the
            # tail nears capacity (archived for the end-of-run report)
            self._maybe_compact()
            exec_idx = st["exec_idx"]

            # Pipelined dispatch: enqueue this window's candidate solve, then
            # the execution chunk, without waiting on either — the device runs
            # solve -> exec back to back while the host does the selection
            # bookkeeping.  The exec chunk reads only already-final buffer
            # rows, so it is independent of the plan being solved.
            n_exec = min(c.f_steps, self.buffer_end - exec_idx)
            if n_exec <= 0 and planning_done:
                break
            if c.realtime and n_exec <= 0 and not planning_done:
                # the paced consumer has nothing final to execute: planning
                # fell behind the 1 kHz consumption contract
                underruns += 1
            pd = None
            t_w = time.time()
            if not planning_done:
                target = exec_idx + c.lookahead
                if target >= self.buffer_end - 10:
                    target = self.buffer_end - 10
                drift = None
                if exec_idx > 0:
                    # measured drift at the current execution point, paired
                    # with the shift already baked into that row.  The yaw
                    # residual is AVERAGED over the tail of the previous
                    # window: the trot's cyclic sway puts +-10 deg on any
                    # single-row sample, and feeding that noise into the next
                    # window's start heading destabilizes the stitch.
                    plan_row = self.host_buf.read(exec_idx - 1, 1)[0]
                    n_tail = min(800, exec_idx)
                    plan_yaws = self.host_buf.read(exec_idx - n_tail, n_tail)[:, 6]
                    sim_yaws = st["_yaw_tail"] if st.get("_yaw_tail") is not None \
                        else np.full(n_tail, float(_np(sim.eul)[2]))
                    m = min(len(sim_yaws), n_tail)
                    yd = sim_yaws[-m:] - plan_yaws[-m:]
                    dyaw_f = float(np.arctan2(np.sin(yd).mean(), np.cos(yd).mean()))
                    drift = (_np(sim.pos)[:2] - plan_row[1:3],
                             self._row_shift[exec_idx - 1],
                             dyaw_f)
                pd = self._plan_dispatch(
                    target, goal_r_final,
                    x_warm=st["prev_x"] if c.warm_start else None,
                    drift_xy=drift,
                )
            # n_exec can be 0 on a plan-only iteration (terminal refinement:
            # buffer exhausted, goal not yet reached) — skip execution.
            if n_exec > 0:
                sim_next, metrics = self._exec_chunk(exec_idx, n_exec, sim)
            else:
                sim_next, metrics = sim, None

            if pd is not None:
                at, table, contact, status, viol, x_sel, is_final, failed = \
                    self._plan_finish(pd)
                solve_times.append(time.time() - t_w)
                self.solve_ms_window.enqueue(solve_times[-1] * 1e3)
                self.plan_history.push((pd["rows_host"][0, 1:3], pd["goals_host"][0]))
                statuses.append(status)
                self._stitch(at, table, contact, shift_xy=pd["seg_shift"])
                if failed:
                    st["consec_failures"] += 1
                    st["stance_holds"] += 1
                    if verbose:
                        print(
                            f"[window {window}] PLAN FAILED (viol={viol:.3g}, "
                            f"top={getattr(self, 'last_fail_viol', {})}) — "
                            f"stance hold {st['consec_failures']}/{c.max_consec_failures}"
                        )
                    if st["consec_failures"] >= c.max_consec_failures:
                        aborted = True   # watchdog (reference combiner.py:223-225)
                else:
                    st["consec_failures"] = 0
                    st["prev_x"] = x_sel
                    if is_final:
                        st["planning_done"] = True

            # consume the executed chunk
            if metrics is not None:
                st["com_errs"].append(_np(metrics.com_err))
                st["ee_errs"].append(_np(metrics.ee_err))
                st["sim_pos"].append(_np(metrics.pos))
                st["sim_feet"].append(_np(metrics.feet))
                st["_yaw_tail"] = _np(metrics.yaw)[-800:]
                exec_idx += n_exec
                if c.realtime:
                    # release this chunk at its wall-clock deadline: the
                    # consumer runs at 1 kHz while replans land async
                    done_ticks = sum(len(a) for a in self._archive) + exec_idx
                    deadline = rt_t0 + done_ticks / 1000.0
                    lag = deadline - time.time()
                    if lag > 0:
                        time.sleep(lag)
            st["sim"] = sim_next
            st["exec_idx"] = exec_idx
            st["window"] = window + 1
            if c.checkpoint_every and (window + 1) % c.checkpoint_every == 0:
                self.save_checkpoint()

            sim = sim_next
            pos = _np(sim.pos)
            if verbose:
                print(
                    f"[window {window}] exec->{exec_idx} pos=({pos[0]:.2f},{pos[1]:.2f},{pos[2]:.2f}) "
                    f"solve={solve_times[-1]*1e3:.0f}ms (avg {self.solve_ms_window.average():.0f}ms) "
                    f"status={statuses[-1]}"
                )
            # Sim-health watchdog — the tracking-side twin of the solver-side
            # failure policy.  The solver can report status 0 forever while
            # the robot lies on the ground; the reference's goal-progress
            # watchdog (QTOS/combiner.py:223-225) is the closest analog.
            z_rel = pos[2] - self._height_under(float(pos[0]), float(pos[1]))
            win_err = float(np.mean(st["com_errs"][-1])) if metrics is not None else 0.0
            if metrics is None:
                pass                     # plan-only iteration: nothing executed
            elif z_rel < c.fallen_z:
                aborted = True
                if verbose:
                    print(
                        f"[window {window}] FALL DETECTED (z_rel={z_rel:.3f} < "
                        f"{c.fallen_z}) — aborting"
                    )
            elif win_err > c.divergence_err:
                # tracking diverged but the robot is upright: stance-hold at
                # the MEASURED state and replan from reality
                st["consec_diverged"] += 1
                st["stance_holds"] += 1
                if verbose:
                    print(
                        f"[window {window}] TRACKING DIVERGED (win_err="
                        f"{win_err:.3f} > {c.divergence_err}) — reality reset "
                        f"{st['consec_diverged']}/{c.max_consec_failures}"
                    )
                if st["consec_diverged"] >= c.max_consec_failures:
                    aborted = True
                else:
                    self._reality_reset(sim)
                    # the diverged plan (possibly the final one) was just
                    # discarded — planning must resume from the hold
                    st["planning_done"] = False
            else:
                st["consec_diverged"] = 0
            if aborted:
                break
            dist_goal = float(np.linalg.norm(pos[:2] - goal_r_final[:2]))
            if dist_goal < c.goal_tol:
                reached = True
                break
            if st["planning_done"] and exec_idx >= self.buffer_end - 1:
                # terminal refinement: the final planned window is executed
                # but the robot stopped short of the goal (stitch granularity
                # + drift) — keep replanning short approach windows until
                # within goal_tol (bounded by max_windows).  Matches the
                # reference's goal_diff < 0.1 criterion (main.py:40).
                if dist_goal > c.goal_tol and st["window"] < c.max_windows:
                    st["planning_done"] = False
                    continue
                break

        sim = st["sim"]
        exec_idx = st["exec_idx"]
        # total executed ticks: compaction rebases exec_idx, the archive holds
        # the dropped prefix
        total_ticks = sum(len(a) for a in self._archive) + exec_idx
        solve_times = st["solve_times"]
        statuses = st["statuses"]
        com = np.concatenate(st["com_errs"]) if st["com_errs"] else np.zeros(1)
        ee = np.concatenate(st["ee_errs"]) if st["ee_errs"] else np.zeros(1)
        sim_pos = np.concatenate(st["sim_pos"]) if st["sim_pos"] else np.zeros((1, 3))
        sim_feet = np.concatenate(st["sim_feet"]) if st["sim_feet"] else np.zeros((1, 4, 3))
        rt_factor = (time.time() - rt_t0) / max(total_ticks / 1000.0, 1e-9)
        final_pos = _np(sim.pos)
        return RunReport(
            reached_goal=bool(
                reached or np.linalg.norm(final_pos[:2] - goal_r_final[:2]) < 1.5 * c.goal_tol
            ),
            windows=len(statuses),
            sim_ticks=total_ticks,
            final_pos=final_pos,
            goal=goal_r_final,
            mean_com_err=float(com.mean()),
            max_com_err=float(com.max()),
            avg_com_err_per_s=float(com.sum() / max(len(com), 1) * 1000.0),
            solve_wall_times=solve_times,
            statuses=statuses,
            com_err_series=com,
            ee_err_series=ee,
            sim_pos_series=sim_pos,
            sim_feet_series=sim_feet,
            ref_table=np.concatenate(
                self._archive + [self.host_buf.read(0, exec_idx)]
            ) if self._archive else self.host_buf.read(0, exec_idx),
            aborted=aborted,
            stance_holds=st["stance_holds"],
            underruns=underruns,
            realtime_factor=rt_factor if c.realtime else 0.0,
        )
