"""Closed-loop driver of `qtos_torch.control.loop.playback`: the sweep's
verification stage, each solved window played through the physics at 1 kHz.

Set-up makes the mix's pool of table batches (solved windows of the sweep,
made by the plain reference: its seconds are not set-up's, `reference_s`),
builds the program's start states from their first rows (`state_from_row`,
a teleport start) and warms the call up.  Each step of the window plays the
next batch of the pool, one launch of the tick kernel, and reads the final
base heights and the tracking metric back on the host, which ends the call.
An episode fails when it falls: its base ends below the configuration's
`fallen_z` above the ground.  A seeded reservoir keeps, from some calls, a
few seeded episodes' realized CoM and feet over the first `CHECK_TICKS`
ticks, their final CoM and their tracking metric (`avg_com_err_per_s`) over
the whole table.

After the window the reference plays the kept episodes' whole tables with
its plain loop on the host's CPU (one thread: the loop is some thousand
small operations a tick, which the CPU runs faster than launches on the
card) and the check compares the traces tick by tick over the first
`CHECK_TICKS` ticks, the final CoM and the tracking metric over the whole
table, and the launches the program counted with one per call.  Past some
500 ticks any two float32 loops part on flat ground too, so the later ticks
are held through the whole-episode numbers, at limits above that parting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import torch

from benchmark import harness, program, traffic
from benchmark.reference import heightfield as ref_hf
from benchmark.reference import loop as ref_loop
from benchmark.reference import solver as ref_solver

SAMPLE = 8           # calls whose episodes the reference plays again
EPISODES = 4         # episodes kept from each of those calls
REFERENCE_DEVICE = "cpu"
CHECK_TICKS = 500
WARMUP_CALLS = 1


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from qtos_torch.control.loop import gait_control_params, playback, state_from_row

        self.cfg, self.limits, self.device = cell["cfg"], cell["limits"], device
        cfg = self.cfg
        self.playback = playback
        self.grid = harness.terrain_grid(cfg, device)
        t = time.perf_counter()
        self.tables = traffic.make(cell["mix"], cfg, seed, device)               # (P, B, T, 37)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)   # the peak is the program's, not the reference's
        self.reference_s = time.perf_counter() - t
        self.terrain = program.terrain(self.grid, cfg)
        self.ref_terrain = ref_solver.terrain(self.grid.cpu(), self.cfg)
        self.params = gait_control_params(cfg["gait"])
        self.states = [state_from_row(t[:, 0], self.terrain, self.params) for t in self.tables]
        for n in range(WARMUP_CALLS):
            self._play(n)
        program.reset_counters()
        P, B, T, _ = self.tables.shape
        rng = random.Random(seed)
        self.episodes = [rng.sample(range(B), EPISODES) for _ in range(256)]
        self.reservoir = harness.Reservoir(SAMPLE, seed)
        self.kept = [None] * SAMPLE
        self.calls = self.attempted = self.failed = self.ticks = 0
        self.check_ticks = min(CHECK_TICKS, T)

    def _play(self, n: int):
        p = n % len(self.states)
        final, m = self.playback(self.tables[p], self.states[p], self.terrain, self.params)
        pos = final.pos.cpu()                           # the host read that ends the call
        float(m.avg_com_err_per_s.mean())
        return p, m, final, pos

    def step(self, n: int) -> None:
        p, m, final, pos = self._play(n)
        B, T = self.tables.shape[1:3]
        self.calls += 1
        self.attempted += B
        self.ticks += B * T
        ground = ref_hf.height_at(self.ref_terrain, pos[:, 0], pos[:, 1])
        self.failed += int((pos[:, 2] - ground < self.cfg["playback"]["fallen_z"]).sum())
        slot = self.reservoir.offer(n)
        if slot is not None:
            e = torch.tensor(self.episodes[n % len(self.episodes)], device=self.device)
            n_t = self.check_ticks
            self.kept[slot] = (p, e, m.pos[e, :n_t].clone(), m.feet[e, :n_t].clone(), final.pos[e].clone(),
                               m.avg_com_err_per_s[e].clone())

    def end_to_end(self, window_s: float) -> dict:
        return dict(ticks_per_s=self.ticks / window_s)

    def counters(self) -> dict:
        return dict(program.counters(), calls=self.calls)

    def shapes(self) -> dict:
        return dict(B=self.tables.shape[1], T=self.tables.shape[2])

    def release(self) -> None:
        self.counted = self.counters()
        del self.states

    def reference(self, precision: str = "float32", device=REFERENCE_DEVICE) -> tuple:
        """The reference's play of the kept episodes' whole tables on
        `device`, in order: their realized CoM (n, CHECK_TICKS, 3) and feet
        (n, CHECK_TICKS, 4, 3), final CoM (n, 3) and `avg_com_err_per_s`
        (n,), at `precision` ("float32", "tf32", or "bfloat16": the table
        and the loop's carry held in bfloat16, each tick starting from them
        rounded to it)."""
        kept = [k for k in self.kept if k is not None]
        tables = torch.cat([self.tables[p][e] for p, e, *_ in kept]).to(device)
        terr = ref_solver.terrain(self.grid.to(device), self.cfg)
        params = ref_loop.gait_control_params(self.cfg["gait"])
        with _one_thread(), ref_solver.precision("float32" if precision == "bfloat16" else precision):
            s0 = ref_loop.state_from_row(tables[:, 0], terr, params)
            scan = ref_loop._scan_ticks if precision != "bfloat16" else _held_scan
            final, traces = scan(tables, s0, terr, params)
        m = ref_loop._metrics(traces, tables.shape[-2])
        n_t = self.check_ticks
        return m.pos[:, :n_t], m.feet[:, :n_t], final.pos, m.avg_com_err_per_s

    def gaps(self, ours: tuple, ref: tuple) -> list:
        """The numbers compared, `ours` and `ref` each as `reference`
        returns them: the widest gap (m) of the realized CoM and feet over
        the first CHECK_TICKS ticks, the widest distance (m) of the final
        CoM, the widest relative gap of `avg_com_err_per_s`."""
        d = [(a.double().cpu() - b.double().cpu()) for a, b in zip(ours, ref)]
        values = dict(trace_gap=max(float(d[0].abs().max()), float(d[1].abs().max())),
                      final_com_gap=float(d[2].norm(dim=-1).max()),
                      com_err_gap=float((d[3].abs() / ref[3].double().cpu()).max()))
        return [dict(name=k, value=v, limit=self.limits[k]) for k, v in values.items()]

    def check(self) -> list:
        kept = [k for k in self.kept if k is not None]
        ours = tuple(torch.cat([k[j] for k in kept]) for j in range(2, 6))
        c = self.counted
        path_ok = c["tick"] == (self.calls if self.device.type == "cuda" else 0)
        return self.gaps(ours, self.reference()) + [dict(name="launch_mismatch", value=int(not path_ok), limit=0)]

    def control(self, precision: str = "tf32") -> list:
        """The numbers with the reference at `precision` put in the
        program's place, or with `"card"` the reference's own float32 loop
        on the program's device: how far two sound float32 loops part."""
        if precision == "card":
            return self.gaps(self.reference("float32", self.device), self.reference())
        return self.gaps(self.reference(precision), self.reference())


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _held_scan(table, state0, terrain, params, dtype=torch.bfloat16):
    """`reference.loop._scan_ticks` with the table and the carry held in
    `dtype`: (final state, traces of every tick)."""
    def held(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype).to(v.dtype)
        if isinstance(v, tuple):
            return tuple(held(u) for u in v)
        return dataclasses.replace(v, **{f.name: held(getattr(v, f.name)) for f in dataclasses.fields(v)})

    table = held(table)
    q_des0, _ = ref_loop.plan_joint_targets(table[..., 0, :], params)
    batch = table.shape[:-2]
    f32 = dict(dtype=table.dtype, device=table.device)
    carry = (state0, q_des0, torch.zeros(batch + (4, 3), **f32), torch.zeros(batch + (3,), **f32),
             torch.zeros(batch, **f32))
    outs = []
    for t in range(table.shape[-2]):
        carry, out = ref_loop._tick(held(carry), table[..., t, :], terrain, params)
        outs.append(out)
    return carry[0], {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
