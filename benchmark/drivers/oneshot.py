"""Closed-loop driver of `qtos_torch.solver.solve_batch` in the one-shot
mode: one plan of a whole path at a time, a batch of one window of many
knots and many LM iterations.

Set-up makes the mix's pool of goals, builds the program's spec of each and
warms the call up on the cell's own shape.  Each step of the window plans
the next goal of the pool and reads its status back on the host, which ends
the call; the next plan starts only then.  The last answer for each goal of
the pool is kept: a plan of one goal is the same computation every time.

The check compares, for the goals planned in the window:

- the timed answer, the knots after the cell's LM iterations: the
  reference's merit and max violation of the program's knots against those
  of its own knots for the same goal.  After some ten iterations two
  float32 solvers part onto nearby points of the same valley, so the knots
  themselves are not compared there;
- the start, the program's knots after its first START_ITERS iterations
  against the reference's, knot by knot;
- the report, the violations the program read back against the reference's
  evaluation of its knots;
- the launches the program counted with the launches its path takes: one
  BTD solve on `btd_kernel` (the window's factors do not fit the small
  kernel's shared memory) and one assembly per LM iteration.

The reference's 83 LM iterations over windows of 154 knots take some 40 s,
so they run on the host's CPU in a process of their own
(`reference/process.py`), started at set-up, for the whole pool: its plans
do not depend on the program's.  The reference's evaluation of knots runs
on the program's device.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing

import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare
from benchmark.reference import process as ref_process
from benchmark.reference import solver as ref_solver
from benchmark.reference import spec as ref_spec
from benchmark.reference import transcription as ref_transcription

START_ITERS = 3      # LM iterations of the start's check
WARMUP_CALLS = 2
REFERENCE_DEVICE = "cpu"
# Faults planted in the reference put in the program's place (`control`):
# the damping clamped 1e4 times above the configuration's floor, iterations
# past the tenth left out, and the goal family's weight halved in the
# normal equations and the merit (the plan ends farther from its goal; its
# merit under the configuration's weights hardly moves).  `weights` scales
# the weights it names.
FAULTS = {"damping_clamp": dict(lm_min=1e-3), "stop_at_10": dict(max_iters=10),
          "goal_weight_half": dict(weights=dict(goal=0.5))}


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from qtos_torch.solver import default_spec, solve_batch

        self.cfg, self.limits, self.device = cell["cfg"], cell["limits"], device
        cfg = self.cfg
        self.solve_batch, self.default_spec = solve_batch, default_spec
        self.grid = harness.terrain_grid(cfg, device)
        self.goals = traffic.make(cell["mix"], cfg, seed, device).reshape(-1, 2)      # (P, 2)
        if cell["mix"]["batch"] != 1:
            raise ValueError("the one-shot driver plans one window at a time (a mix of batch 1)")
        self.scfg = program.solver_config(cfg["solver"])
        self.ref_scfg = ref_solver.solver_config(cfg["solver"])
        # the reference's plans of the whole pool, in a process of their own
        self.pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        terr, specs = self._ref_problem(range(len(self.goals)), REFERENCE_DEVICE)
        self.ref_plans = self.pool.submit(ref_process.solve_batches, specs, terr,
                                          (self.ref_scfg.replace(max_iters=START_ITERS), self.ref_scfg))
        self.terrain = program.terrain(self.grid, cfg)
        self.specs = [self._spec(g[None]) for g in self.goals]
        for i in range(WARMUP_CALLS):
            self.solve_batch(self.specs[i % len(self.specs)], self.terrain, self.scfg).status.cpu()
        program.reset_counters()
        self.kept = {}
        self.attempted = self.failed = 0

    def _spec(self, goals):
        return self.default_spec(self.terrain, goal_xy=(goals[:, 0], goals[:, 1]), duration=self.cfg["duration_s"],
                                 K=self.cfg["K"], device=self.device)

    def _ref_problem(self, ps, device):
        """The reference's terrain and specs of goals `ps` of the pool, on
        `device`."""
        goals = self.goals[list(ps)].to(device)
        terr = ref_solver.terrain(self.grid.to(device), self.cfg)
        return terr, ref_spec.default_spec(terr, goal_xy=(goals[:, 0], goals[:, 1]),
                                           duration=self.cfg["duration_s"], K=self.cfg["K"], device=device)

    def step(self, n: int) -> None:
        p = n % len(self.specs)
        res = self.solve_batch(self.specs[p], self.terrain, self.scfg)
        status = res.status.cpu()                     # the host read that ends the call
        self.attempted += 1
        self.failed += int(status[0] != 0)
        self.kept[p] = (res.x, compare.stack_viol(res.viol))

    def end_to_end(self, window_s: float) -> dict:
        return dict(solves_per_s=(self.attempted - self.failed) / window_s)

    def counters(self) -> dict:
        return dict(program.counters(), calls=self.attempted)

    def shapes(self) -> dict:
        return dict(B=1, K=self.cfg["K"], iters=self.scfg.max_iters, grid_cells=self.grid.numel())

    def release(self) -> None:
        self.counted = self.counters()

    def gaps(self, start_x, timed_x, reported, ps) -> list:
        """The numbers compared, over the goals `ps` of the pool: `start_x`
        the knots after START_ITERS iterations, `timed_x` the timed answer's
        knots and `reported` its violations (n, F) as read back; the
        reference's plans from the process that made them.  Per goal in
        `self.detail`."""
        ref_start, ref = self.ref_plans.result()
        terr, specs = self._ref_problem(ps, self.device)
        scfg = self.ref_scfg
        ref_x = ref.x[ps].to(self.device)
        viol_x = ref_transcription.violations(timed_x, specs, terr, scfg)
        viol_ref = ref_transcription.violations(ref_x, specs, terr, scfg)
        viol_ratio = (ref_transcription.max_violation(viol_x).double()
                      / ref_transcription.max_violation(viol_ref).double())
        merit_ratio = (ref_solver.merit(timed_x, specs, terr, scfg).double()
                       / ref_solver.merit(ref_x, specs, terr, scfg).double())
        self.detail = dict(ps=ps, viol_ratio=viol_ratio.tolist(), merit_ratio=merit_ratio.tolist(),
                           ref_status=ref.status[ps].tolist())
        values = dict(start_gap=compare.knot_gap(start_x.cpu(), ref_start.x[ps]),
                      report_gap=compare.viol_gap(reported, compare.stack_viol(viol_x)) / scfg.tol,
                      viol_excess_median=float(viol_ratio.median()) - 1, merit_excess=float(merit_ratio.max()) - 1)
        return [dict(name=k, value=v, limit=self.limits[k]) for k, v in values.items()]

    def check(self) -> list:
        ps = sorted(self.kept)
        # the start: the program's own entry on the goals planned, its solver
        # cut to the first START_ITERS iterations
        start = self.solve_batch(self._spec(self.goals[ps]), self.terrain, self.scfg.replace(max_iters=START_ITERS))
        timed_x = torch.cat([self.kept[p][0] for p in ps])
        reported = torch.cat([self.kept[p][1] for p in ps])
        c, expected = self.counted, self.attempted * self.scfg.max_iters
        if self.device.type == "cuda":
            path_ok = c["btd"] == c["assemble"] == expected and c["btd_small"] == 0
        else:
            path_ok = c["btd"] == c["assemble"] == 0
        out = self.gaps(start.x, timed_x, reported, ps) + [
            dict(name="launch_mismatch", value=int(not path_ok), limit=0)]
        self.pool.shutdown()
        return out

    def control(self, name: str = "tf32") -> list:
        """The numbers with the reference put in the program's place: at
        precision `name`, or with the fault `name` of FAULTS planted."""
        ps = sorted(self.kept)
        precision, changes = ("float32", dict(FAULTS[name])) if name in FAULTS else (name, {})
        if "weights" in changes:
            w = self.ref_scfg.weights
            changes["weights"] = dataclasses.replace(w, **{k: f * getattr(w, k) for k, f in changes["weights"].items()})
        terr, specs = self._ref_problem(ps, REFERENCE_DEVICE)
        with ref_solver.precision(precision):
            start = ref_solver.solve_batch(specs, terr, self.ref_scfg.replace(**dict(changes, max_iters=START_ITERS)))
            res = ref_solver.solve_batch(specs, terr, self.ref_scfg.replace(**changes))
        return self.gaps(start.x, res.x.to(self.device), compare.stack_viol(res.viol).to(self.device), ps)
