"""Closed-loop driver of `qtos_torch.control.replan.plan_windows_batch`:
the online replanner.

Set-up makes the mix's pool of replans (each the configuration's candidate
start rows, goals and path times) and warms the call up on them.  Each step
of the window is one replan: dispatch, then the host read of the
candidates' statuses and violations, which is what the runner's selection
needs, with the sampled tables left on the device.  Its latency runs from
dispatch to that read; the next replan starts only then.  A replan fails
when no candidate is usable by the runner's rule (the first converged one,
else the least violation below `usable_viol`).  A seeded reservoir keeps a
few replans' knots, statuses, violations, tables and contacts.

After the window the reference plans the kept replans from the same rows,
all of them in one batch, and the check compares:

- the timed answer, the knots after the cell's LM iterations: the
  reference's merit and max violation of the program's knots against those
  of its own knots.  Past some ten iterations two float32 solvers part onto
  nearby points of the same valley, so the knots themselves are not
  compared there, nor the statuses (on exp_1 a sound run leaves up to one
  candidate in a hundred unconverged where the reference converges, and the
  LM faults leave none);
- the start, the knots, tables and contacts after the first START_ITERS
  iterations of the program's entry, knot by knot;
- the report, what each replan reported of its own knots (violations,
  tables, contacts) against the reference's evaluation of those knots;
- the launches the program counted with the launches its path takes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare
from benchmark.reference import solver as ref_solver
from benchmark.reference import transcription as ref_transcription

SAMPLE = 8           # replans the reference checks after the window
START_ITERS = 3      # LM iterations of the start's check
WARMUP_CALLS = 3
# Faults of the LM loop's later iterations, planted in the reference put in
# the program's place (`control`): the damping clamped 1e4 times above the
# configuration's floor, and iterations past the tenth left out.
FAULTS = {"damping_clamp": dict(lm_min=1e-3), "stop_at_10": dict(max_iters=10)}


def select(status: np.ndarray, viol: np.ndarray, usable_viol: float):
    """The runner's choice: the first converged candidate, else the one of
    least violation if it is below `usable_viol`, else None."""
    ok = np.flatnonzero(status == 0)
    if ok.size:
        return int(ok[0])
    best = int(np.argmin(viol))
    return best if viol[best] < usable_viol else None


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from qtos_torch.control.replan import plan_windows_batch

        self.cfg, self.limits, self.device = cell["cfg"], cell["limits"], device
        cfg = self.cfg
        self.plan = plan_windows_batch
        self.grid = harness.terrain_grid(cfg, device)
        self.inputs = traffic.make(cell["mix"], cfg, seed, device)
        self.pool = self.inputs["rows"].shape[0]
        self.terrain = program.terrain(self.grid, cfg)
        self.rcfg = program.runner_config(cfg)
        for n in range(WARMUP_CALLS):
            self._replan(n)
        program.reset_counters()
        self.reservoir = harness.Reservoir(SAMPLE, seed)
        self.kept = [None] * SAMPLE
        self.latencies = []
        self.attempted = self.failed = 0

    def _replan(self, n: int):
        p = n % self.pool
        i = self.inputs
        res, tables, contacts = self.plan(i["rows"][p], i["goals_r"][p], i["goals_yaw"][p], self.terrain,
                                          self.rcfg, t0s=i["t0s"][p])
        status, viol = res.status.cpu().numpy(), res.max_violation.cpu().numpy()
        return p, res, tables, contacts, status, viol

    def step(self, n: int) -> None:
        t = time.perf_counter()
        p, res, tables, contacts, status, viol = self._replan(n)
        self.latencies.append(time.perf_counter() - t)
        self.attempted += 1
        self.failed += select(status, viol, self.cfg["usable_viol"]) is None
        slot = self.reservoir.offer(n)
        if slot is not None:
            self.kept[slot] = (p, res.x.clone(), res.status.clone(), compare.stack_viol(res.viol).clone(),
                               tables.clone(), contacts.clone())

    def end_to_end(self, window_s: float) -> dict:
        return dict(replan_ms=1e3 * window_s / self.attempted,
                    replan_p95_ms=1e3 * float(np.percentile(self.latencies, 95)))

    def counters(self) -> dict:
        return dict(program.counters(), calls=self.attempted)

    def shapes(self) -> dict:
        return dict(B=self.cfg["n_candidates"], K=self.cfg["K"], iters=self.rcfg.solver.max_iters,
                    grid_cells=self.grid.numel())

    def release(self) -> None:
        self.counted = self.counters()

    def _reference(self, ps: list, precision: str, **changes):
        """The reference's terrain, solver settings, specs, path times and
        (result, tables, contacts) of replans `ps` of the pool, their
        candidates in one batch, at `precision`, with the cell's solver
        settings changed by `changes`."""
        def cat(key):
            return torch.cat([self.inputs[key][p] for p in ps])

        terr = ref_solver.terrain(self.grid, self.cfg)
        scfg = ref_solver.solver_config(self.cfg["solver"]).replace(**changes)
        specs = ref_solver.replan_specs(cat("rows"), cat("goals_r"), cat("goals_yaw"), terr, K=self.cfg["K"],
                                        duration=self.cfg["window_duration"], gait=self.cfg["gait"])
        with ref_solver.precision(precision):
            return terr, scfg, specs, cat("t0s"), ref_solver.plan_windows(specs, cat("t0s"), terr, scfg)

    def gaps(self, start, timed) -> list:
        """The numbers compared, over the kept replans' candidates.

        `start`: (knots, tables, contacts) after START_ITERS iterations;
        `timed`: (knots, statuses, reported violations, tables, contacts)
        of the timed replans; both with the candidates of all kept replans
        in one batch.  Of the timed answer, `merit_excess` is the widest
        excess of the merit of a candidate's knots over the reference's own,
        `viol_excess_median` the median candidate's excess of max violation
        (the widest swings by itself: on a few candidates in a run one of two
        sound float32 solvers ends several times above the other's violation
        with merits within 2 %); per candidate in `self.detail`."""
        ps = [k[0] for k in self.kept if k is not None]
        _, _, _, _, (ref3, ref3_tables, ref3_contacts) = self._reference(ps, "float32", max_iters=START_ITERS)
        terr, scfg, specs, t0s, (ref, _, _) = self._reference(ps, "float32")
        x, status, viol, tables, contacts = timed
        viol_ref, tables_ref, contacts_ref = ref_solver.evaluate(x, specs, t0s, terr, scfg)
        start_gap = max(compare.knot_gap(start[0], ref3.x),
                        compare.table_gap(start[1], start[2], ref3_tables, ref3_contacts))
        report_gap = max(compare.viol_gap(viol, compare.stack_viol(viol_ref)) / scfg.tol,
                         compare.table_gap(tables, contacts, tables_ref, contacts_ref))
        viol_ratio = ref_transcription.max_violation(viol_ref).double() / ref.max_violation.double()
        merit_ratio = (ref_solver.merit(x, specs, terr, scfg).double()
                       / ref_solver.merit(ref.x, specs, terr, scfg).double())
        self.detail = dict(viol_ratio=viol_ratio.tolist(), merit_ratio=merit_ratio.tolist(),
                           status=status.tolist(), ref_status=ref.status.tolist())
        values = dict(start_gap=start_gap, report_gap=report_gap,
                      viol_excess_median=float(viol_ratio.median()) - 1, merit_excess=float(merit_ratio.max()) - 1)
        return [dict(name=k, value=v, limit=self.limits[k]) for k, v in values.items()]

    def check(self) -> list:
        kept = [k for k in self.kept if k is not None]
        # the start: the program's own entry on the kept replans, its solver
        # cut to the first START_ITERS iterations
        cut = self.rcfg.solver.replace(max_iters=START_ITERS)
        i = self.inputs
        start = [self.plan(i["rows"][p], i["goals_r"][p], i["goals_yaw"][p], self.terrain, self.rcfg,
                           t0s=i["t0s"][p], solver_cfg=cut) for p, *_ in kept]
        start = (torch.cat([r.x for r, _, _ in start]), torch.cat([t for _, t, _ in start]),
                 torch.cat([c for _, _, c in start]))
        timed = tuple(torch.cat([k[j] for k in kept]) for j in range(1, 6))
        c, expected = self.counted, self.attempted * self.rcfg.solver.max_iters
        if self.device.type == "cuda":
            # one launch of each kernel per LM iteration, the BTD solve on its
            # small-batch kernel
            path_ok = c["btd"] == c["btd_small"] == c["assemble"] == expected
        else:
            path_ok = c["btd"] == c["assemble"] == 0
        return self.gaps(start, timed) + [dict(name="launch_mismatch", value=int(not path_ok), limit=0)]

    def control(self, name: str = "tf32") -> list:
        """The numbers with the reference put in the program's place: at
        precision `name`, or with the fault `name` of FAULTS planted."""
        ps = [k[0] for k in self.kept if k is not None]
        precision, changes = ("float32", FAULTS[name]) if name in FAULTS else (name, {})
        start = self._reference(ps, precision, **dict(changes, max_iters=START_ITERS))[-1]
        res, tables, contacts = self._reference(ps, precision, **changes)[-1]
        timed = (res.x, res.status, compare.stack_viol(res.viol), tables, contacts)
        return self.gaps((start[0].x, start[1], start[2]), timed)
