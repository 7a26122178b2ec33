"""Closed-loop driver of `qtos_torch.solver.solve_batch`: the offline sweep.

Set-up makes the mix's pool of goal batches, builds the program's batched
specs from them and warms the call up twice on the cell's own shapes.  Each
step of the window solves the next batch of the pool and reads the statuses
back on the host, which ends the call; the next call starts only then.  Four
windows of each call, drawn from the seed, are offered to a seeded
reservoir; the kept windows' knots and violations are copied aside.

After the window the reference solves the kept windows from the same goals
and the check compares knots and violations, and the launches the program
counted with the launches its path takes.
"""

from __future__ import annotations

import random

import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare
from benchmark.reference import solver as ref_solver
from benchmark.reference import spec as ref_spec

SAMPLE = 64          # windows the reference re-solves after the window
ROWS_PER_CALL = 4    # windows of each call offered to the sample
WARMUP_CALLS = 2


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        from qtos_torch.solver import default_spec, solve_batch

        self.cfg, self.limits, self.device = cell["cfg"], cell["limits"], device
        cfg = self.cfg
        self.solve_batch = solve_batch
        self.grid = harness.terrain_grid(cfg, device)
        self.goals = traffic.make(cell["mix"], cfg, seed, device)                  # (P, B, 2)
        self.terrain = program.terrain(self.grid, cfg)
        self.scfg = program.solver_config(cfg["solver"])
        self.specs = [default_spec(self.terrain, goal_xy=(g[:, 0], g[:, 1]), duration=cfg["duration_s"],
                                   K=cfg["K"], device=device) for g in self.goals]
        for i in range(WARMUP_CALLS):
            self.solve_batch(self.specs[i % len(self.specs)], self.terrain, self.scfg).status.cpu()
        program.reset_counters()
        B = self.goals.shape[1]
        rng = random.Random(seed)
        self.rows = [rng.sample(range(B), min(ROWS_PER_CALL, B)) for _ in range(1024)]
        self.reservoir = harness.Reservoir(SAMPLE, seed)
        self.kept = [None] * SAMPLE
        self.calls = self.attempted = self.failed = 0

    def step(self, n: int) -> None:
        p = n % len(self.specs)
        res = self.solve_batch(self.specs[p], self.terrain, self.scfg)
        status = res.status.cpu()                     # the host read that ends the call
        self.calls += 1
        self.attempted += status.numel()
        self.failed += int((status != 0).sum())
        for j, r in enumerate(self.rows[n % len(self.rows)]):
            slot = self.reservoir.offer(n * ROWS_PER_CALL + j)
            if slot is not None:
                self.kept[slot] = (p, r, res.x[r].clone(), compare.stack_viol(res.viol)[r].clone())

    def end_to_end(self, window_s: float) -> dict:
        return dict(solves_per_s=(self.attempted - self.failed) / window_s)

    def counters(self) -> dict:
        return dict(program.counters(), calls=self.calls)

    def shapes(self) -> dict:
        return dict(B=self.goals.shape[1], K=self.cfg["K"], iters=self.scfg.max_iters,
                    grid_cells=self.grid.numel())

    def release(self) -> None:
        self.counted = self.counters()
        del self.specs, self.terrain

    def reference(self, precision: str = "float32"):
        """The reference's result for the kept windows, in order, at
        `precision`."""
        kept = [k for k in self.kept if k is not None]
        idx = torch.tensor([[p, r] for p, r, *_ in kept], device=self.device)
        goals = self.goals[idx[:, 0], idx[:, 1]]
        terr = ref_solver.terrain(self.grid, self.cfg)
        specs = ref_spec.default_spec(terr, goal_xy=(goals[:, 0], goals[:, 1]), duration=self.cfg["duration_s"],
                                      K=self.cfg["K"], device=self.device)
        with ref_solver.precision(precision):
            return ref_solver.solve_batch(specs, terr, ref_solver.solver_config(self.cfg["solver"]))

    def gaps(self, x, viol, ref) -> list:
        """The numbers compared: knots (n, K, NV) and violations (n, F)
        against the reference's result for the same windows."""
        return [
            dict(name="knot_gap", value=compare.knot_gap(x, ref.x), limit=self.limits["knot_gap"]),
            dict(name="viol_gap", value=compare.viol_gap(viol, compare.stack_viol(ref.viol)),
                 limit=self.limits["viol_gap"]),
        ]

    def check(self) -> list:
        kept = [k for k in self.kept if k is not None]
        x, viol = torch.stack([k[2] for k in kept]), torch.stack([k[3] for k in kept])
        c, rescue = self.counted, self.scfg.rescue_iters
        if self.device.type == "cuda":
            # one launch of each kernel per LM iteration: pass 1's on every
            # call, a rescue pass's on the calls that had one
            extra = c["btd"] - self.calls * self.scfg.max_iters
            path_ok = extra >= 0 and (extra % rescue == 0 if rescue else extra == 0) and c["assemble"] == c["btd"]
        else:
            path_ok = c["btd"] == c["assemble"] == 0
        return self.gaps(x, viol, self.reference()) + [dict(name="launch_mismatch", value=int(not path_ok), limit=0)]

    def control(self, precision: str = "tf32") -> list:
        """The numbers with the reference at `precision` put in the
        program's place."""
        low = self.reference(precision)
        return self.gaps(low.x, compare.stack_viol(low.viol), self.reference())
