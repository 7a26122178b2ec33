"""Closed-loop driver of `qtos_torch.control.replan.plan_windows_batch` on a
world that changes while the robot walks: `plan_windows_batch.py`'s replan
loop, with a box dropped into the world every `world_every` replans.

Set-up makes the mix's worlds and replans (traffic kind `replans_world`)
and warms the call up on them.  Every `world_every`-th step of the window
first makes the next world with the program's own `add_box_obstacle` on
the configuration's terrain, a fresh grid tensor as the runner makes one,
and then replans on it; that step's latency runs from the world change to
the host read of the candidates' statuses and violations.  The other steps
replan on the world as it stands.  A seeded reservoir keeps a few of the
worlds whose replans stand a foot on ground their box changed (the
traffic's `seen`: on the others the box decides nothing, and a plan on the
wrong world could not show), each with its replans' knots, statuses,
violations, tables and contacts; the window's first world is kept apart,
for a window too short to meet a seen world.  A second reservoir keeps the
knots and reported violations of more seen worlds' replans, for the report
check alone, which needs no solve.

After the window the reference plans each kept replan on that replan's own
world (the reference's box, `reference/world.py`), the replans of one world
in one batch, and the check is `plan_windows_batch.py`'s: `start_gap`,
`merit_excess`, `viol_excess_median`, `report_gap` and `launch_mismatch`,
`report_gap` also over the second reservoir's replans, each on its own
world (violations only).  A number the cell gives no limit is left out of
the check and kept in `detail`: `start_gap` here, since at the box's ramp
the reference moved by 1e-6 m parts from its own start about as far as a
stale world's start does.  None of them asks whether a call replayed a
graph.  The controls are that driver's, `stale_world` (the reference plans
each kept replan on the world before its own), and a sound one, `nudged`:
the reference plans from start rows moved 1e-6 m along x, the spread of the
problem itself, which a limit has to hold.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness, program, traffic
from benchmark.reference import compare
from benchmark.reference import solver as ref_solver

BASE = harness.load_module("drivers", "plan_windows_batch")
START_ITERS = BASE.START_ITERS
FAULTS = BASE.FAULTS
STALE = "stale_world"
NUDGED = "nudged"
NUDGE_M = 1e-6
X_COLUMNS = [1, 7, 10, 13, 16]   # the start row's CoM x and the four feet's x
NUMBERS = ("start_gap", "report_gap", "viol_excess_median", "merit_excess")
REPORT_WORLDS = 16               # seen worlds whose reports the check reads besides the kept ones
# the graph counters of `plan_windows_batch` that the window's deltas report
# (`new_worlds` where the program counts it)
GRAPH_COUNTERS = ("captures", "replays", "new_worlds")


class Driver(BASE.Driver):
    def __init__(self, cell: dict, seed: int, device):
        from qtos_torch.control.replan import plan_windows_batch
        from qtos_torch.terrain.heightfield import add_box_obstacle

        self.cfg, self.checked, self.device = cell["cfg"], cell["limits"], device
        # the base's `gaps` reads a limit of every number; those the cell
        # gives none are left out of the check (`gaps`)
        self.limits = dict(dict.fromkeys(NUMBERS, math.inf), **self.checked)
        cfg = self.cfg
        self.plan, self.add_box = plan_windows_batch, add_box_obstacle
        self.grid = harness.terrain_grid(cfg, device)
        self.inputs = traffic.make(cell["mix"], cfg, seed, device)
        self.pool, self.per = self.inputs["rows"].shape[0], cell["mix"]["world_every"]
        self.box_x, self.seen = self.inputs["box_x"].tolist(), self.inputs["seen"].tolist()
        self.ground = self.terrain = program.terrain(self.grid, cfg)
        self.rcfg = program.runner_config(cfg)
        for n in range(BASE.WARMUP_CALLS):
            self._replan(n)
        program.reset_counters()
        self.graphs0 = self._graph_counts()
        worlds_kept = BASE.SAMPLE // self.per
        self.reservoir = harness.Reservoir(worlds_kept, seed)
        self.kept = [None] * (worlds_kept * self.per)
        self.slot, self.seen_worlds, self.first = None, 0, []
        self.reports = harness.Reservoir(REPORT_WORLDS, seed + 1)
        self.reported = [None] * (REPORT_WORLDS * self.per)
        self.rslot = None
        self.latencies = []
        self.attempted = self.failed = 0

    def world(self, w: int):
        """The program's terrain of world `w`: the box dropped into the
        configuration's terrain by `add_box_obstacle`, a fresh grid."""
        box = self.cfg["box"]
        return self.add_box(self.ground, self.box_x[w], self.inputs["box_y"], half=box["half"], height=box["top"])

    def _replan(self, n: int):
        p = n % self.pool
        if p % self.per == 0:
            self.terrain = self.world(p // self.per)
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
        self.failed += BASE.select(status, viol, self.cfg["usable_viol"]) is None
        j = n % self.per
        if j == 0:                               # a new world: offered to the reservoirs whole if seen
            self.slot, self.rslot = -1 if n == 0 else None, None
            if self.seen[p // self.per]:
                self.slot = self.reservoir.offer(self.seen_worlds)
                self.rslot = self.reports.offer(self.seen_worlds)
                self.seen_worlds += 1
            if self.slot is not None and self.slot >= 0:
                self.kept[self.slot * self.per:(self.slot + 1) * self.per] = [None] * self.per
            if self.rslot is not None:
                self.reported[self.rslot * self.per:(self.rslot + 1) * self.per] = [None] * self.per
        if self.rslot is not None:
            self.reported[self.rslot * self.per + j] = (p, res.x.clone(), compare.stack_viol(res.viol).clone())
        if self.slot is not None:
            entry = (p, res.x.clone(), res.status.clone(), compare.stack_viol(res.viol).clone(), tables.clone(),
                     contacts.clone())
            if self.slot < 0:
                self.first.append(entry)
            else:
                self.kept[self.slot * self.per + j] = entry

    def _graph_counts(self) -> dict:
        return {name: getattr(self.plan, name) for name in GRAPH_COUNTERS if hasattr(self.plan, name)}

    def counters(self) -> dict:
        graphs = {name: n - self.graphs0[name] for name, n in self._graph_counts().items()}
        return dict(super().counters(), **graphs)

    def _groups(self) -> tuple:
        """The kept replans (the window's first world's where no seen world
        came), and for each kept world the places of its replans among
        them."""
        kept = [k for k in self.kept if k is not None] or self.first
        groups = {}
        for j, entry in enumerate(kept):
            groups.setdefault(entry[0] // self.per, []).append(j)
        return kept, groups

    def _candidates(self, js: list) -> torch.Tensor:
        k = self.cfg["n_candidates"]
        return torch.cat([torch.arange(j * k, (j + 1) * k) for j in js]).to(self.device)

    def _reference(self, ps: list, precision: str, grid=None, nudge: float = 0.0, **changes):
        """The reference's terrain over `grid` (default: the world of the
        replans `ps`, all of one world), solver settings, specs, path times
        and (result, tables, contacts) of those replans, their candidates in
        one batch, at `precision`, from start rows moved `nudge` m along x,
        with the cell's solver settings changed by `changes`."""
        terr, scfg, specs, t0s = self._problem(ps, grid, nudge, **changes)
        with ref_solver.precision(precision):
            return terr, scfg, specs, t0s, ref_solver.plan_windows(specs, t0s, terr, scfg)

    def _problem(self, ps: list, grid=None, nudge: float = 0.0, **changes):
        """`_reference`'s terrain, solver settings, specs and path times."""
        def cat(key):
            return torch.cat([self.inputs[key][p] for p in ps])

        if grid is None:
            grid = self.inputs["worlds"][ps[0] // self.per]
        rows = cat("rows")
        if nudge:
            rows = rows.clone()
            rows[:, X_COLUMNS] += nudge
        terr = ref_solver.terrain(grid, self.cfg)
        scfg = ref_solver.solver_config(self.cfg["solver"]).replace(**changes)
        specs = ref_solver.replan_specs(rows, cat("goals_r"), cat("goals_yaw"), terr, K=self.cfg["K"],
                                        duration=self.cfg["window_duration"], gait=self.cfg["gait"])
        return terr, scfg, specs, cat("t0s")

    def _report(self, wide: list) -> float:
        """The report check over `wide`, (replan, knots, reported
        violations) of whole worlds: the widest gap, in units of the
        solver's `tol`, between the violations reported and the reference's
        evaluation of the knots on the replan's own world."""
        gap, groups = 0.0, {}
        for entry in wide:
            groups.setdefault(entry[0] // self.per, []).append(entry)
        for entries in groups.values():
            terr, scfg, specs, t0s = self._problem([e[0] for e in entries])
            viol_ref = ref_solver.violations(torch.cat([e[1] for e in entries]), specs, terr, scfg)
            gap = max(gap, compare.viol_gap(torch.cat([e[2] for e in entries]), compare.stack_viol(viol_ref))
                      / scfg.tol)
        return gap

    def gaps(self, start, timed, wide=()) -> list:
        """`plan_windows_batch.py`'s numbers over the kept replans'
        candidates (`start`, `timed` as it takes them, candidates in the
        kept order): its own `gaps` on each kept world in turn, the
        reference on that world, then the widest of each number over the
        worlds, the median candidate's violation excess over them all, and
        `report_gap` over `wide` too (`_report`).  Numbers without a limit
        in the cell are left out, and kept in `detail`."""
        kept, groups = self._groups()
        parts, details, slots = [], [], self.kept
        try:
            for js in groups.values():
                idx = self._candidates(js)
                self.kept = [kept[j] for j in js]
                parts.append({c["name"]: c["value"] for c in super().gaps([t[idx] for t in start],
                                                                           [t[idx] for t in timed])})
                details.append(self.detail)
        finally:
            self.kept = slots
        self.detail = {key: [v for d in details for v in d[key]] for key in details[0]}
        self.detail["worlds"] = list(groups)
        self.detail["seen"] = [self.seen[w] for w in groups]
        self.detail["per_world"] = parts
        values = {name: max(part[name] for part in parts) for name in parts[0]}
        values["viol_excess_median"] = float(torch.tensor(self.detail["viol_ratio"], dtype=torch.float64).median()) - 1
        self.detail["report_wide"] = self._report(wide)
        self.detail["report_worlds"] = len({e[0] // self.per for e in wide})
        values["report_gap"] = max(values["report_gap"], self.detail["report_wide"])
        self.detail["values"] = values
        return [dict(name=k, value=v, limit=self.limits[k]) for k, v in values.items() if k in self.checked]

    def check(self) -> list:
        kept, _ = self._groups()
        # the start: the program's own entry on the kept replans, each on its
        # own world, its solver cut to the first START_ITERS iterations
        cut = self.rcfg.solver.replace(max_iters=START_ITERS)
        i = self.inputs
        start = [self.plan(i["rows"][p], i["goals_r"][p], i["goals_yaw"][p], self.world(p // self.per), self.rcfg,
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
        wide = [r for r in self.reported if r is not None]
        return self.gaps(start, timed, wide) + [dict(name="launch_mismatch", value=int(not path_ok), limit=0)]

    def control(self, name: str = "tf32") -> list:
        """The numbers with the reference put in the program's place: at
        precision `name`, with the fault `name` of FAULTS planted, planning
        each kept replan on the world before its own (`stale_world`, the
        second reservoir's replans too), or from its start rows moved
        NUDGE_M along x (`nudged`).  Only `stale_world` plans the second
        reservoir's worlds: the others plan and report on the world the
        report is checked on."""
        kept, groups = self._groups()
        precision, changes = ("float32", FAULTS[name]) if name in FAULTS else \
            ("float32", {}) if name in (STALE, NUDGED) else (name, {})
        nudge = NUDGE_M if name == NUDGED else 0.0
        n_worlds = self.inputs["worlds"].shape[0]
        start, timed = [None] * len(kept), [None] * len(kept)
        k = self.cfg["n_candidates"]
        for w, js in groups.items():
            ps = [kept[j][0] for j in js]
            grid = self.inputs["worlds"][(w - 1) % n_worlds] if name == STALE else None
            s3 = self._reference(ps, precision, grid, nudge, **dict(changes, max_iters=START_ITERS))[-1]
            res, tables, contacts = self._reference(ps, precision, grid, nudge, **changes)[-1]
            for n, j in enumerate(js):
                c = slice(n * k, (n + 1) * k)
                start[j] = (s3[0].x[c], s3[1][c], s3[2][c])
                timed[j] = (res.x[c], res.status[c], compare.stack_viol(res.viol)[c], tables[c], contacts[c])
        start = tuple(torch.cat([s[m] for s in start]) for m in range(3))
        timed = tuple(torch.cat([t[m] for t in timed]) for m in range(5))
        wide = []
        if name == STALE:
            reported = {}
            for entry in self.reported:
                if entry is not None:
                    reported.setdefault(entry[0] // self.per, []).append(entry[0])
            for w, ps in reported.items():
                res = self._reference(ps, precision, self.inputs["worlds"][(w - 1) % n_worlds])[-1][0]
                wide += [(p, res.x[n * k:(n + 1) * k], compare.stack_viol(res.viol)[n * k:(n + 1) * k])
                         for n, p in enumerate(ps)]
        return self.gaps(start, timed, wide)
