"""Entry contract of the port (counterpart of `__graft_entry__.py`).

- `entry(device)`: the flagship computation, a batched SOLO12 gait-NLP solve,
  as a function plus its example arguments.
- `dryrun_multichip(n, device)`: one sharded solve over n ranks (one process
  per device) on the same tiny problem, checked: every scenario's max
  violation falls below its initial guess's, and every status is 0.

    python3 -m qtos_torch.entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _tiny_problem(batch: int, K: int = 13, max_iters: int = 3, device=None):
    """Plane terrain, `batch` trot windows of 1.5 s to goals 0.15-0.45 m."""
    from qtos_torch.solver import SolverConfig, default_spec
    from qtos_torch.terrain import make_terrain

    terrain = make_terrain(["plane"], device=device)
    cfg = SolverConfig(max_iters=max_iters)
    goals = torch.linspace(0.15, 0.45, batch, device=terrain.device)
    specs = default_spec(terrain, goal_xy=(goals, 0.0), K=K, duration=1.5, device=terrain.device)
    return terrain, cfg, specs


def entry(device=None):
    """(fn, example_args): fn(specs) -> (x, status, max_violation) solves the
    batch; the arguments are 4 tiny windows on `device` (None: CUDA)."""
    from qtos_torch.solver.solve import solve_batch

    terrain, cfg, specs = _tiny_problem(batch=4, device=device)

    def step(specs_batch):
        res = solve_batch(specs_batch, terrain, cfg)
        return res.x, res.status, res.max_violation

    return step, (specs,)


def _dryrun_rank(mesh) -> dict:
    """One rank of `dryrun_multichip`: the whole batch's gathered result."""
    from qtos_torch.parallel.mesh import solve_batch_sharded
    from qtos_torch.solver.transcription import initial_guess, max_violation, violations

    terrain, cfg, specs = _tiny_problem(batch=2 * mesh.world, device=mesh.device)
    res = solve_batch_sharded(specs, terrain, cfg, mesh)
    v0 = max_violation(violations(initial_guess(specs, terrain, cfg), specs, terrain, cfg))
    return dict(x_shape=tuple(res.x.shape), status=res.status.cpu().numpy(), v0=v0.cpu().numpy(),
                v1=res.max_violation.cpu().numpy())


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One sharded solve step over n ranks (tiny shapes), with
    `__graft_entry__.dryrun_multichip`'s semantic checks.  On "cuda" each
    rank takes its own card, and fewer than n cards is an error, never a
    fall back to fewer ranks or to the CPU."""
    from qtos_torch.parallel.worker import run_ranks

    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, found {have}")
    outs = run_ranks(_dryrun_rank, n_devices, device)
    out = outs[0]
    for other in outs[1:]:                            # every rank holds the same gathered result
        if not (np.array_equal(other["status"], out["status"]) and np.array_equal(other["v1"], out["v1"])):
            raise AssertionError("ranks disagree on the gathered result")
    v0, v1, status = out["v0"], out["v1"], out["status"]
    if out["x_shape"][0] != 2 * n_devices:
        raise AssertionError(f"gathered x has shape {out['x_shape']}, expected {2 * n_devices} scenarios")
    if not (v1 < v0).all():
        raise AssertionError(f"sharded solve failed to improve on the initial guess: "
                             f"v0={v0.tolist()} v1={v1.tolist()}")
    if not (status == 0).all():
        raise AssertionError(f"sharded solve left unconverged scenarios: statuses={status.tolist()} "
                             f"viol={v1.tolist()}")
    print(f"dryrun_multichip({n_devices}): ok, statuses={status.tolist()}, "
          f"violation {float(v0.max()):.3g} -> {float(v1.max()):.3g}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="qtos_torch entry contract")
    ap.add_argument("n", type=int, nargs="?", default=1, help="ranks of the dry run")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)
