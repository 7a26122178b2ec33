"""Multi-process scaling over `torch.distributed` (port of
`qtos_tpu.parallel.distributed`).

Every process (one per device, on one host or several) joins one process
group; the scenario axis spans all of its ranks.  NCCL carries the
collectives between cards, gloo between CPU processes.  Nothing in a cluster
tells a process its place: the caller gives the coordinator's address, the
world size and the rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from qtos_torch.parallel.mesh import ScenarioMesh, _all_gather, make_mesh, shard_batch
from qtos_torch.solver.solve import solve_batch
from qtos_torch.solver.spec import ProblemSpec, SolverConfig
from qtos_torch.terrain.heightfield import Terrain


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, device="cuda") -> torch.device:
    """Join this process to the group and return its device.

    `coordinator` is "host:port" of rank 0 (None: the `MASTER_ADDR`,
    `MASTER_PORT`, `WORLD_SIZE` and `RANK` variables a launcher sets).  On
    `device="cuda"` the backend is NCCL and rank r takes card r modulo the
    cards of its host; `device="cpu"` uses gloo."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("qtos_torch: CUDA is not available; pass device='cpu' to use gloo")
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **kwargs)
    return dev


def global_scenario_mesh(device=None) -> ScenarioMesh:
    """The scenario mesh over every rank of the process group."""
    return make_mesh(device=device)


def solve_batch_collective(specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig, mesh: ScenarioMesh):
    """Per-rank solve with an explicit all-gather of the statuses: returns
    (x, status) of this rank's own scenarios (padding dropped) and the
    statuses of the whole batch, the same on every rank, so each rank can
    stamp a whole feasibility map."""
    B = specs.goal_r.shape[0]
    res = solve_batch(shard_batch(specs, mesh), terrain, cfg)
    lo, hi = mesh.slice_of(B)
    return res.x[: hi - lo], res.status[: hi - lo], _all_gather(res.status, mesh, B)
