"""Scenario-axis sharding over `torch.distributed` (port of
`qtos_tpu.parallel.mesh`).

One process per device.  Rank r of a world of W owns the contiguous slice
[r * per, (r + 1) * per) of every batch, per = ceil(B / W), and solves it with
`solve_batch`; scenarios are independent, so the solve needs no
communication, and the one collective is the all-gather of the results.
Collectives with NCCL need equal sizes on every rank, so a short slice (the
last ones when W does not divide B) is padded by repeating its last scenario
and the padding is dropped after the gather.  A process with no process
group is a mesh of one rank and gathers nothing; in a group, even of one
rank, every gather goes through the backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from qtos_torch.solver.solve import SolveResult, solve_batch
from qtos_torch.solver.spec import ProblemSpec, SolverConfig, index_spec
from qtos_torch.terrain.heightfield import Terrain

@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The ranks of the running process group laid along the scenario axis."""

    world: int
    rank: int
    device: torch.device

    def slice_of(self, B: int, rank: int | None = None) -> tuple[int, int]:
        """[start, stop) of the scenarios `rank` (default: this one) owns."""
        per = -(-B // self.world)
        r = self.rank if rank is None else rank
        return min(r * per, B), min((r + 1) * per, B)


def make_mesh(n_devices: int | None = None, device=None) -> ScenarioMesh:
    """The scenario mesh of this process: every rank of the process group
    (`n_devices`, when given, must be its size), or this process alone when
    there is none.  `device` is this rank's device (default: the current
    CUDA device under NCCL, the CPU under gloo)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for a mesh of {n_devices} devices, the process group has {world} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    return ScenarioMesh(world=world, rank=rank, device=torch.device(device))


def shard_batch(specs: ProblemSpec, mesh: ScenarioMesh) -> ProblemSpec:
    """This rank's slice of a batched spec, padded to ceil(B / world) by
    repeating its last scenario (the batch's last one for a rank past the
    end)."""
    B = specs.goal_r.shape[0]
    per = -(-B // mesh.world)
    idx = torch.clamp(torch.arange(mesh.rank * per, (mesh.rank + 1) * per), max=B - 1)
    return index_spec(specs, idx.to(specs.goal_r.device))


def _all_gather(t: torch.Tensor, mesh: ScenarioMesh, B: int) -> torch.Tensor:
    """Concatenate every rank's equal-sized `t` along axis 0 and drop the
    padding beyond B."""
    if not (dist.is_available() and dist.is_initialized()):
        return t[:B]
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)[:B]


def gather_result(local: SolveResult, mesh: ScenarioMesh, B: int) -> SolveResult:
    """The whole batch's SolveResult on every rank from each rank's padded
    slice."""
    g = lambda t: _all_gather(t, mesh, B)                                # noqa: E731
    return SolveResult(
        x=g(local.x),
        status=g(local.status),
        merit=g(local.merit),
        max_violation=g(local.max_violation),
        viol={k: g(v) for k, v in local.viol.items()},
        iters=g(local.iters),
    )


def solve_batch_sharded(specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig, mesh: ScenarioMesh) -> SolveResult:
    """Batched solve with the scenarios sharded over the mesh: each rank
    solves its slice, then every result is all-gathered.  `specs` is the
    whole batch, on this rank's device."""
    B = specs.goal_r.shape[0]
    local = solve_batch(shard_batch(specs, mesh), terrain, cfg)
    return gather_result(local, mesh, B)


def feasibility_statuses_sharded(specs: ProblemSpec, terrain: Terrain, cfg: SolverConfig,
                                 mesh: ScenarioMesh) -> np.ndarray:
    """Sharded feasibility probe: the statuses gathered to the host for map
    stamping."""
    return solve_batch_sharded(specs, terrain, cfg, mesh).status.cpu().numpy()
