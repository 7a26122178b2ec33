"""Scenario-axis scaling over `torch.distributed` (port of
`qtos_tpu.parallel`): one process per device, each solving its contiguous
slice of the batch; the results are all-gathered."""

from qtos_torch.parallel.mesh import (  # noqa: F401
    ScenarioMesh,
    feasibility_statuses_sharded,
    make_mesh,
    shard_batch,
    solve_batch_sharded,
)
