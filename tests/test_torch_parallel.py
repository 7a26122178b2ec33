"""qtos_torch.parallel and qtos_torch.entry over two gloo CPU processes,
against qtos_tpu's `solve_batch` on the same specs (the tiny problem of
`__graft_entry__`: plane, K=13, 1.5 s windows to goals 0.15-0.45 m, three LM
iterations).

Tolerances are those of tests/test_torch_solve.py (x atol 5e-3,
max_violation atol 1e-3; statuses equal): three float32 LM iterations from
two assemblies whose sums run in another order.  The sharded port against
the unsharded port uses the same bounds, since each rank solves a smaller
batch and CPU batched products sum in a batch-size-dependent order.  The
gathered statuses equal the ranks' local ones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver import solve_batch as j_solve_batch
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.entry import _tiny_problem, dryrun_multichip, entry
from qtos_torch.parallel import ScenarioMesh, feasibility_statuses_sharded, make_mesh, shard_batch
from qtos_torch.parallel.mesh import solve_batch_sharded
from qtos_torch.parallel.worker import run_ranks, solve_cases
from qtos_torch.solver import solve_batch
from qtos_torch.solver.spec import index_spec

BATCHES = (5, 8)
WORLD = 2


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results at B=5 and B=8, from one 2-process gloo group."""
    return run_ranks(solve_cases, WORLD, "cpu", BATCHES, timeout=300)


@pytest.fixture(scope="module")
def reference():
    """qtos_tpu's solve_batch on both batches' specs, solved as one batch
    (one compilation; its scenarios are independent under `jax.vmap`)."""
    jterr = j_make_terrain(["plane"])
    goals = jnp.concatenate([jnp.linspace(0.15, 0.45, B) for B in BATCHES])
    specs = jax.vmap(lambda g: j_default_spec(jterr, goal_xy=(g, 0.0), K=13, duration=1.5))(goals)
    res = j_solve_batch(specs, jterr, JConfig(max_iters=3))
    out, lo = [], 0
    for B in BATCHES:
        out.append(tuple(np.asarray(a)[lo:lo + B] for a in (res.x, res.status, res.max_violation)))
        lo += B
    return out


@pytest.mark.parametrize("i", range(len(BATCHES)), ids=[f"B{b}" for b in BATCHES])
def test_sharded_solve_matches_the_reference(ranks, reference, i):
    B = BATCHES[i]
    jx, jst, jv = reference[i]
    for r in ranks:
        out = r[i]
        assert out["x"].shape == (B, 13, 36) and out["world"] == WORLD
        np.testing.assert_array_equal(out["status"], jst)
        np.testing.assert_allclose(out["x"], jx, atol=5e-3)
        np.testing.assert_allclose(out["max_violation"], jv, atol=1e-3)


@pytest.mark.parametrize("i", range(len(BATCHES)), ids=[f"B{b}" for b in BATCHES])
def test_sharded_solve_matches_the_unsharded_port(ranks, i):
    B = BATCHES[i]
    terrain, cfg, specs = _tiny_problem(B, device="cpu")
    res = solve_batch(specs, terrain, cfg)
    for r in ranks:
        np.testing.assert_array_equal(r[i]["status"], res.status.numpy())
        np.testing.assert_allclose(r[i]["x"], res.x.numpy(), atol=5e-3)


@pytest.mark.parametrize("i", range(len(BATCHES)), ids=[f"B{b}" for b in BATCHES])
def test_collective_gathers_the_local_statuses(ranks, i):
    """Every rank's gathered statuses are the concatenation of the ranks'
    own, each rank's own slice is contiguous and unpadded, and the sharded
    solve's gathered x holds each rank's local x."""
    B = BATCHES[i]
    local = np.concatenate([r[i]["status_local"] for r in ranks])
    assert local.shape == (B,)
    lo = 0
    for r in ranks:
        out = r[i]
        np.testing.assert_array_equal(out["status_gathered"], local)
        np.testing.assert_array_equal(out["status_gathered"], out["status"])
        start, stop = out["slice"]
        assert start == lo and out["x_local"].shape == (stop - start, 13, 36)
        np.testing.assert_array_equal(out["x_local"], out["x"][start:stop])
        lo = stop
    assert lo == B


def test_shard_batch_pads_by_repeating_the_last_scenario():
    terrain, cfg, specs = _tiny_problem(5, device="cpu")
    goals = specs.goal_r[:, 0]
    want = {0: [0, 1], 1: [2, 3], 2: [4, 4]}
    for rank, idx in want.items():
        mesh = ScenarioMesh(world=3, rank=rank, device=torch.device("cpu"))
        torch.testing.assert_close(shard_batch(specs, mesh).goal_r[:, 0], goals[idx], rtol=0, atol=0)
    assert [ScenarioMesh(3, r, torch.device("cpu")).slice_of(5) for r in range(3)] == [(0, 2), (2, 4), (4, 5)]
    # more ranks than scenarios: a rank past the end repeats the batch's last
    mesh = ScenarioMesh(world=4, rank=3, device=torch.device("cpu"))
    assert mesh.slice_of(2) == (2, 2)
    torch.testing.assert_close(shard_batch(index_spec(specs, slice(0, 2)), mesh).goal_r[:, 0], goals[[1]])


def test_one_process_is_a_mesh_of_one():
    mesh = make_mesh()
    assert (mesh.world, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        make_mesh(2)
    terrain, cfg, specs = _tiny_problem(3, device="cpu")
    res = solve_batch(specs, terrain, cfg)
    sharded = solve_batch_sharded(specs, terrain, cfg, mesh)
    torch.testing.assert_close(sharded.x, res.x, rtol=0, atol=0)
    np.testing.assert_array_equal(feasibility_statuses_sharded(specs, terrain, cfg, mesh), res.status.numpy())


def test_entry_solves_the_tiny_problem():
    fn, args = entry("cpu")
    x, status, viol = fn(*args)
    assert tuple(x.shape) == (4, 13, 36) and (status == 0).all() and bool((viol < 3e-3).all())


def test_dryrun_multichip_over_two_cpu_processes(capsys):
    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): ok, statuses=[0, 0, 0, 0]" in capsys.readouterr().out


def test_dryrun_multichip_refuses_missing_cards():
    n = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(RuntimeError, match="CUDA cards"):
        dryrun_multichip(n, device="cuda")
