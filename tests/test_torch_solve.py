"""qtos_torch solver loop and sampler against qtos_tpu (CPU).

`solve_batch` tolerances are those of tests/test_assemble_lanes.py:67-70
(x atol 5e-3, max_violation atol 1e-3): three LM iterations in float32 from
two assemblies whose sums run in another order.  The sampler is a fixed
Hermite evaluation of the same knots (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver import sample_trajectory as j_sample
from qtos_tpu.solver import solve_batch as j_solve_batch
from qtos_tpu.terrain import make_terrain as j_make_terrain

import qtos_torch
from qtos_torch.convert import spec_from_reference, terrain_from_reference, to_numpy
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve, solve_batch
from qtos_torch.solver.sampler import csv_to_table, table_to_csv
from qtos_torch.solver.spec import index_spec
from qtos_torch.terrain import make_terrain

B, K = 4, 13
GOALS = np.linspace(0.2, 0.5, B).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def solved():
    jterr = j_make_terrain(["plane", "plane"])
    jspecs = jax.vmap(lambda g: j_default_spec(jterr, goal_xy=(g, 0.0), K=K, duration=1.5))(
        jnp.asarray(GOALS)
    )
    jres = j_solve_batch(jspecs, jterr, JConfig(max_iters=3))
    terr = terrain_from_reference(_np_tree(jterr), device="cpu")
    specs = spec_from_reference(_np_tree(jspecs), device="cpu")
    res = solve_batch(specs, terr, SolverConfig(max_iters=3))
    return dict(jspecs=jspecs, jres=_np_tree(jres), specs=specs, terr=terr, res=to_numpy(res))


def test_solve_batch_matches(solved):
    jres, res = solved["jres"], solved["res"]
    np.testing.assert_array_equal(res.status, jres.status)
    np.testing.assert_allclose(res.x, jres.x, atol=5e-3)
    np.testing.assert_allclose(res.max_violation, jres.max_violation, atol=1e-3)
    assert res.x.shape == (B, K, 36) and res.status.dtype == np.int32
    np.testing.assert_array_equal(res.iters, 3)


def test_sampler_matches_on_same_knots(solved):
    x = solved["jres"].x[1]
    jt, jc = j_sample(jnp.asarray(x), jax.tree_util.tree_map(lambda a: a[1], solved["jspecs"]))
    t, c = sample_trajectory(torch.from_numpy(np.array(x)), index_spec(solved["specs"], 1))
    assert t.shape == (1501, 37)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_sampler_csv_roundtrip(solved, tmp_path):
    t, _ = sample_trajectory(torch.from_numpy(solved["res"].x[0]), index_spec(solved["specs"], 0))
    path = str(tmp_path / "traj.csv")
    table_to_csv(path, t)
    np.testing.assert_allclose(csv_to_table(path), t.numpy(), rtol=1e-4, atol=1e-5)


def test_solve_is_batch_of_one(solved):
    spec = index_spec(solved["specs"], 2)
    one = to_numpy(solve(spec, solved["terr"], SolverConfig(max_iters=3)))
    assert one.x.shape == (K, 36) and one.status.shape == ()
    # CPU batched products sum in a batch-size-dependent order; three LM
    # iterations amplify that to ~4e-4, inside the solver tolerance above
    assert one.status == solved["res"].status[2]
    np.testing.assert_allclose(one.x, solved["res"].x[2], atol=5e-3)


def test_rescue_pass_improves_unconverged():
    """As tests/test_solver.py's rescue case: a starved first pass (2 iters)
    leaves stragglers; the rescue pass converges them, only ever improves
    per-scenario violations, and leaves converged scenarios untouched."""
    terr = make_terrain(["plane", "plane"], device="cpu")
    goals = np.linspace(0.1, 0.45, 8).astype(np.float32)
    specs = default_spec(terr, goal_xy=(goals, 0.0), K=K, duration=1.5, device="cpu")
    starved = to_numpy(solve_batch(specs, terr, SolverConfig(max_iters=2)))
    rescued = to_numpy(solve_batch(specs, terr, SolverConfig(max_iters=2, rescue_iters=20, rescue_frac=1)))
    assert (starved.status != 0).any(), "pass 1 must leave stragglers for this case to test rescue"
    assert (rescued.max_violation <= starved.max_violation + 1e-9).all()
    assert (rescued.status == 0).all()
    ok = starved.status == 0
    np.testing.assert_array_equal(rescued.x[ok], starved.x[ok])
    np.testing.assert_array_equal(rescued.iters[~ok], 22)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_terrain(["plane"])
    with pytest.raises(RuntimeError, match="CUDA"):
        qtos_torch.resolve_device(None)
    assert qtos_torch.resolve_device("cpu").type == "cpu"
