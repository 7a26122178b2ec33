"""qtos_torch problem definition against qtos_tpu on identical inputs (CPU):
schedules, specs, the initial guess, residuals and violations.

Tolerance atol=1e-5: float32 residuals of O(1-100) magnitude (weights up to
60) computed by the same formulas in two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver.gait import make_schedule as j_make_schedule
from qtos_tpu.solver.gait import trot_schedule as j_trot
from qtos_tpu.solver.solve import _residuals
from qtos_tpu.solver.transcription import initial_guess as j_initial_guess
from qtos_tpu.solver.transcription import violations as j_violations
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.convert import config_from_reference, spec_from_reference, terrain_from_reference
from qtos_torch.solver.gait import GAIT_REGISTRY
from qtos_torch.solver.gait import make_schedule as t_make_schedule
from qtos_torch.solver.gait import trot_schedule as t_trot
from qtos_torch.solver.spec import default_spec as t_default_spec
from qtos_torch.solver.transcription import (
    initial_guess,
    interval_residuals,
    knot_aux,
    knot_residuals,
    violations,
)
from qtos_torch.terrain.heightfield import make_terrain as t_make_terrain

ATOL = 1e-5
B, K = 4, 13
GOALS = np.linspace(0.2, 0.6, B).astype(np.float32)
TILES = ["step", "plane"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def problem():
    jterr = j_make_terrain(TILES)
    jcfg = JConfig(max_iters=3)
    jspecs = jax.vmap(
        lambda g: j_default_spec(jterr, goal_xy=(g, 0.03), K=K, duration=1.5)
    )(jnp.asarray(GOALS))
    jx0 = jax.vmap(lambda s: j_initial_guess(s, jterr, jcfg))(jspecs)
    noise = 0.05 * np.random.default_rng(1).normal(size=jx0.shape).astype(np.float32)
    x = np.asarray(jx0) + noise
    return dict(
        jterr=jterr, jcfg=jcfg, jspecs=jspecs, jx0=np.asarray(jx0), x=x,
        terr=terrain_from_reference(_np_tree(jterr), device="cpu"),
        cfg=config_from_reference(_np_tree(jcfg)),
        specs=spec_from_reference(_np_tree(jspecs), device="cpu"),
    )


@pytest.mark.parametrize("K_, duration", [(13, 1.5), (33, 2.5), (41, 2.5)])
def test_trot_schedule_matches(K_, duration):
    dt = duration / (K_ - 1)
    j = j_trot(K_, dt)
    t = t_trot(K_, dt, device="cpu")
    np.testing.assert_array_equal(t.contact.numpy(), np.asarray(j.contact))
    np.testing.assert_allclose(t.swing_progress.numpy(), np.asarray(j.swing_progress), atol=ATOL)


@pytest.mark.parametrize("gait", sorted(GAIT_REGISTRY))
def test_gait_registry_matches(gait):
    j = j_make_schedule(gait, 41, 2.5 / 40)
    t = t_make_schedule(gait, 41, 2.5 / 40, device="cpu")
    np.testing.assert_array_equal(t.contact.numpy(), np.asarray(j.contact))
    np.testing.assert_allclose(t.swing_progress.numpy(), np.asarray(j.swing_progress), atol=ATOL)


def test_default_spec_matches(problem):
    t_terr = t_make_terrain(TILES, device="cpu")
    spec = t_default_spec(t_terr, goal_xy=(GOALS, 0.03), K=K, duration=1.5, device="cpu")
    ref = problem["specs"]
    assert spec.dt == ref.dt
    for a, b in [
        (spec.start.r, ref.start.r), (spec.start.eul, ref.start.eul),
        (spec.start.v, ref.start.v), (spec.start.omega, ref.start.omega),
        (spec.start.feet, ref.start.feet), (spec.goal_r, ref.goal_r),
        (spec.goal_yaw, ref.goal_yaw), (spec.duration, ref.duration),
        (spec.schedule.contact, ref.schedule.contact),
        (spec.schedule.swing_progress, ref.schedule.swing_progress),
    ]:
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_initial_guess_matches(problem):
    x0 = initial_guess(problem["specs"], problem["terr"], problem["cfg"])
    np.testing.assert_allclose(x0.numpy(), problem["jx0"], atol=ATOL)


def test_residuals_match(problem):
    jrk, jri = jax.vmap(
        lambda xx, s: _residuals(xx, s, problem["jterr"], problem["jcfg"])
    )(jnp.asarray(problem["x"]), problem["jspecs"])
    specs, terr, cfg = problem["specs"], problem["terr"], problem["cfg"]
    x = torch.from_numpy(problem["x"])
    rk = knot_residuals(x, knot_aux(specs, terr, cfg), specs, terr, cfg)
    c = specs.schedule.contact
    ri = interval_residuals(x[:, :-1], x[:, 1:], c[:, :-1], c[:, 1:], specs, cfg)
    np.testing.assert_allclose(rk.numpy(), np.asarray(jrk), atol=ATOL)
    np.testing.assert_allclose(ri.numpy(), np.asarray(jri), atol=ATOL)


def test_violations_match(problem):
    jv = jax.vmap(lambda xx, s: j_violations(xx, s, problem["jterr"], problem["jcfg"]))(
        jnp.asarray(problem["x"]), problem["jspecs"]
    )
    tv = violations(torch.from_numpy(problem["x"]), problem["specs"], problem["terr"], problem["cfg"])
    assert sorted(tv) == sorted(jv)
    for k in jv:
        np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]), atol=ATOL, err_msg=k)
