"""qtos_torch batch-major Gauss-Newton assembly against qtos_tpu's
per-scenario `_assemble` (normal_eq blocks, vmapped over the batch), on a
perturbed iterate over step terrain (CPU).

Tolerance atol=rtol=2e-4, as tests/test_assemble_lanes.py: float32 blocks
with entries up to ~1e4 (squared weights), summed in another order; the
port's closed-form euler-rate and inertia Jacobians replace forward-mode
autodiff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver.jacobians import _rot_derivs, _wdot_and_derivs
from qtos_tpu.solver.solve import _assemble
from qtos_tpu.solver.transcription import initial_guess as j_initial_guess
from qtos_tpu.terrain import make_terrain as j_make_terrain
from qtos_tpu.ops.rotations import omega_to_euler_rate as j_rate

from qtos_torch.convert import config_from_reference, spec_from_reference, terrain_from_reference
from qtos_torch.solver.assemble import assemble
from qtos_torch.solver.jacobians import euler_rate_jac, rot_derivs, wdot_and_derivs

TOL = dict(atol=2e-4, rtol=2e-4)
B, K = 4, 13


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def systems():
    jterr = j_make_terrain(["step", "plane"])
    jcfg = JConfig(max_iters=3)
    goals = jnp.asarray(np.linspace(0.2, 0.6, B).astype(np.float32))
    jspecs = jax.vmap(lambda g: j_default_spec(jterr, goal_xy=(g, 0.03), K=K, duration=1.5))(goals)
    x0 = np.asarray(jax.vmap(lambda s: j_initial_guess(s, jterr, jcfg))(jspecs))
    x = x0 + 0.05 * np.random.default_rng(1).normal(size=x0.shape).astype(np.float32)
    ref = jax.vmap(lambda xx, s: _assemble(xx, s, jterr, jcfg))(jnp.asarray(x), jspecs)
    out = assemble(
        torch.from_numpy(x),
        spec_from_reference(_np_tree(jspecs), device="cpu"),
        terrain_from_reference(_np_tree(jterr), device="cpu"),
        config_from_reference(_np_tree(jcfg)),
    )
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


@pytest.mark.parametrize("i, name", [(0, "D"), (1, "L"), (2, "g"), (3, "merit")])
def test_assembly_matches(systems, i, name):
    ref, out = systems
    assert out[i].shape == ref[i].shape, name
    np.testing.assert_allclose(out[i], ref[i], err_msg=name, **TOL)


def _th_w(seed):
    rng = np.random.default_rng(seed)
    th = (0.5 * rng.normal(size=(6, 3))).astype(np.float32)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    return th, w


def test_closed_form_rotation_jacobians_match_autodiff():
    """The closed forms that replace `jax.linearize` / `jax.jacfwd`
    (atol 1e-5: O(1) entries, float32)."""
    th, w = _th_w(5)
    R, dR = rot_derivs(torch.from_numpy(th))
    jR, jdR = jax.vmap(_rot_derivs)(jnp.asarray(th))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(dR.numpy(), np.asarray(jdR), atol=1e-5)
    jd = jax.vmap(lambda t, ww: jax.jacfwd(lambda tt: j_rate(tt, ww))(t))(jnp.asarray(th), jnp.asarray(w))
    np.testing.assert_allclose(euler_rate_jac(torch.from_numpy(th), torch.from_numpy(w)).numpy(),
                               np.asarray(jd), atol=1e-5)


def test_closed_form_wdot_derivs_match_autodiff():
    """omega_dot and its derivatives (atol 1e-3 on entries up to ~1.6e3:
    float32 carries ~1e-7 relative error per product, ~2e-4 absolute here)."""
    th, w = _th_w(6)
    rng = np.random.default_rng(7)
    r = rng.normal(size=(6, 3)).astype(np.float32) * 0.1
    p = rng.normal(size=(6, 4, 3)).astype(np.float32) * 0.2
    f = rng.normal(size=(6, 4, 3)).astype(np.float32) * 5.0
    ref = jax.vmap(_wdot_and_derivs)(*[jnp.asarray(a) for a in (r, th, w, p, f)])
    out = wdot_and_derivs(*[torch.from_numpy(a) for a in (r, th, w, p, f)])
    for a, b in zip(out, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3, rtol=1e-5)
