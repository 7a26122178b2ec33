"""qtos_torch's two derivations of the Gauss-Newton blocks against qtos_tpu
and against each other (CPU): the dense Jacobians of
`qtos_torch.solver.jacobians`, the block-space normal equations of
`qtos_torch.solver.normal_eq`, and the batch system of
`qtos_torch.solver.assemble`.

The problem is K=13, n=36 (`__graft_entry__`'s shape): 3 windows on the
`step` tile beside a plane, started 8 cm to the side so the left feet stand
on the 0.13 m riser's ramp (non-zero terrain gradient), perturbed off the
initial guess so the hinges activate on both sides; the trot schedule
switches contacts inside the window.

Tolerances.  Residual rows atol 1e-5; Jacobian rows atol 2e-4 (those of
tests/test_jacobians.py: float32 products of entries up to ~1e3).  Normal
equations are held at 1e-4 relative: rtol 1e-4 plus atol 1e-4 times the
array's largest entry (the squared weights make entries up to ~1e4, whose
float32 sums carry ~1e-7 relative error per term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.solver import SolverConfig as JConfig
from qtos_tpu.solver import default_spec as j_default_spec
from qtos_tpu.solver.jacobians import interval_system as j_interval_system
from qtos_tpu.solver.jacobians import knot_system as j_knot_system
from qtos_tpu.solver.normal_eq import interval_normal as j_interval_normal
from qtos_tpu.solver.normal_eq import knot_normal as j_knot_normal
from qtos_tpu.solver.solve import _aux as j_aux
from qtos_tpu.solver.transcription import initial_guess as j_initial_guess
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.convert import config_from_reference, spec_from_reference, terrain_from_reference
from qtos_torch.solver.assemble import assemble
from qtos_torch.solver.jacobians import interval_system, knot_system
from qtos_torch.solver.normal_eq import interval_normal, knot_normal
from qtos_torch.solver.transcription import knot_aux

B, K = 3, 13
ATOL_RES, ATOL_JAC = 1e-5, 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(out, ref, name):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


@pytest.fixture(scope="module")
def problem():
    jterr = j_make_terrain(["step", "plane"])
    jcfg = JConfig(max_iters=3)
    goals = jnp.asarray(np.linspace(0.3, 0.6, B).astype(np.float32))
    jspecs = jax.vmap(lambda g: j_default_spec(jterr, start_xy=(0.0, 0.08), goal_xy=(g, 0.08), K=K,
                                               duration=1.5))(goals)
    x0 = np.asarray(jax.vmap(lambda s: j_initial_guess(s, jterr, jcfg))(jspecs))
    x = x0 + 0.05 * np.random.default_rng(2).normal(size=x0.shape).astype(np.float32)
    jaux = jax.vmap(lambda s: j_aux(s, jterr, jcfg))(jspecs)
    terr = terrain_from_reference(_np_tree(jterr), device="cpu")
    specs = spec_from_reference(_np_tree(jspecs), device="cpu")
    cfg = config_from_reference(_np_tree(jcfg))
    return dict(jterr=jterr, jcfg=jcfg, jspecs=jspecs, jaux=jaux, jx=jnp.asarray(x), x=torch.from_numpy(x),
                terr=terr, specs=specs, cfg=cfg, aux=knot_aux(specs, terr, cfg))


def _j_knots(fn, p):
    """A per-knot qtos_tpu function over (B, K)."""
    return jax.vmap(lambda xs, s, a: jax.vmap(lambda xk, ak: fn(xk, ak, s, p["jterr"], p["jcfg"]))(xs, a))(
        p["jx"], p["jspecs"], p["jaux"])


def _j_intervals(fn, p):
    """A per-interval qtos_tpu function over (B, K-1)."""
    c = p["jspecs"].schedule.contact
    return jax.vmap(lambda xs, s, cs: jax.vmap(lambda a, b, ca, cb: fn(a, b, ca, cb, s, p["jcfg"]))(
        xs[:-1], xs[1:], cs[:-1], cs[1:]))(p["jx"], p["jspecs"], c)


def _intervals(fn, p):
    c = p["specs"].schedule.contact
    return fn(p["x"][:, :-1], p["x"][:, 1:], c[:, :-1], c[:, 1:], p["specs"], p["cfg"])


def test_cases_cover_a_contact_switch_and_a_riser(problem):
    c = problem["specs"].schedule.contact
    assert bool((c[:, 1:] != c[:, :-1]).any())                          # a foot lifts or lands
    from qtos_torch.terrain.heightfield import grad_at

    p = problem["x"][..., 12:24].reshape(B, K, 4, 3)
    _, hy = grad_at(problem["terr"], p[..., 0], p[..., 1])
    assert float(hy.abs().max()) > 1.0                                   # a foot on the riser's ramp


def test_knot_system_matches_reference(problem):
    res, J = knot_system(problem["x"], problem["aux"], problem["specs"], problem["terr"], problem["cfg"])
    jres, jJ = _j_knots(j_knot_system, problem)
    assert tuple(J.shape) == (B, K, jJ.shape[-2], 36)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), atol=ATOL_RES)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=ATOL_JAC)


def test_interval_system_matches_reference(problem):
    res, Ja, Jb = _intervals(interval_system, problem)
    jres, jJa, jJb = _j_intervals(j_interval_system, problem)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), atol=ATOL_RES)
    np.testing.assert_allclose(Ja.numpy(), np.asarray(jJa), atol=ATOL_JAC)
    np.testing.assert_allclose(Jb.numpy(), np.asarray(jJb), atol=ATOL_JAC)


def test_knot_normal_matches_reference(problem):
    out = knot_normal(problem["x"], problem["aux"], problem["specs"], problem["terr"], problem["cfg"])
    ref = _j_knots(j_knot_normal, problem)
    for o, r, name in zip(out, ref, ("D", "g", "sq")):
        _rel(o.numpy(), r, name)


def test_interval_normal_matches_reference(problem):
    out = _intervals(interval_normal, problem)
    ref = _j_intervals(j_interval_normal, problem)
    for o, r, name in zip(out, ref, ("Daa", "Dbb", "Lba", "ga", "gb", "sq")):
        _rel(o.numpy(), r, name)


def test_knot_normal_is_the_dense_product(problem):
    """D = J^T J, g = J^T rho, sq = |rho|^2 of the dense knot rows."""
    res, J = knot_system(problem["x"], problem["aux"], problem["specs"], problem["terr"], problem["cfg"])
    D, g, sq = knot_normal(problem["x"], problem["aux"], problem["specs"], problem["terr"], problem["cfg"])
    _rel(D.numpy(), (J.transpose(-1, -2) @ J).numpy(), "D")
    _rel(g.numpy(), (J.transpose(-1, -2) @ res[..., None])[..., 0].numpy(), "g")
    _rel(sq.numpy(), (res * res).sum(-1).numpy(), "sq")


def test_interval_normal_is_the_dense_product(problem):
    res, Ja, Jb = _intervals(interval_system, problem)
    Daa, Dbb, Lba, ga, gb, sq = _intervals(interval_normal, problem)
    T = lambda m: m.transpose(-1, -2)                                   # noqa: E731
    _rel(Daa.numpy(), (T(Ja) @ Ja).numpy(), "Daa")
    _rel(Dbb.numpy(), (T(Jb) @ Jb).numpy(), "Dbb")
    _rel(Lba.numpy(), (T(Jb) @ Ja).numpy(), "Lba")
    _rel(ga.numpy(), (T(Ja) @ res[..., None])[..., 0].numpy(), "ga")
    _rel(gb.numpy(), (T(Jb) @ res[..., None])[..., 0].numpy(), "gb")
    _rel(sq.numpy(), (res * res).sum(-1).numpy(), "sq")


@pytest.fixture(scope="module")
def dense_system(problem):
    """The whole K=13 system built from the dense Jacobians alone."""
    res, J = knot_system(problem["x"], problem["aux"], problem["specs"], problem["terr"], problem["cfg"])
    ri, Ja, Jb = _intervals(interval_system, problem)
    T = lambda m: m.transpose(-1, -2)                                   # noqa: E731
    D = T(J) @ J
    g = (T(J) @ res[..., None])[..., 0]
    D[:, :-1] += T(Ja) @ Ja
    D[:, 1:] += T(Jb) @ Jb
    g[:, :-1] += (T(Ja) @ ri[..., None])[..., 0]
    g[:, 1:] += (T(Jb) @ ri[..., None])[..., 0]
    merit = 0.5 * ((res * res).sum((-1, -2)) + (ri * ri).sum((-1, -2)))
    return D, T(Jb) @ Ja, g, merit


@pytest.mark.parametrize("i, name", [(0, "D"), (1, "L"), (2, "g"), (3, "merit")])
def test_dense_system_matches_assemble(problem, dense_system, i, name):
    out = assemble(problem["x"], problem["specs"], problem["terr"], problem["cfg"], problem["aux"])
    assert out[i].shape == dense_system[i].shape
    _rel(out[i].numpy(), dense_system[i].numpy(), name)
