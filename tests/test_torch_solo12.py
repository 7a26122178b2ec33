"""qtos_torch SOLO12 kinematics against qtos_tpu on identical inputs (CPU).

Tolerance atol=1e-5: float32 trigonometric closed forms of O(0.1-1)
magnitude computed by the same formulas in two frameworks.  The closed-form
Jacobian is held against JAX's forward-mode autodiff of `leg_fk`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.models.solo12 import Solo12 as JSolo12

from qtos_torch.models.solo12 import Solo12

ATOL = 1e-5
B = 16


def _joints(seed, shape=(B,)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.8, 0.8, size=shape + (12,)).astype(np.float32)


def _feet(seed, shape=(B,), spread=0.08):
    """Feet around the nominal stance; `spread` 0.08 stays reachable, 0.5
    leaves the workspace (the legs are 0.32 m long)."""
    rng = np.random.default_rng(seed)
    nominal = np.asarray(JSolo12.nominal_feet, np.float32)
    return (nominal + rng.uniform(-spread, spread, size=shape + (4, 3))).astype(np.float32)


def _pose(seed, shape=(B,)):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, size=shape + (3,)).astype(np.float32)
    eul = rng.uniform(-0.5, 0.5, size=shape + (3,)).astype(np.float32)
    return pos, eul


def test_constants_match():
    c = Solo12.tensors("cpu")
    np.testing.assert_allclose(c.hips.numpy(), np.asarray(JSolo12.hip_positions()), atol=0)
    np.testing.assert_allclose(Solo12.hip_positions("cpu").numpy(), c.hips.numpy(), atol=0)
    np.testing.assert_allclose(c.q_init.numpy(), np.asarray(JSolo12.q_init), atol=0)
    np.testing.assert_allclose(c.nominal_feet.numpy(), np.asarray(JSolo12.nominal_feet), atol=0)
    assert Solo12.mass == JSolo12.mass and Solo12.stand_height == JSolo12.stand_height


@pytest.mark.parametrize("batched", [False, True])
def test_fk_matches(batched):
    q = _joints(0) if batched else _joints(0)[3]
    np.testing.assert_allclose(Solo12.fk(torch.from_numpy(q)).numpy(),
                               np.asarray(JSolo12.fk(jnp.asarray(q))), atol=ATOL)


@pytest.mark.parametrize("leg", range(4))
def test_leg_fk_and_leg_ik_match(leg):
    q = _joints(1)[:, 3 * leg:3 * leg + 3]
    p = Solo12.leg_fk(torch.from_numpy(q), leg)
    np.testing.assert_allclose(p.numpy(), np.asarray(JSolo12.leg_fk(jnp.asarray(q), leg)), atol=ATOL)
    f = _feet(2)[:, leg]
    np.testing.assert_allclose(Solo12.leg_ik(torch.from_numpy(f), leg).numpy(),
                               np.asarray(JSolo12.leg_ik(jnp.asarray(f), leg)), atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_fk_world_matches(batched):
    q, (pos, eul) = _joints(3), _pose(4)
    if not batched:
        q, pos, eul = q[5], pos[5], eul[5]
    out = Solo12.fk_world(*(torch.from_numpy(a) for a in (q, pos, eul)))
    ref = JSolo12.fk_world(*(jnp.asarray(a) for a in (q, pos, eul)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("spread", [0.08, 0.5], ids=["reachable", "unreachable"])
def test_ik_matches(batched, spread):
    f = _feet(5, spread=spread) if batched else _feet(5, spread=spread)[2]
    out = Solo12.ik(torch.from_numpy(f))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(JSolo12.ik(jnp.asarray(f))), atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_ik_world_matches(batched):
    (pos, eul) = _pose(6)
    pos[:, 2] = 0.24
    pos[:, :2] *= 0.05
    eul *= 0.2
    f = _feet(7) + np.array([0.0, 0.0, 0.24], np.float32)
    if not batched:
        f, pos, eul = f[1], pos[1], eul[1]
    out = Solo12.ik_world(*(torch.from_numpy(a) for a in (f, pos, eul)))
    ref = JSolo12.ik_world(*(jnp.asarray(a) for a in (f, pos, eul)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_ik_inverts_fk_on_the_knee_sign_branch():
    """Front knees flex negative, hind knees positive: joints drawn on that
    branch come back from ik(fk(q))."""
    rng = np.random.default_rng(8)
    q = rng.uniform(-0.5, 0.5, size=(B, 4, 3)).astype(np.float32)
    knee = np.array([-1.0, -1.0, 1.0, 1.0], np.float32)
    q[..., 2] = knee * rng.uniform(0.3, 1.5, size=(B, 4)).astype(np.float32)
    q = torch.from_numpy(q.reshape(B, 12))
    np.testing.assert_allclose(Solo12.ik(Solo12.fk(q)).numpy(), q.numpy(), atol=1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_jacobians_match_autodiff(batched):
    q = _joints(9)
    ref = jax.vmap(JSolo12.jacobians)(jnp.asarray(q))          # jax.jacfwd of leg_fk
    if batched:
        out = Solo12.jacobians(torch.from_numpy(q))
    else:
        out, ref = Solo12.jacobians(torch.from_numpy(q[4])), ref[4]
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("leg", range(4))
def test_leg_jacobian_matches_autodiff(leg):
    q = _joints(10)[:, 3 * leg:3 * leg + 3]
    ref = jax.vmap(lambda qq: JSolo12.leg_jacobian(qq, leg))(jnp.asarray(q))
    np.testing.assert_allclose(Solo12.leg_jacobian(torch.from_numpy(q), leg).numpy(),
                               np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_ik_dls_matches(batched):
    f = _feet(11, spread=0.04)
    q0 = np.tile(np.asarray(JSolo12.q_init, np.float32), (B, 1))
    ref = jax.vmap(JSolo12.ik_dls)(jnp.asarray(f), jnp.asarray(q0))
    if batched:
        out = Solo12.ik_dls(torch.from_numpy(f), torch.from_numpy(q0))
    else:
        out, ref = Solo12.ik_dls(torch.from_numpy(f[0]), torch.from_numpy(q0[0])), ref[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(Solo12.fk(out).numpy(), f if batched else f[0], atol=1e-3)
