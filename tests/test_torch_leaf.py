"""qtos_torch leaf math against qtos_tpu on identical numpy inputs (CPU).

Tolerance atol=1e-6: the same float32 formulas evaluated by two frameworks;
only the rounding of transcendental functions and of sum order differs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qtos_tpu.ops.batch_linalg as jbl
import qtos_tpu.ops.rotations as jrot
import qtos_tpu.ops.splines as jspl
import qtos_tpu.terrain.heightfield as jhf
import qtos_tpu.terrain.tiles as jtiles
from qtos_tpu.models.solo12 import Solo12 as JSolo12

import qtos_torch.ops.batch_linalg as tbl
import qtos_torch.ops.rotations as trot
import qtos_torch.ops.splines as tspl
import qtos_torch.terrain.heightfield as thf
import qtos_torch.terrain.tiles as ttiles
from qtos_torch.models.solo12 import Solo12 as TSolo12

ATOL = 1e-6
REPO = os.path.join(os.path.dirname(__file__), "..")


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _both(fn_name, *args):
    j = getattr(jrot, fn_name)(*[jnp.asarray(a) for a in args])
    t = getattr(trot, fn_name)(*[torch.tensor(np.array(a)) for a in args])
    return np.asarray(j), t.numpy()


_EUL = _rand((5, 7, 3), 0, 0.6)
_W = _rand((5, 7, 3), 1)
_Q = _rand((5, 7, 4), 2)
_Q = _Q / np.linalg.norm(_Q, axis=-1, keepdims=True)

ROT_CASES = {
    "rx": (_EUL[..., 0],),
    "ry": (_EUL[..., 1],),
    "rz": (_EUL[..., 2],),
    "euler_to_rot": (_EUL,),
    "euler_rate_matrix": (_EUL,),
    "euler_rate_matrix_inv": (_EUL,),
    "omega_to_euler_rate": (_EUL, _W),
    "euler_rate_to_omega": (_EUL, _W),
    "skew": (_W,),
    "quat_mul": (_Q, _Q[::-1].copy()),
    "quat_to_rot": (_Q,),
    "euler_to_quat": (_EUL,),
    "quat_to_euler": (_Q,),
}


@pytest.mark.parametrize("fn_name", sorted(ROT_CASES))
def test_rotations_match(fn_name):
    j, t = _both(fn_name, *ROT_CASES[fn_name])
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_rot_to_euler_and_quat_integrate_match():
    R = np.asarray(jrot.euler_to_rot(jnp.asarray(_EUL)))
    j, t = _both("rot_to_euler", R)
    np.testing.assert_allclose(t, j, atol=ATOL)
    jq = jrot.quat_integrate(jnp.asarray(_Q), jnp.asarray(_W), 0.01)
    tq = trot.quat_integrate(torch.from_numpy(_Q), torch.from_numpy(_W), 0.01)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)


def _spd(seed, n=7):
    A = _rand((3, n, n), seed)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("fn_name", ["cholesky_unrolled", "solve_lower", "solve_upper_t",
                                     "spd_solve", "spd_solve_vec"])
def test_batch_linalg_matches(fn_name):
    """Column-loop factor/solves (atol 1e-5: SPD blocks with entries ~10)."""
    A = _spd(8)
    Lc = np.array(jbl.cholesky_unrolled(jnp.asarray(A)))
    rhs = {"cholesky_unrolled": (A,), "solve_lower": (Lc, _rand((3, 7, 2), 9)),
           "solve_upper_t": (Lc, _rand((3, 7, 2), 9)), "spd_solve": (A, _rand((3, 7, 2), 9)),
           "spd_solve_vec": (A, _rand((3, 7), 9))}[fn_name]
    j = getattr(jbl, fn_name)(*[jnp.asarray(a) for a in rhs])
    t = getattr(tbl, fn_name)(*[torch.tensor(a) for a in rhs])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_hermite_sampling_matches():
    """Hermite position/velocity/acceleration (atol 1e-4, rtol 1e-5: the
    acceleration carries a 1/dt^2 = 100 factor on O(1) float32 terms)."""
    kx, kv = _rand((9, 4), 10), _rand((9, 4), 11)
    times = np.linspace(0.0, 8 * 0.1, 57).astype(np.float32)
    j = jspl.sample_knots(jnp.asarray(kx), jnp.asarray(kv), 0.1, jnp.asarray(times))
    t = tspl.sample_knots(torch.tensor(kx), torch.tensor(kv), 0.1, torch.tensor(times))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-5)


def test_solo12_constants_match():
    c = TSolo12.tensors("cpu")
    assert TSolo12.mass == JSolo12.mass
    assert TSolo12.stand_height == JSolo12.stand_height
    np.testing.assert_array_equal(c.inertia.numpy(), np.asarray(JSolo12.inertia))
    np.testing.assert_allclose(c.inertia_inv.numpy(), np.asarray(JSolo12.inertia_inv), rtol=1e-7)
    np.testing.assert_array_equal(c.nominal_feet.numpy(), np.asarray(JSolo12.nominal_feet))


def test_tiles_module_is_a_copy():
    with open(os.path.join(REPO, "qtos_tpu", "terrain", "tiles.py"), "rb") as a, \
            open(os.path.join(REPO, "qtos_torch", "terrain", "tiles.py"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(set(jtiles.REFERENCE_TILE_FILES) | set(jtiles.TILE_GENERATORS)))
def test_tiles_byte_equal(name):
    t = ttiles.tile(name)
    assert t.dtype == np.float32
    assert t.tobytes() == jtiles.tile(name).tobytes()
    fname = ttiles.REFERENCE_TILE_FILES.get(name)
    if fname is not None:
        path = os.path.join(REPO, "data", "heightfields", fname)
        assert t.tobytes() == jtiles.load_tile_txt(path).tobytes()
    if name in ttiles.TILE_GENERATORS:
        assert ttiles.TILE_GENERATORS[name]().tobytes() == jtiles.TILE_GENERATORS[name]().tobytes()


def _terrains():
    names = ["step", "random_terrain", "stairs"]
    return jhf.make_terrain(names), thf.make_terrain(names, device="cpu")


def _points():
    rng = np.random.default_rng(3)
    inside = np.stack([rng.uniform(-1.0, 5.0, 64), rng.uniform(-1.0, 1.0, 64)], -1)
    outside = np.stack([rng.uniform(-4.0, 9.0, 64), rng.uniform(-3.0, 3.0, 64)], -1)
    return np.concatenate([inside, outside]).astype(np.float32)


@pytest.mark.parametrize("query", ["height_at", "grad_at", "slope_grad_at", "slope_at"])
def test_heightfield_queries_match(query):
    jt, tt = _terrains()
    pts = _points()
    extra = (0.06,) if query.startswith("slope") else ()
    j = getattr(jhf, query)(jt, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), *extra)
    t = getattr(thf, query)(tt, torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]), *extra)
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    for a, b in zip(j, t):
        assert np.isfinite(b.numpy()).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def test_make_terrain_matches():
    jt, tt = _terrains()
    np.testing.assert_array_equal(tt.height.numpy(), np.asarray(jt.height))
    assert tt.resolution == jt.resolution and tt.origin == jt.origin
    assert tt.extent == jt.extent
