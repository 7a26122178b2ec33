"""qtos_torch on stepped terrain against qtos_tpu on identical inputs (CPU).

The terrain is exp_2's (`step`, `step_1`, `step_2`, `plane` at mesh scale 2,
5 cm cells).  The query points sit on and within 1 mm of every riser of the
three step tiles: the two cell centres on either side of a height jump
(where `floor` changes the cell and the bilinear surface has its kink), the
cell boundary between them, each of those one float32 ulp to either side,
and 0.1, 0.5 and 1 mm off.  Contact and physics inputs put feet at those
points just inside and just outside contact and give the anchors offsets
that stick and that slide.

Tolerances.  One evaluation: atol=1e-5, as `tests/test_torch_sim.py`
(float32; forces up to 200 N reach the state through dt = 1e-3).  One tick
of the control loop: 1e-5, except `tau` (1e-3) and `qd` (1e-4), the
exception of `tests/test_torch_playback.py::test_tick_matches` (the desired
joint velocity is a difference of two IK results over dt).  One `sim_step`
holds `qd` and `w` at 1e-4: on a riser's ramp (slope up to 2.6 at the
0.13 m step) the foot's forward kinematics, which rounds differently in the
two frameworks (6e-8 m), moves the terrain height under a foot just in
contact by 1.5e-7 m, and the 5000 N/m contact spring turns that into ~1e-3
N: 2.6e-5 rad/s of joint velocity and 1.6e-5 rad/s of base rate after one
step.  With identical foot positions the contact forces agree exactly
(`test_contact_forces_at_riser_edges`).  300 ticks over
the riser: 2e-3 on positions, that file's short-playback tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.control import ControlParams as JControlParams
from qtos_tpu.control import playback as j_playback
from qtos_tpu.control.loop import _tick as j_tick
from qtos_tpu.control.loop import gait_control_params as j_gait_control_params
from qtos_tpu.control.loop import plan_joint_targets as j_plan_joint_targets
from qtos_tpu.models.solo12 import Solo12 as JSolo12
from qtos_tpu.sim import SimParams as JSimParams
from qtos_tpu.sim import SimState as JSimState
from qtos_tpu.sim import init_state as j_init_state
from qtos_tpu.sim import sim_step as j_sim_step
from qtos_tpu.sim.engine import contact_forces as j_contact_forces
from qtos_tpu.terrain import make_terrain as j_make_terrain
from qtos_tpu.terrain.heightfield import grad_at as j_grad_at
from qtos_tpu.terrain.heightfield import height_at as j_height_at

from qtos_torch.control import playback
from qtos_torch.control.loop import _tick, gait_control_params
from qtos_torch.convert import control_params_from_reference, sim_state_from_reference, terrain_from_reference
from qtos_torch.sim import SimParams, sim_step
from qtos_torch.sim.engine import contact_forces
from qtos_torch.terrain.heightfield import _corners, grad_at, height_at
from qtos_torch.tools import riser

ATOL = 1e-5
ATOL_TAU = 1e-3
ATOL_QD = 1e-4
ATOL_SHORT = 2e-3
MAPS = ["step", "step_1", "step_2", "plane"]
J_TERR = j_make_terrain(MAPS, scale_factor=2)
TERR = terrain_from_reference(jax.tree_util.tree_map(np.asarray, J_TERR), device="cpu")
STATE_FIELDS = ("pos", "quat", "v", "w", "q", "qd", "anchor")
TILES = {"step": 0, "step_1": 1, "step_2": 2}     # tile index along +x
OFFSETS_M = (1e-4, 5e-4, 1e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _near(v):
    """float32 coordinate v, one ulp either side, and 0.1-1 mm either side."""
    v = np.float32(v)
    out = [v, np.nextafter(v, np.float32(np.inf)), np.nextafter(v, np.float32(-np.inf))]
    for d in OFFSETS_M:
        out += [np.float32(v + d), np.float32(v - d)]
    return out


def _edge_points(tile: str, seed: int = 0):
    """(N, 2) float32 world xy on and within 1 mm of every riser of `tile`."""
    g = np.asarray(J_TERR.height)
    res, (x0, y0) = J_TERR.resolution, J_TERR.origin
    W_tile = g.shape[1] // len(MAPS)
    lo, hi = TILES[tile] * W_tile, (TILES[tile] + 1) * W_tile
    rng = np.random.default_rng(seed)
    pts = []
    # x-jumps: between columns c and c+1 (the last one is the tile's seam)
    for r, c in zip(*np.nonzero(np.diff(g, axis=1) != 0)):
        if lo - 1 <= c < hi:
            for x in (v for b in (c + 0.5, c + 1.0, c + 1.5) for v in _near(x0 + b * res)):
                pts.append((x, y0 + (r + rng.uniform()) * res))
    # y-jumps: between rows r and r+1
    for r, c in zip(*np.nonzero(np.diff(g, axis=0) != 0)):
        if lo <= c < hi:
            for y in (v for b in (r + 0.5, r + 1.0, r + 1.5) for v in _near(y0 + b * res)):
                pts.append((x0 + (c + rng.uniform()) * res, y))
    return np.asarray(pts, np.float32)


@pytest.mark.parametrize("tile", list(TILES))
def test_height_and_grad_at_riser_edges(tile):
    P = _edge_points(tile)
    assert len(P) > 500
    x, y = torch.from_numpy(P[:, 0]), torch.from_numpy(P[:, 1])
    jx, jy = jnp.asarray(P[:, 0]), jnp.asarray(P[:, 1])
    np.testing.assert_allclose(height_at(TERR, x, y).numpy(), np.asarray(j_height_at(J_TERR, jx, jy)),
                               atol=ATOL, rtol=0)
    for a, b, name in zip(grad_at(TERR, x, y), j_grad_at(J_TERR, jx, jy), ("dh/dx", "dh/dy")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("tile", list(TILES))
def test_cell_choice_at_cell_centres(tile):
    """Where (x - x0)/res - 0.5 is an integer to the ulp, `floor` picks the
    cell, and the gradient jumps between the flat cell and the riser's
    ramp: the port must pick the cell the reference picks."""
    P = _edge_points(tile)
    x, y = torch.from_numpy(P[:, 0]), torch.from_numpy(P[:, 1])
    cx = (x - TERR.origin[0]) / TERR.resolution - 0.5
    cy = (y - TERR.origin[1]) / TERR.resolution - 0.5
    on_centre = (cx == torch.round(cx)) | (cy == torch.round(cy))
    assert int(on_centre.sum()) > 0                     # the set holds exact cell centres
    jcx = (jnp.asarray(P[:, 0]) - J_TERR.origin[0]) / J_TERR.resolution - 0.5
    jcy = (jnp.asarray(P[:, 1]) - J_TERR.origin[1]) / J_TERR.resolution - 0.5
    np.testing.assert_array_equal(torch.floor(cx).numpy(), np.floor(np.asarray(jcx)))
    np.testing.assert_array_equal(torch.floor(cy).numpy(), np.floor(np.asarray(jcy)))
    *_, fx, fy = _corners(TERR, x, y)
    assert bool((fx[cx == torch.round(cx)] == 0).all()) and bool((fy[cy == torch.round(cy)] == 0).all())


def _feet_at_edges(tile, seed):
    """Feet (B, 4, 3) on riser-edge xy, each just inside or outside contact,
    with velocities and anchors that stick or slide."""
    rng = np.random.default_rng(seed)
    P = _edge_points(tile, seed)
    idx = rng.choice(len(P), size=(48, 4))
    xy = P[idx]
    h = np.asarray(j_height_at(J_TERR, jnp.asarray(xy[..., 0]), jnp.asarray(xy[..., 1])))
    dz = rng.choice(np.array([-1e-3, -1e-4, -1e-6, 0.0, 1e-6, 1e-4, 1e-3], np.float32), size=(48, 4))
    feet_w = np.concatenate([xy, (h - dz)[..., None]], -1).astype(np.float32)     # pen = dz
    feet_vw = rng.uniform(-0.3, 0.3, size=(48, 4, 3)).astype(np.float32)
    slide = rng.uniform(size=(48, 4, 1)) < 0.5
    off = np.where(slide, rng.uniform(-0.05, 0.05, (48, 4, 2)), rng.uniform(-1e-4, 1e-4, (48, 4, 2)))
    return feet_w, feet_vw, (xy + off).astype(np.float32)


@pytest.mark.parametrize("tile", list(TILES))
def test_contact_forces_at_riser_edges(tile):
    feet_w, feet_vw, anchor = _feet_at_edges(tile, seed=TILES[tile])
    f, a = contact_forces(SimParams(), TERR, *(torch.from_numpy(v) for v in (feet_w, feet_vw, anchor)))
    jf, ja = jax.vmap(lambda p, v, an: j_contact_forces(JSimParams(), J_TERR, p, v, an))(
        *(jnp.asarray(v) for v in (feet_w, feet_vw, anchor)))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=ATOL, rtol=0, err_msg="forces")
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL, rtol=0, err_msg="anchors")
    # the inputs reach every branch: out of contact, sticking, sliding
    fz = f[..., 2].numpy()
    assert (fz == 0).any() and (fz > 0).any()
    moved = np.abs(a.numpy() - anchor).max(-1) > 0
    assert (moved & (fz > 0)).any() and (~moved & (fz > 0)).any()


def _states_on_edges(tile, seed, B=32):
    """States whose foot `i` (cycling over the batch) stands on a riser-edge
    point, just inside or outside contact, the base moving."""
    rng = np.random.default_rng(seed)
    P = _edge_points(tile, seed)
    q_stand = np.asarray(JSolo12.ik(JSolo12.nominal_feet), np.float32)
    q = q_stand + rng.uniform(-0.1, 0.1, size=(B, 12)).astype(np.float32)
    eul = rng.uniform(-0.05, 0.05, size=(B, 3)).astype(np.float32)
    feet0 = np.asarray(jax.vmap(lambda qq, e: JSolo12.fk_world(qq, jnp.zeros(3), e))(jnp.asarray(q),
                                                                                     jnp.asarray(eul)))
    foot = np.arange(B) % 4
    target = P[rng.choice(len(P), size=B)]
    h = np.asarray(j_height_at(J_TERR, jnp.asarray(target[:, 0]), jnp.asarray(target[:, 1])))
    # 1 um either side of contact: wider than what the two frameworks' forward
    # kinematics put between their foot heights on a ramp (~1.6e-7 m).  At
    # pen = 0 itself rounding picks the contact flag, and the anchor jumps
    # between its stuck value and the foot (by up to the 1 cm offsets below);
    # the contact test holds pen = 0 on identical foot positions.
    dz = rng.choice(np.array([-5e-4, -1e-6, 1e-6, 5e-4], np.float32), size=B)
    lever = feet0[np.arange(B), foot]
    pos = np.concatenate([target - lever[:, :2], (h - dz - lever[:, 2])[:, None]], -1).astype(np.float32)
    s = jax.vmap(j_init_state)(jnp.asarray(pos), jnp.asarray(eul), jnp.asarray(q))
    leaves = {k: np.array(getattr(s, k)) for k in STATE_FIELDS}
    leaves["v"] = rng.uniform(-0.3, 0.3, size=(B, 3)).astype(np.float32)
    leaves["w"] = rng.uniform(-0.5, 0.5, size=(B, 3)).astype(np.float32)
    leaves["qd"] = rng.uniform(-2.0, 2.0, size=(B, 12)).astype(np.float32)
    leaves["anchor"] = leaves["anchor"] + rng.uniform(-0.01, 0.01, size=(B, 4, 2)).astype(np.float32)
    return leaves


@pytest.mark.parametrize("tile", list(TILES))
def test_sim_step_at_riser_edges(tile):
    leaves = _states_on_edges(tile, seed=10 + TILES[tile])
    tau = np.random.default_rng(3).uniform(-3, 3, size=(len(leaves["pos"]), 12)).astype(np.float32)
    j_state = JSimState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    ref = jax.vmap(lambda s, t: j_sim_step(s, t, J_TERR, JSimParams()))(j_state, jnp.asarray(tau))
    out = sim_step(sim_state_from_reference(_np_tree(j_state), "cpu"), torch.from_numpy(tau), TERR, SimParams())
    for k in STATE_FIELDS:
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=ATOL_QD if k in ("qd", "w") else ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def window():
    """The exp_2 window over the first riser (`qtos_torch.tools.riser`), solved
    by the port on the CPU; the rows around the first planned foot crossing
    of the riser, and the port's state at the first of them."""
    terr, table, status, s0 = riser.riser_window("cpu")
    assert status == 0
    feet_x = table[:, 7:19].reshape(-1, 4, 3)[..., 0]
    t_cross = int(torch.nonzero((feet_x > riser.RISER_X).any(dim=1))[0])
    t0 = max(t_cross - 100, 0)
    params = gait_control_params("trot")
    state_t0, _ = playback(table[:t0], s0, terr, params) if t0 else (s0, None)
    return dict(terr=terr, table=table, t0=t0, state=state_t0)


def test_window_crosses_the_first_riser(window):
    assert torch.equal(window["terr"].height, TERR.height)
    rows = window["table"][window["t0"]:window["t0"] + 300]
    feet_x = rows[:, 7:19].reshape(-1, 4, 3)[..., 0]
    assert bool((feet_x[0] < riser.RISER_X).all()) and bool((feet_x[-1] > riser.RISER_X).any())


def test_tick_over_the_riser_matches(window):
    """One tick at the crossing (row t0 + 100) from the port's state there."""
    jparams = j_gait_control_params("trot")
    params = control_params_from_reference(jparams)
    table, t = window["table"], window["t0"] + 100
    state, _ = playback(table[window["t0"]:t], window["state"], window["terr"], params)
    jtable = jnp.asarray(table.numpy())
    q_prev = np.asarray(j_plan_joint_targets(jtable[t - 1], jparams)[0])
    filters = (np.zeros((4, 3), np.float32), np.zeros(3, np.float32), np.zeros((), np.float32))
    jstate = JSimState(**{k: jnp.asarray(getattr(state, k).numpy()) for k in STATE_FIELDS})
    jnew, jout = j_tick((jstate, jnp.asarray(q_prev), *(jnp.asarray(f) for f in filters)), jtable[t],
                        J_TERR, jparams)
    new, out = _tick((state, torch.from_numpy(q_prev.copy()), *(torch.from_numpy(f) for f in filters)),
                     table[t], TERR, params)
    for k in STATE_FIELDS:
        np.testing.assert_allclose(getattr(new[0], k).numpy(), np.asarray(getattr(jnew[0], k)),
                                   atol=ATOL_QD if k == "qd" else ATOL, rtol=0, err_msg=f"state.{k}")
    for k in jout:
        atol = {"tau": ATOL_TAU, "qd": ATOL_QD}.get(k, ATOL)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=atol, rtol=0, err_msg=k)


def test_playback_over_the_first_riser_matches(window):
    """300 ticks from the port's state at t0, on the same rows, in both
    packages."""
    jparams = j_gait_control_params("trot")
    rows = window["table"][window["t0"]:window["t0"] + 300]
    state = window["state"]
    jstate = JSimState(**{k: jnp.asarray(getattr(state, k).numpy()) for k in STATE_FIELDS})
    jfinal, jm = j_playback(jnp.asarray(rows.numpy()), jstate, J_TERR, jparams)
    final, m = playback(rows, state, TERR, control_params_from_reference(jparams))
    np.testing.assert_allclose(m.pos.numpy(), np.asarray(jm.pos), atol=ATOL_SHORT, rtol=0, err_msg="pos")
    np.testing.assert_allclose(m.feet.numpy(), np.asarray(jm.feet), atol=ATOL_SHORT, rtol=0, err_msg="feet")
    for k in ("pos", "q", "anchor"):
        np.testing.assert_allclose(getattr(final, k).numpy(), np.asarray(getattr(jfinal, k)),
                                   atol=ATOL_SHORT, rtol=0, err_msg=k)


def test_divergence_of_one_device_against_itself_is_nil(window):
    rows = window["table"][window["t0"]:window["t0"] + 40]
    rep = riser.divergence(rows, window["state"], window["terr"], torch.device("cpu"))
    assert rep["first_tick"] is None and rep["first_leaf"] is None
    assert set(rep["leaves"]) == set(riser.LEAVES) and rep["final_dpos"] == 0.0 and rep["ticks"] == 40
