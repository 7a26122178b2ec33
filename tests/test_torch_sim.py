"""qtos_torch simulator and motor model against qtos_tpu on identical inputs
(CPU).

Tolerances: atol=1e-5 for one evaluation (float32, forces up to 200 N scaled
by dt = 1e-3 before they reach the state); atol=1e-3 on `pos`, `q` and
`anchor` after 200 ticks, where the stiff penalty contact (5000 N/m) amplifies
the rounding differences between the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtos_tpu.control import ControlParams as JControlParams
from qtos_tpu.control import stance_warmup as j_stance_warmup
from qtos_tpu.models.solo12 import Solo12 as JSolo12
from qtos_tpu.sim import MotorParams as JMotorParams
from qtos_tpu.sim import SimParams as JSimParams
from qtos_tpu.sim import SimState as JSimState
from qtos_tpu.sim import init_state as j_init_state
from qtos_tpu.sim import pd_torque as j_pd_torque
from qtos_tpu.sim import rollout as j_rollout
from qtos_tpu.sim import sim_step as j_sim_step
from qtos_tpu.sim.engine import contact_forces as j_contact_forces
from qtos_tpu.sim.engine import foot_kinematics as j_foot_kinematics
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.control import ControlParams, stance_warmup
from qtos_torch.convert import (
    control_params_from_reference,
    motor_params_from_reference,
    sim_params_from_reference,
    sim_state_from_reference,
    terrain_from_reference,
    to_numpy,
)
from qtos_torch.models.solo12 import Solo12
from qtos_torch.sim import MotorParams, SimParams, SimState, init_state, pd_torque, rollout, sim_step
from qtos_torch.sim.engine import contact_forces, foot_kinematics

ATOL = 1e-5
ATOL_200 = 1e-3
TILES = ["step", "plane"]
J_TERR = j_make_terrain(TILES)
TERR = terrain_from_reference(jax.tree_util.tree_map(np.asarray, J_TERR), device="cpu")
STATE_FIELDS = ("pos", "quat", "v", "w", "q", "qd", "anchor")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_states(seed, B=16):
    """Numpy state leaves near a standing pose: some feet in the ground, some
    above it, moving joints and base."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, shape: rng.uniform(lo, hi, size=shape).astype(np.float32)
    q_stand = np.asarray(JSolo12.ik(JSolo12.nominal_feet), np.float32)
    pos = np.concatenate([u(-0.3, 0.9, (B, 2)), u(0.215, 0.26, (B, 1))], -1)
    eul = u(-0.1, 0.1, (B, 3))
    q = q_stand + u(-0.15, 0.15, (B, 12))
    s = jax.vmap(j_init_state)(jnp.asarray(pos), jnp.asarray(eul), jnp.asarray(q))
    leaves = {k: np.array(getattr(s, k)) for k in STATE_FIELDS}
    leaves["v"] = u(-0.3, 0.3, (B, 3))
    leaves["w"] = u(-0.5, 0.5, (B, 3))
    leaves["qd"] = u(-2.0, 2.0, (B, 12))
    leaves["anchor"] = leaves["anchor"] + u(-0.01, 0.01, (B, 4, 2))
    return leaves


def _both(leaves):
    j = JSimState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return j, sim_state_from_reference(_np_tree(j), device="cpu")


def _assert_state(t_state: SimState, j_state, atol, fields=STATE_FIELDS):
    for k in fields:
        np.testing.assert_allclose(getattr(t_state, k).numpy(), np.asarray(getattr(j_state, k)),
                                   atol=atol, err_msg=k)


def test_params_carry_across():
    jp = JControlParams(motor=JMotorParams(kd=2.0, knee_scale=0.9), sim=JSimParams(joint_damping=0.5),
                        frame="live", use_force_ff=False, vel_corr=0.15)
    p = control_params_from_reference(jp)
    assert p == ControlParams(motor=MotorParams(kd=2.0, knee_scale=0.9), sim=SimParams(joint_damping=0.5),
                              frame="live", use_force_ff=False, vel_corr=0.15)
    assert motor_params_from_reference(JMotorParams()) == MotorParams()
    assert sim_params_from_reference(JSimParams()) == SimParams()
    assert control_params_from_reference(JControlParams()) == ControlParams()


@pytest.mark.parametrize("with_ff", [False, True])
def test_pd_torque_matches_and_clips(with_ff):
    rng = np.random.default_rng(0)
    jp = JMotorParams(hip_scale=1.0, knee_scale=0.8, ankle_scale=1.2)
    p = motor_params_from_reference(jp)
    args = [rng.uniform(-1, 1, size=(8, 12)).astype(np.float32) for _ in range(4)]
    ff = rng.uniform(-3, 3, size=(8, 12)).astype(np.float32) if with_ff else None
    out = pd_torque(p, *(torch.from_numpy(a) for a in args),
                    tau_ff=None if ff is None else torch.from_numpy(ff))
    ref = j_pd_torque(jp, *(jnp.asarray(a) for a in args), None if ff is None else jnp.asarray(ff))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert float(out.abs().max()) == p.t_max            # some joints saturate
    np.testing.assert_allclose(p.gain_vector("cpu").numpy(), np.asarray(jp.gain_vector()), atol=0)
    sat = pd_torque(MotorParams(), torch.full((12,), 10.0), torch.zeros(12), torch.zeros(12), torch.zeros(12))
    np.testing.assert_allclose(sat.numpy(), MotorParams().t_max)


def test_contact_forces_branches():
    """Foot 0 airborne, 1 sticking, 2 sliding (anchor far away), 3 barely in
    the ground and leaving it fast (normal force clipped at 0)."""
    feet_w = np.array([[0.2, 0.2, 0.05], [0.2, -0.2, -0.004], [-0.2, 0.2, -0.002], [-0.2, -0.2, -0.0005]],
                      np.float32)
    feet_vw = np.array([[0.1, 0.0, -0.2], [0.01, 0.0, -0.05], [0.3, 0.1, 0.0], [0.0, 0.0, 2.0]], np.float32)
    anchor = feet_w[:, :2] + np.array([[0.02, 0.0], [0.001, 0.0005], [0.05, -0.03], [0.0, 0.001]], np.float32)
    j_terr = j_make_terrain(["plane"])
    terr = terrain_from_reference(_np_tree(j_terr), device="cpu")
    for batch in (False, True):
        arrs = [np.stack([a, a[::-1]]) if batch else a for a in (feet_w, feet_vw, anchor)]
        f, new_anchor = contact_forces(SimParams(), terr, *(torch.from_numpy(a) for a in arrs))
        if batch:
            jf, ja = jax.vmap(lambda a, b, c: j_contact_forces(JSimParams(), j_terr, a, b, c))(
                *(jnp.asarray(a) for a in arrs))
        else:
            jf, ja = j_contact_forces(JSimParams(), j_terr, *(jnp.asarray(a) for a in arrs))
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=ATOL)
        np.testing.assert_allclose(new_anchor.numpy(), np.asarray(ja), atol=ATOL)
    f, new_anchor = f[0].numpy(), new_anchor[0].numpy()
    assert (f[0] == 0).all() and (new_anchor[0] == feet_w[0, :2]).all()          # airborne
    assert f[1, 2] > 0 and (new_anchor[1] == anchor[1]).all()                    # sticking
    assert np.hypot(*f[1, :2]) < f[1, 2]
    assert f[2, 2] > 0 and np.isclose(np.hypot(*f[2, :2]), f[2, 2], rtol=1e-5)   # on the cone
    assert not np.allclose(new_anchor[2], anchor[2]) and not np.allclose(new_anchor[2], feet_w[2, :2])
    # in contact with no normal force: the cone is a point, the anchor slides to the foot
    assert (f[3] == 0).all() and np.allclose(new_anchor[3], feet_w[3, :2], atol=1e-7)


def test_foot_kinematics_matches():
    j_state, t_state = _both(_random_states(1))
    ref = jax.vmap(j_foot_kinematics)(j_state)
    for a, b, name in zip(foot_kinematics(t_state), ref, ("feet_w", "feet_vw", "arm_w", "J", "R")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


def test_init_state_matches():
    leaves = _random_states(2)
    eul = np.random.default_rng(3).uniform(-0.2, 0.2, size=(16, 3)).astype(np.float32)
    ref = jax.vmap(j_init_state)(jnp.asarray(leaves["pos"]), jnp.asarray(eul), jnp.asarray(leaves["q"]))
    out = init_state(leaves["pos"], eul, leaves["q"], device="cpu")
    _assert_state(out, ref, ATOL)
    np.testing.assert_allclose(out.eul.numpy(), eul, atol=ATOL)
    one = init_state(leaves["pos"][0], eul[0], torch.from_numpy(leaves["q"][0]))
    _assert_state(one, jax.tree_util.tree_map(lambda a: a[0], ref), ATOL)


def test_sim_step_matches_from_random_states():
    leaves = _random_states(4)
    tau = np.random.default_rng(5).uniform(-5, 5, size=(16, 12)).astype(np.float32)
    j_state, t_state = _both(leaves)
    ref = jax.vmap(lambda s, t: j_sim_step(s, t, J_TERR, JSimParams()))(j_state, jnp.asarray(tau))
    out = sim_step(t_state, torch.from_numpy(tau), TERR, SimParams())
    _assert_state(out, ref, ATOL)
    # unbatched: the same step on one state
    one = sim_step(sim_state_from_reference(_np_tree(jax.tree_util.tree_map(lambda a: a[7], j_state)), "cpu"),
                   torch.from_numpy(tau[7]), TERR, SimParams())
    _assert_state(one, jax.tree_util.tree_map(lambda a: a[7], ref), ATOL)


def test_sim_step_base_sphere_touches():
    """A collapsed robot: the base 0.03 m over the ground, inside its 0.05 m
    collision sphere, falling; the sphere's spring pushes it back up."""
    leaves = _random_states(6, B=4)
    leaves["pos"][:, 2] = 0.03
    leaves["v"][:, 2] = -0.5
    leaves["pos"][:, 0] = np.abs(leaves["pos"][:, 0]) * 0.3 - 0.8     # on the flat part of the step tile
    j_state, t_state = _both(leaves)
    tau = jnp.zeros((4, 12))
    ref = jax.vmap(lambda s, t: j_sim_step(s, t, J_TERR, JSimParams()))(j_state, tau)
    out = sim_step(t_state, torch.zeros(4, 12), TERR, SimParams())
    _assert_state(out, ref, ATOL)
    assert (out.v[:, 2].numpy() > leaves["v"][:, 2] + 0.03).all()


def _standing(height=0.24, B=None):
    q = np.array(JSolo12.ik(JSolo12.nominal_feet), np.float32)
    pos = np.array([0.0, 0.0, height], np.float32)
    if B:
        pos = np.tile(pos, (B, 1)) + np.linspace(0, 0.004, B, dtype=np.float32)[:, None]
        q = np.tile(q, (B, 1))
    return pos, np.zeros_like(pos), q


def test_rollout_under_zero_torque_matches():
    pos, eul, q = _standing(B=3)
    j_state = jax.vmap(j_init_state)(jnp.asarray(pos), jnp.asarray(eul), jnp.asarray(q))
    tau = np.zeros((3, 200, 12), np.float32)
    j_final, j_trace = jax.vmap(lambda s, t: j_rollout(s, t, J_TERR, JSimParams(), 200))(j_state, jnp.asarray(tau))
    final, trace = rollout(init_state(pos, eul, q, device="cpu"), torch.from_numpy(tau), TERR, SimParams(), 200)
    assert tuple(trace.shape) == (3, 200, 3)
    np.testing.assert_allclose(trace.numpy(), np.asarray(j_trace), atol=ATOL_200)
    _assert_state(final, j_final, ATOL_200, fields=("pos", "q", "anchor"))


def test_stance_warmup_matches():
    pos, eul, q = _standing()
    j_final = j_stance_warmup(j_init_state(pos, eul, q), J_TERR, JControlParams(), 200)
    final = stance_warmup(init_state(pos, eul, q, device="cpu"), TERR, ControlParams(), 200)
    _assert_state(final, j_final, ATOL_200, fields=("pos", "q", "anchor"))
    back = to_numpy(final)
    assert isinstance(back, SimState) and isinstance(back.pos, np.ndarray)


def test_freefall_without_torque():
    q = Solo12.ik(Solo12.tensors("cpu").nominal_feet)
    s = init_state([0.0, 0.0, 1.0], [0.0, 0.0, 0.0], q)
    for _ in range(100):
        s = sim_step(s, torch.zeros(12), TERR, SimParams())
    # ~0.049 m fall in 0.1 s
    assert abs(float(s.pos[2]) - (1.0 - 0.5 * 9.81 * 0.01)) < 2e-3
    assert abs(float(s.v[2]) + 9.81 * 0.1) < 1e-2
