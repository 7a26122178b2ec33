"""qtos_torch.sim.pybullet_adapter and qtos_torch.sim.pybullet_ui against
qtos_tpu's on the CPU.

No pybullet wheel is needed: a recording stand-in for the `pybullet` and
`pybullet_data` modules goes into `sys.modules`.  It records every call with
its arguments, reports a fixed joint list (revolute and fixed joints mixed),
returns a base pose that advances with each `stepSimulation`, and serves
slider values by id.  Both packages' classes drive a fresh stand-in each on
identical inputs, and the two recordings are compared call by call.

Tolerances: every argument is equal exactly, except the joint targets
(`targetPositions`), which the two packages' IK compute in float32 and which
are held to TARGET_ATOL = 1e-5 rad, the tolerance at which
tests/test_torch_playback.py holds `plan_joint_targets`.
"""

import sys
import types

import numpy as np
import pytest
import torch

from qtos_tpu.sim import pybullet_adapter as j_adapter
from qtos_tpu.sim import pybullet_ui as j_ui
from qtos_tpu.terrain import make_terrain as j_make_terrain

from qtos_torch.sim import pybullet_adapter as adapter
from qtos_torch.sim import pybullet_ui as ui
from qtos_torch.terrain import make_terrain

TARGET_ATOL = 1e-5
ROWS = 200
# getJointInfo(...)[2] of the stand-in's robot: three revolute joints and a
# fixed foot joint per leg
JOINT_TYPES = [0, 0, 0, 4] * 4


class Bullet(types.ModuleType):
    """Recording stand-in for the pybullet module."""

    GUI, DIRECT = 1, 2
    GEOM_HEIGHTFIELD = 9
    JOINT_REVOLUTE, JOINT_FIXED = 0, 4
    POSITION_CONTROL = 2

    def __init__(self, keys=None, bad_slider=None):
        super().__init__("pybullet")
        self.calls = []
        self.steps = 0
        self.sliders = 0
        self.keys = keys or {}
        self.bad_slider = bad_slider

    def _rec(self, name, args, kwargs, ret=None):
        self.calls.append((name, args, kwargs))
        return ret

    def connect(self, *a, **k):
        return self._rec("connect", a, k, 7)

    def setAdditionalSearchPath(self, *a, **k):
        return self._rec("setAdditionalSearchPath", a, k)

    def setGravity(self, *a, **k):
        return self._rec("setGravity", a, k)

    def setTimeStep(self, *a, **k):
        return self._rec("setTimeStep", a, k)

    def createCollisionShape(self, *a, **k):
        return self._rec("createCollisionShape", a, k, 3)

    def createMultiBody(self, *a, **k):
        return self._rec("createMultiBody", a, k, 4)

    def loadURDF(self, *a, **k):
        return self._rec("loadURDF", a, k, 5)

    def getNumJoints(self, *a, **k):
        return self._rec("getNumJoints", a, k, len(JOINT_TYPES))

    def getJointInfo(self, body, j, *a, **k):
        return self._rec("getJointInfo", (body, j) + a, k, (j, f"joint_{j}".encode(), JOINT_TYPES[j]))

    def setJointMotorControlArray(self, *a, **k):
        return self._rec("setJointMotorControlArray", a, k)

    def stepSimulation(self, *a, **k):
        self.steps += 1
        return self._rec("stepSimulation", a, k)

    def getBasePositionAndOrientation(self, *a, **k):
        s = self.steps
        pose = ((1e-3 * s, 0.01 * np.sin(0.1 * s), 0.24 + 1e-4 * s), (0.0, 0.0, np.sin(1e-3 * s), 1.0))
        return self._rec("getBasePositionAndOrientation", a, k, pose)

    def resetDebugVisualizerCamera(self, *a, **k):
        return self._rec("resetDebugVisualizerCamera", a, k)

    def getKeyboardEvents(self, *a, **k):
        return self._rec("getKeyboardEvents", a, k, dict(self.keys))

    def disconnect(self, *a, **k):
        return self._rec("disconnect", a, k)

    def addUserDebugParameter(self, *a, **k):
        self.sliders += 1
        return self._rec("addUserDebugParameter", a, k, 100 + self.sliders)

    def readUserDebugParameter(self, i, *a, **k):
        self._rec("readUserDebugParameter", (i,) + a, k)
        if i == self.bad_slider:
            raise RuntimeError("not connected to physics server")
        return 0.01 * i - 1.0


def _stand_in(monkeypatch, **kw):
    p = Bullet(**kw)
    data = types.ModuleType("pybullet_data")
    data.getDataPath = lambda: p._rec("getDataPath", (), {}, "/bullet/data")
    monkeypatch.setitem(sys.modules, "pybullet", p)
    monkeypatch.setitem(sys.modules, "pybullet_data", data)
    return p


def _assert_same_calls(ours, ref):
    assert [c[0] for c in ours] == [c[0] for c in ref]
    for (name, args, kwargs), (_, jargs, jkwargs) in zip(ours, ref):
        assert len(args) == len(jargs) and set(kwargs) == set(jkwargs), name
        for a, b, key in [(a, b, i) for i, (a, b) in enumerate(zip(args, jargs))] + \
                [(kwargs[k], jkwargs[k], k) for k in kwargs]:
            if name == "setJointMotorControlArray" and key == "targetPositions":
                assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_allclose(a, b, atol=TARGET_ATOL, rtol=0)
            elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                assert np.asarray(a).dtype == np.asarray(b).dtype, (name, key)
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (name, key, a, b)


def _table(seed=0):
    """A 200-row 37-column trot-like table over the step tile: the base
    advances in x with some sway, two diagonal feet lift at a time."""
    rng = np.random.default_rng(seed)
    t = np.arange(ROWS) * 1e-3
    tab = np.zeros((ROWS, 37), np.float32)
    tab[:, 0] = t
    tab[:, 1] = 0.2 * t
    tab[:, 2] = 0.01 * np.sin(20 * t)
    tab[:, 3] = 0.24 + 0.005 * np.sin(30 * t)
    tab[:, 4:7] = 0.05 * np.sin(np.outer(t, [11.0, 13.0, 7.0])) + 0.01 * rng.standard_normal(3)
    nominal = np.array([[0.21, 0.19], [0.21, -0.19], [-0.21, 0.19], [-0.21, -0.19]])
    lift = np.clip(np.sin(np.pi * np.arange(ROWS) / 100.0), 0.0, None)
    for leg in range(4):
        phase = lift if leg in (0, 3) else lift[::-1]
        tab[:, 7 + 3 * leg] = nominal[leg, 0] + 0.2 * t + 0.01 * rng.standard_normal()
        tab[:, 8 + 3 * leg] = nominal[leg, 1] + 0.005 * rng.standard_normal()
        tab[:, 9 + 3 * leg] = 0.06 * phase
        tab[:, 27 + 3 * leg] = 7.0 * (1.0 - phase)
    tab[:, 19:25] = 0.1 * rng.standard_normal(6)
    return tab


@pytest.fixture(scope="module")
def terrains():
    names = ["plane", "step"]
    return j_make_terrain(names), make_terrain(names, device="cpu")


def test_bullet_verifier_matches(monkeypatch, terrains):
    jterr, terr = terrains
    table = _table()
    p_ref = _stand_in(monkeypatch)
    j_com = j_adapter.BulletVerifier(jterr, "solo12.urdf").replay(table)
    p = _stand_in(monkeypatch)
    verifier = adapter.BulletVerifier(terr, "solo12.urdf")
    com = verifier.replay(torch.as_tensor(table))

    _assert_same_calls(p.calls, p_ref.calls)
    shape = dict(next(c for c in p.calls if c[0] == "createCollisionShape")[2])
    jshape = dict(next(c for c in p_ref.calls if c[0] == "createCollisionShape")[2])
    np.testing.assert_array_equal(shape["heightfieldData"], jshape["heightfieldData"])
    assert shape["meshScale"] == jshape["meshScale"]
    assert (shape["numHeightfieldRows"], shape["numHeightfieldColumns"]) == \
        (jshape["numHeightfieldRows"], jshape["numHeightfieldColumns"])
    # the step tile is in the heightfield, rows and columns swapped
    H, W = terr.height.shape
    assert (shape["numHeightfieldRows"], shape["numHeightfieldColumns"]) == (W, H)
    assert np.ptp(shape["heightfieldData"]) > 0.1
    # one motor command per row to the 12 revolute joints, then one step
    motor = [c for c in p.calls if c[0] == "setJointMotorControlArray"]
    assert len(motor) == ROWS == p.steps
    assert motor[0][1][1] == [j for j, k in enumerate(JOINT_TYPES) if k == 0]
    assert motor[0][2]["positionGains"] == [20.0 * 1e-3] * 12
    np.testing.assert_array_equal(com, j_com)
    assert com.shape == (ROWS, 3)


def test_bullet_verifier_takes_arrays_and_gui(monkeypatch, terrains):
    """A host array replays like a tensor; `gui=True` connects to the GUI."""
    jterr, terr = terrains
    table = _table(1)[:20]
    p_ref = _stand_in(monkeypatch)
    j_adapter.BulletVerifier(jterr, "solo12.urdf", gui=True).replay(table, kp=50.0)
    p = _stand_in(monkeypatch)
    adapter.BulletVerifier(terr, "solo12.urdf", gui=True).replay(table, kp=50.0)
    _assert_same_calls(p.calls, p_ref.calls)
    assert p.calls[0] == ("connect", (Bullet.GUI,), {})


def test_pybullet_adapter_gated(monkeypatch):
    monkeypatch.setitem(sys.modules, "pybullet", None)       # `import pybullet` raises ImportError
    assert not adapter.pybullet_available()
    assert not j_adapter.pybullet_available()
    with pytest.raises(ImportError, match="qtos_torch.sim"):
        adapter.BulletVerifier(make_terrain(["plane"], device="cpu"), "does_not_matter.urdf")


def test_pybullet_available_with_the_module(monkeypatch):
    _stand_in(monkeypatch)
    assert adapter.pybullet_available() and j_adapter.pybullet_available()


# ---- the debug UI (port of tests/test_containers_ui.py's UI cases) ----------

def test_camera_state_keyboard_bindings():
    cam = ui.CameraState()
    # A/D yaw, Q/E pitch, Z/X dolly — reference QTOS/pybulletInterface.py:81-96
    assert not cam.apply_keys({100: 1})
    assert cam.yaw == 46.0
    cam.apply_keys({97: 1, 113: 1, 101: 1})
    assert cam.yaw == 45.0 and cam.pitch == -30.0
    cam.apply_keys({122: 1})
    assert cam.distance == pytest.approx(1.24)
    cam.apply_keys({120: 1})
    assert cam.distance == pytest.approx(1.25)
    assert cam.apply_keys({27: 1})  # ESC requests disconnect


@pytest.mark.parametrize("keys", [{}, {100: 1}, {97: 1, 113: 1}, {101: 1, 120: 1}, {122: 1, 27: 0}, {27: 1}])
def test_camera_state_matches(keys):
    cam, jcam = ui.CameraState(distance=0.06), j_ui.CameraState(distance=0.06)
    for _ in range(3):
        assert cam.apply_keys(keys) == jcam.apply_keys(keys)
    assert (cam.yaw, cam.pitch, cam.distance, cam.target) == (jcam.yaw, jcam.pitch, jcam.distance, jcam.target)


def test_debug_command_defaults():
    cmd, jcmd = ui.DebugCommand(), j_ui.DebugCommand()
    assert cmd.pos.shape == (3,) and cmd.step_period == 2.0
    for name in ("pos", "orn"):
        np.testing.assert_array_equal(getattr(cmd, name), getattr(jcmd, name))
    assert (cmd.velocity, cmd.angle_velocity, cmd.angle, cmd.step_period) == \
        (jcmd.velocity, jcmd.angle_velocity, jcmd.angle, jcmd.step_period)


def test_record_interface_matches(monkeypatch):
    p_ref, p = Bullet(), Bullet()
    for bullet, mod in ((p_ref, j_ui), (p, ui)):
        rec = mod.RecordInterface(bullet, 5, mod.CameraState(yaw=10.0))
        for _ in range(3):
            bullet.stepSimulation()
            rec.update()
    _assert_same_calls(p.calls, p_ref.calls)
    assert p.calls[-1][2]["cameraYaw"] == 10.0


def _robostates(mod, bullet, body=5):
    iface = mod.PybulletInterface(bullet)
    try:
        return iface.robostates(body), iface
    except SystemExit as e:
        return e, iface


@pytest.mark.parametrize("case", ["sliders", "keys", "esc", "bad_slider"])
def test_pybullet_interface_matches(case):
    kw = dict(sliders={}, keys=dict(keys={100: 1, 122: 1}), esc=dict(keys={27: 1}),
              bad_slider=dict(bad_slider=107))[case]
    p_ref, p = Bullet(**kw), Bullet(**kw)
    p_ref.steps = p.steps = 42
    jout, jiface = _robostates(j_ui, p_ref)
    out, iface = _robostates(ui, p)
    _assert_same_calls(p.calls, p_ref.calls)
    names = [c[0] for c in p.calls]
    assert [c[1] for c in p.calls if c[0] == "addUserDebugParameter"][-1] == ("stepPeriod", 0.1, 3.0, 2.0)
    assert iface.camera.target == jiface.camera.target == tuple(p.getBasePositionAndOrientation(5)[0])
    if case == "esc":
        assert isinstance(out, SystemExit) and out.code == jout.code == 0
        assert names[-1] == "disconnect" and "resetDebugVisualizerCamera" not in names
        return
    assert isinstance(out, ui.DebugCommand)
    if case == "bad_slider":
        # a failed read returns the neutral command
        assert not out.pos.any() and not out.orn.any() and out.step_period == 2.0
        assert out.velocity == out.angle_velocity == out.angle == 0.0
    for name in ("pos", "orn"):
        np.testing.assert_array_equal(getattr(out, name), getattr(jout, name))
    assert (out.velocity, out.angle_velocity, out.angle, out.step_period) == \
        (jout.velocity, jout.angle_velocity, jout.angle, jout.step_period)
    if case == "keys":
        assert iface.camera.yaw == 46.0 and iface.camera.distance == pytest.approx(1.24)
    if case == "sliders":
        assert out.step_period == pytest.approx(0.01 * 110 - 1.0)
