"""Interactive PyBullet GUI helpers (port of `qtos_tpu.sim.pybullet_ui`).

Parity with the reference's debug UI layer (reference:
QTOS/pybulletInterface.py — ``RecordInterface`` :6 follow-camera for
recordings, ``PybulletInterface`` :38 debug sliders + keyboard camera).
These only matter when a GUI PyBullet client is attached; everything is
gated on `pybullet_available()` from `qtos_torch.sim.pybullet_adapter`.

The classes take the pybullet module / client handle explicitly instead of
relying on an ambient global connection, and keyboard polling is a pure
function of the event dict so it is unit testable without a display.  This
module is host data and numpy: nothing here runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# pybullet key codes used by the reference's camera bindings
_KEY_D, _KEY_A, _KEY_Q, _KEY_E, _KEY_Z, _KEY_X, _KEY_ESC = 100, 97, 113, 101, 122, 120, 27


@dataclass
class CameraState:
    """Orbit-camera state advanced by keyboard events (pure host data)."""

    yaw: float = 45.0
    pitch: float = -30.0
    distance: float = 1.25
    target: tuple = (0.0, 0.0, 0.25)

    def apply_keys(self, keys: dict) -> bool:
        """Advance the camera from a pybullet getKeyboardEvents() dict.

        Key bindings match the reference (QTOS/pybulletInterface.py:81-96):
        A/D orbit yaw, Q/E pitch, Z/X dolly.  Returns True if ESC was
        pressed (caller should disconnect).
        """
        if keys.get(_KEY_D):
            self.yaw += 1.0
        if keys.get(_KEY_A):
            self.yaw -= 1.0
        if keys.get(_KEY_Q):
            self.pitch -= 1.0
        if keys.get(_KEY_E):
            self.pitch += 1.0
        if keys.get(_KEY_Z):
            self.distance = max(0.05, self.distance - 0.01)
        if keys.get(_KEY_X):
            self.distance += 0.01
        return bool(keys.get(_KEY_ESC))


class RecordInterface:
    """Follow-camera for video recording: re-centers the debug camera on the
    robot base each tick (reference: QTOS/pybulletInterface.py:6-36)."""

    def __init__(self, p, robot_id: int, camera: CameraState | None = None):
        self.p = p
        self.robot_id = robot_id
        self.camera = camera or CameraState()

    def update(self) -> None:
        pos, _ = self.p.getBasePositionAndOrientation(self.robot_id)
        self.p.resetDebugVisualizerCamera(
            cameraDistance=self.camera.distance,
            cameraYaw=self.camera.yaw,
            cameraPitch=self.camera.pitch,
            cameraTargetPosition=pos,
        )


@dataclass
class DebugCommand:
    """Slider read-back bundle (reference robostates() return contract)."""

    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orn: np.ndarray = field(default_factory=lambda: np.zeros(3))
    velocity: float = 0.0
    angle_velocity: float = 0.0
    angle: float = 0.0
    step_period: float = 2.0


class PybulletInterface:
    """Debug sliders (base pose nudges, velocity, gait period) + keyboard
    camera (reference: QTOS/pybulletInterface.py:38-110)."""

    def __init__(self, p, camera: CameraState | None = None):
        self.p = p
        self.camera = camera or CameraState()
        add = p.addUserDebugParameter
        self._ids = dict(
            x=add("x", -0.1, 0.1, 0.0),
            y=add("y", -0.1, 0.1, 0.0),
            z=add("z", -0.1, 0.1, 0.0),
            roll=add("roll", -np.pi / 4, np.pi / 4, 0.0),
            pitch=add("pitch", -np.pi / 4, np.pi / 4, 0.0),
            yaw=add("yaw", -np.pi / 4, np.pi / 4, 0.0),
            velocity=add("velocity", -3.0, 3.0, 0.0),
            anglevelocity=add("anglevelocity", -1.5, 1.5, 0.0),
            angle=add("angle", -90.0, 90.0, 0.0),
            period=add("stepPeriod", 0.1, 3.0, 2.0),
        )

    def robostates(self, body_id: int) -> DebugCommand:
        """Poll camera keys + sliders; follow `body_id` with the camera."""
        p = self.p
        pos, _ = p.getBasePositionAndOrientation(body_id)
        self.camera.target = tuple(pos)
        if self.camera.apply_keys(p.getKeyboardEvents()):
            p.disconnect()
            raise SystemExit(0)
        p.resetDebugVisualizerCamera(
            cameraDistance=self.camera.distance,
            cameraYaw=self.camera.yaw,
            cameraPitch=self.camera.pitch,
            cameraTargetPosition=pos,
        )
        try:
            read = p.readUserDebugParameter
            return DebugCommand(
                pos=np.array([read(self._ids["x"]), read(self._ids["y"]), read(self._ids["z"])]),
                orn=np.array(
                    [read(self._ids["roll"]), read(self._ids["pitch"]), read(self._ids["yaw"])]
                ),
                velocity=float(read(self._ids["velocity"])),
                angle_velocity=float(read(self._ids["anglevelocity"])),
                angle=float(read(self._ids["angle"])),
                step_period=float(read(self._ids["period"])),
            )
        except Exception:
            # slider read can race a disconnect; fall back to neutral command
            # (reference behavior at QTOS/pybulletInterface.py:103-110)
            return DebugCommand()
