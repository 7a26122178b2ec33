"""Optional PyBullet cross-verifier (gated import; port of
`qtos_tpu.sim.pybullet_adapter`).

The reference's whole sim layer is PyBullet (QTOS/simulation.py); the port's
primary physics is the PyTorch engine in `qtos_torch.sim.engine`.  When a
pybullet wheel is present, this adapter loads the same SOLO12 URDF +
heightfield and replays a 37-col trajectory table through Bullet for
cross-engine validation of tracking metrics.  Bullet runs on the host; only
the joint targets are computed on the table's device.
"""

from __future__ import annotations

import numpy as np
import torch

from qtos_torch.control.loop import ControlParams, plan_joint_targets


def pybullet_available() -> bool:
    try:
        import pybullet  # noqa: F401

        return True
    except ImportError:
        return False


class BulletVerifier:
    """Replays a trajectory table in PyBullet (requires `pip install pybullet`
    and a SOLO12 URDF; gate with `pybullet_available()`)."""

    def __init__(self, terrain, urdf_path: str, gui: bool = False):
        if not pybullet_available():
            raise ImportError(
                "pybullet is not installed; use the PyTorch engine (qtos_torch.sim) "
                "or install pybullet for cross-verification"
            )
        import pybullet as p
        import pybullet_data

        self.p = p
        self.client = p.connect(p.GUI if gui else p.DIRECT)
        p.setAdditionalSearchPath(pybullet_data.getDataPath())
        p.setGravity(0, 0, -9.81)
        p.setTimeStep(1.0 / 1000.0)
        hz = terrain.height.detach().cpu().numpy()
        rows, cols = hz.shape
        shape = p.createCollisionShape(
            shapeType=p.GEOM_HEIGHTFIELD,
            meshScale=[terrain.resolution, terrain.resolution, 1.0],
            heightfieldData=hz.T.flatten(),
            numHeightfieldRows=cols,
            numHeightfieldColumns=rows,
        )
        self.ground = p.createMultiBody(0, shape)
        self.robot = p.loadURDF(urdf_path, [0, 0, 0.4])

    def replay(self, table, kp: float = 20.0, kd: float = 0.08):
        """Position-control replay of IK joint targets; returns CoM trace.

        `table` (T, 37) is a tensor on any device or an array; the targets of
        all rows are planned at once on its device.  `kd` is unused, as in
        the reference."""
        p = self.p
        joint_ids = [j for j in range(p.getNumJoints(self.robot))
                     if p.getJointInfo(self.robot, j)[2] == p.JOINT_REVOLUTE]
        com = []
        q_all, _ = plan_joint_targets(torch.as_tensor(table, dtype=torch.float32), ControlParams())
        for q_des in q_all.cpu().numpy():
            p.setJointMotorControlArray(
                self.robot, joint_ids, p.POSITION_CONTROL,
                targetPositions=q_des, positionGains=[kp * 1e-3] * 12,
            )
            p.stepSimulation()
            com.append(p.getBasePositionAndOrientation(self.robot)[0])
        return np.asarray(com)
