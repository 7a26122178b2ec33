"""Rigid-body simulator + motor model in PyTorch.

The whole 1 kHz loop (IK, PD motor, soft-contact dynamics, integration) runs
as tensor operations over any leading batch of episodes.
"""

from qtos_torch.sim.engine import SimParams, SimState, init_state, sim_step, rollout  # noqa: F401
from qtos_torch.sim.motor import MotorParams, pd_torque  # noqa: F401
