"""Batched gait trajectory optimization: specs, residuals, batch-major
Gauss-Newton assembly, the LM solver loop and the 1 kHz sampler."""

from qtos_torch.solver.gait import GaitSchedule, stand_schedule, trot_schedule  # noqa: F401
from qtos_torch.solver.sampler import TRAJ_COLS, sample_trajectory  # noqa: F401
from qtos_torch.solver.solve import SolveResult, solve, solve_batch  # noqa: F401
from qtos_torch.solver.spec import ProblemSpec, RobotState, SolverConfig, default_spec  # noqa: F401
