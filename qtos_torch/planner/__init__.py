"""Global planning: A* over traversability maps, spline paths, and the
solver-probed feasibility map."""

from qtos_torch.planner.astar import astar  # noqa: F401
from qtos_torch.planner.global_planner import GlobalPlanner  # noqa: F401
from qtos_torch.planner.feasibility import feasibility_map  # noqa: F401
