"""Observability + interop utilities (reference: QTOS/tracking.py, logger.py,
visual.py, utils.py codecs)."""

from qtos_torch.utils.logger import Logger  # noqa: F401
from qtos_torch.utils.frames import cmd_pose_from_row, row_from_cmd_pose, EE_NAMES  # noqa: F401
from qtos_torch.utils.profiling import Timer, annotate, solve_telemetry, trace  # noqa: F401
