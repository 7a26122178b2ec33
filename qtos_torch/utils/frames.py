"""Command-pose codecs (reference: QTOS/utils.py:67-148 create_cmd_pose /
vec_to_cmd_pose) — dictionary view over the 37-column trajectory rows for
users of the reference API."""

from __future__ import annotations

import numpy as np

EE_NAMES = ("FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT")


def cmd_pose_from_row(row) -> dict:
    """37-col row -> reference-style command dict (utils.py:107-148)."""
    row = np.asarray(row)
    cmd = {
        "COM": row[1:7].copy(),
        "COM_VEL": row[19:25].copy(),
    }
    for i, name in enumerate(EE_NAMES):
        cmd[name] = {"P": row[7 + 3 * i : 10 + 3 * i].copy()}
        cmd[f"{name}_FORCE"] = row[25 + 3 * i : 28 + 3 * i].copy()
    return cmd


def row_from_cmd_pose(t: float, cmd: dict) -> np.ndarray:
    """Inverse codec -> 37-col row."""
    row = np.zeros(37, np.float32)
    row[0] = t
    row[1:7] = cmd["COM"]
    row[19:25] = cmd["COM_VEL"]
    for i, name in enumerate(EE_NAMES):
        row[7 + 3 * i : 10 + 3 * i] = cmd[name]["P"]
        row[25 + 3 * i : 28 + 3 * i] = cmd.get(f"{name}_FORCE", 0.0)
    return row
