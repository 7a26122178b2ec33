"""Plan visualization (reference: QTOS/visual.py Visual_Planner — upcoming
CoM/foot plan drawn as colored spheres in the PyBullet GUI).  Headless here:
renders the upcoming window of a 37-col trajectory table as a 3D matplotlib
artifact, FIFO-scrolled by the current row like the reference's `.step`."""

from __future__ import annotations

import os

import numpy as np


class VisualPlanner:
    """Renders plan-preview artifacts for a trajectory table."""

    def __init__(self, table, out_dir: str = "./data/visual", look_ahead: int = 2750,
                 step_size: int = 25):
        # look_ahead / step_size defaults mirror simulation.yml
        # (v_look_ahead 2750, v_step_size 25).
        self.table = np.asarray(table)
        self.out_dir = out_dir
        self.look_ahead = look_ahead
        self.step_size = step_size
        os.makedirs(out_dir, exist_ok=True)

    def render(self, at_row: int = 0, name: str | None = None) -> str:
        """Render the plan window starting at `at_row`; returns the file path."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        lo = max(0, at_row)
        hi = min(len(self.table), lo + self.look_ahead)
        win = self.table[lo : hi : self.step_size]
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        ax.plot(win[:, 1], win[:, 2], win[:, 3], "b.-", ms=3, label="CoM plan")
        colors = ["tab:red", "tab:green", "tab:orange", "tab:purple"]
        for i, lab in enumerate(["FL", "FR", "HL", "HR"]):
            ax.scatter(
                win[:, 7 + 3 * i], win[:, 8 + 3 * i], win[:, 9 + 3 * i],
                s=6, color=colors[i], label=f"{lab} plan",
            )
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_zlabel("z")
        ax.legend(loc="upper left", fontsize=7)
        name = name or f"plan_{lo:06d}.png"
        path = os.path.join(self.out_dir, name)
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return path
