"""Tracking artifacts: reference-vs-sim series and the plot files the
reference emits into data/tracking/ (reference: QTOS/tracking.py:45-404 —
CoM track :328, ref-vs-sim panels :202, error :288, error-vs-distance :367)
plus the experiment_data.out error log (:197-200)."""

from __future__ import annotations

import os

import numpy as np


class Tracking:
    """Accumulates per-tick reference and simulated states, renders plots."""

    def __init__(self, out_dir: str = "./data/tracking"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.t: list = []
        self.ref_com: list = []
        self.sim_com: list = []
        self.ref_feet: list = []
        self.sim_feet: list = []

    def extend(self, table, sim_pos, sim_feet=None):
        """Bulk-append a played-back chunk: table (T, 37), sim_pos (T, 3)."""
        table = np.asarray(table)
        sim_pos = np.asarray(sim_pos)
        self.t.extend(table[:, 0].tolist())
        self.ref_com.extend(table[:, 1:4].tolist())
        self.sim_com.extend(sim_pos.tolist())
        if sim_feet is not None:
            self.ref_feet.extend(table[:, 7:19].reshape(-1, 4, 3).tolist())
            self.sim_feet.extend(np.asarray(sim_feet).tolist())

    # -- metrics ----------------------------------------------------------

    @property
    def com_err(self) -> np.ndarray:
        return np.linalg.norm(np.asarray(self.ref_com) - np.asarray(self.sim_com), axis=-1)

    def summary(self) -> dict:
        err = self.com_err
        n = max(len(err), 1)
        return dict(
            ticks=len(err),
            mean_com_err=float(err.mean()) if len(err) else 0.0,
            max_com_err=float(err.max()) if len(err) else 0.0,
            cum_com_err=float(err.sum()),
            # the reference's headline metric (tracking.py:394: x1000 scale)
            avg_com_err_per_s=float(err.sum() / n * 1000.0),
        )

    def write_log(self, path: str = "./logs/experiment_data.out") -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        s = self.summary()
        with open(path, "w") as f:
            for k, v in s.items():
                f.write(f"{k}: {v}\n")

    # -- plots ------------------------------------------------------------

    def plot(self) -> None:
        """Render CoM_track, ref-vs-sim panels, and error plots."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ref = np.asarray(self.ref_com)
        sim = np.asarray(self.sim_com)
        if len(ref) == 0:
            return
        t = np.asarray(self.t)

        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(ref[:, 0], ref[:, 1], label="plan CoM")
        ax.plot(sim[:, 0], sim[:, 1], label="sim CoM")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.legend()
        ax.set_title("CoM track")
        fig.savefig(os.path.join(self.out_dir, "CoM_track.png"), dpi=110, bbox_inches="tight")
        plt.close(fig)

        fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
        for i, lab in enumerate("xyz"):
            axes[i].plot(t, ref[:, i], label=f"plan {lab}")
            axes[i].plot(t, sim[:, i], label=f"sim {lab}")
            axes[i].legend(loc="upper right", fontsize=7)
        axes[-1].set_xlabel("t [s]")
        fig.savefig(os.path.join(self.out_dir, "ref_sim_com.png"), dpi=110, bbox_inches="tight")
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(t, self.com_err)
        ax.set_xlabel("t [s]")
        ax.set_ylabel("CoM err [m]")
        fig.savefig(os.path.join(self.out_dir, "tracking_error.png"), dpi=110, bbox_inches="tight")
        plt.close(fig)

        dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(sim, axis=0), axis=-1))])
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(dist, self.com_err)
        ax.set_xlabel("distance travelled [m]")
        ax.set_ylabel("CoM err [m]")
        fig.savefig(
            os.path.join(self.out_dir, "tracking_error_vs_distance.png"),
            dpi=110,
            bbox_inches="tight",
        )
        plt.close(fig)

        # per-foot ref-vs-sim 12-panel figure (reference: tracking.py:202-286)
        if self.ref_feet and self.sim_feet:
            rf = np.asarray(self.ref_feet)        # (T, 4, 3)
            sf = np.asarray(self.sim_feet)
            legs = ("FL", "FR", "HL", "HR")
            fig, axes = plt.subplots(4, 3, figsize=(11, 9), sharex=True)
            for leg in range(4):
                for ax_i, lab in enumerate("xyz"):
                    a = axes[leg][ax_i]
                    a.plot(t, rf[:, leg, ax_i], lw=0.8, label="plan")
                    a.plot(t, sf[:, leg, ax_i], lw=0.8, label="sim")
                    if leg == 0 and ax_i == 0:
                        a.legend(fontsize=7)
                    if ax_i == 0:
                        a.set_ylabel(legs[leg])
                    if leg == 0:
                        a.set_title(lab)
            axes[-1][1].set_xlabel("t [s]")
            fig.savefig(os.path.join(self.out_dir, "ref_sim_feet.png"),
                        dpi=110, bbox_inches="tight")
            plt.close(fig)
