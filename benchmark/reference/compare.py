"""The numbers that decide `correct`: gaps between what the program produced
and what the plain reference produced from the same inputs."""

from __future__ import annotations

import torch


def knot_gap(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """Widest gap between two sets of knot trajectories (n, K, NV): per
    window the largest |difference| over the largest |reference entry|,
    then the largest over the windows."""
    d = (x.double() - x_ref.double()).abs().amax((-2, -1))
    return float((d / x_ref.double().abs().amax((-2, -1))).max())


def viol_gap(viol: torch.Tensor, viol_ref: torch.Tensor) -> float:
    """Widest |difference| of the violation families (n, F), in their own
    units (those of the solver's `tol`)."""
    return float((viol.double() - viol_ref.double()).abs().max())


def table_gap(tables, contacts, tables_ref, contacts_ref) -> float:
    """Widest gap between 1 kHz tables (n, T, 37) and contact masks (n, T, 4):
    per window the largest |difference| of the columns after the time over
    the largest |reference entry| there, or the largest contact difference
    where that is larger (a contact differs by 1)."""
    t, r = tables[..., 1:].double(), tables_ref[..., 1:].double()
    rel = ((t - r).abs().amax((-2, -1)) / r.abs().amax((-2, -1))).max()
    return float(torch.maximum(rel, (contacts.double() - contacts_ref.double()).abs().max()))


def stack_viol(viol: dict) -> torch.Tensor:
    """A violation dict's families side by side (..., F), keys sorted."""
    return torch.stack([viol[k] for k in sorted(viol)], -1)
