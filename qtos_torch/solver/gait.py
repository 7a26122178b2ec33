"""Gait contact schedules as data (port of `qtos_tpu.solver.gait`).

A schedule is a pair of dense (K, 4) tensors — contact mask and swing
progress — so scenarios with different gaits share one solver.  Leg order
[FL, FR, HL, HR]; default trot offsets [0.5, 0, 0, 0.5], duty 0.6 (a walking
trot whose brief four-foot overlaps arrest lateral drift).
"""

from __future__ import annotations

import dataclasses

import torch

from qtos_torch.device import constant, resolve_device


@dataclasses.dataclass(frozen=True)
class GaitSchedule:
    contact: torch.Tensor          # (..., K, 4) in {0., 1.}: foot in stance at knot k
    swing_progress: torch.Tensor   # (..., K, 4) in [0, 1]: phase through current swing

    @property
    def num_knots(self):
        return self.contact.shape[-2]


def _swing_progress_from_phase(phase_in_cycle, duty):
    """phase_in_cycle in [0,1); swing occupies [duty, 1). Returns progress in swing."""
    in_swing = phase_in_cycle >= duty
    prog = (phase_in_cycle - duty) / max(1.0 - duty, 1e-6)
    return torch.where(in_swing, torch.clamp(prog, 0.0, 1.0), torch.zeros_like(prog))


def trot_schedule(
    K: int,
    dt: float,
    period: float = 0.5,
    duty: float = 0.6,
    offsets=(0.5, 0.0, 0.0, 0.5),
    stance_head: float = 0.2,
    stance_tail: float = 0.2,
    device=None,
) -> GaitSchedule:
    """Trot: diagonal pairs alternate; full stance at both window ends."""
    dev = resolve_device(device)
    t = torch.arange(K, device=dev, dtype=torch.float32) * dt
    offs = constant(tuple(offsets), torch.float32, dev)
    T = (K - 1) * dt
    cyc = torch.remainder((t[:, None] - stance_head) / period + offs[None, :], 1.0)
    in_stance_cycle = cyc < duty
    head = t[:, None] <= stance_head + 1e-9
    tail = t[:, None] >= T - stance_tail - 1e-9
    ends = head | tail
    contact = torch.where(ends, torch.ones_like(cyc), in_stance_cycle.to(torch.float32))
    prog = _swing_progress_from_phase(cyc, duty)
    prog = torch.where(ends, torch.zeros_like(prog), prog)
    return GaitSchedule(contact=contact, swing_progress=prog)


def stand_schedule(K: int, device=None) -> GaitSchedule:
    """All feet in contact."""
    dev = resolve_device(device)
    return GaitSchedule(
        contact=torch.ones((K, 4), device=dev), swing_progress=torch.zeros((K, 4), device=dev)
    )


def walk_schedule(K: int, dt: float, period: float = 0.8, duty: float = 0.75,
                  offsets=(0.0, 0.5, 0.75, 0.25), stance_head: float = 0.2,
                  stance_tail: float = 0.2, device=None) -> GaitSchedule:
    """Lateral-sequence walk (one foot in swing at a time)."""
    return trot_schedule(K, dt, period=period, duty=duty, offsets=offsets,
                         stance_head=stance_head, stance_tail=stance_tail, device=device)


def pace_schedule(K: int, dt: float, period: float = 0.5, duty: float = 0.55,
                  stance_head: float = 0.2, stance_tail: float = 0.2,
                  device=None) -> GaitSchedule:
    """Pace: lateral pairs (FL+HL, FR+HR) alternate."""
    return trot_schedule(K, dt, period=period, duty=duty,
                         offsets=(0.5, 0.0, 0.5, 0.0),
                         stance_head=stance_head, stance_tail=stance_tail, device=device)


def bound_schedule(K: int, dt: float, period: float = 0.45, duty: float = 0.6,
                   stance_head: float = 0.2, stance_tail: float = 0.2,
                   device=None) -> GaitSchedule:
    """Bound: front pair (FL+FR) and hind pair (HL+HR) alternate."""
    return trot_schedule(K, dt, period=period, duty=duty,
                         offsets=(0.0, 0.0, 0.5, 0.5),
                         stance_head=stance_head, stance_tail=stance_tail, device=device)


GAIT_REGISTRY = {
    "trot": trot_schedule,
    "walk": walk_schedule,
    "pace": pace_schedule,
    "bound": bound_schedule,
    "stand": lambda K, dt, device=None, **kw: stand_schedule(K, device=device),
}


def make_schedule(name: str, K: int, dt: float, **kwargs) -> GaitSchedule:
    """Config-driven gait selection."""
    try:
        return GAIT_REGISTRY[name](K, dt, **kwargs)
    except KeyError as e:
        raise KeyError(f"unknown gait {name!r}; known: {sorted(GAIT_REGISTRY)}") from e
