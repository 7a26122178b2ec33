"""Traffic kind `replans`: `pool` replans of the configuration's
`n_candidates` start rows each (the 37-column row format), standing trot
rows with the CoM at x, y, yaw and forward speed drawn uniformly from the
mix's ranges.  Candidate i starts `candidate_stride` rows (ms) later along
the heading at that speed and aims (1 - i * `candidate_goal_backoff`) of one
window's advance (`avg_speed` x `window_duration`) ahead along x, at y = 0
and yaw 0.  Feet stand on the configuration's terrain, the CoM and the goal
`stand_height` above the terrain under them."""

from __future__ import annotations

import torch

from benchmark import harness, traffic
from benchmark.reference.heightfield import height_at
from benchmark.reference.solo12 import Solo12
from benchmark.reference.solver import terrain


def make(mix: dict, cfg: dict, g: torch.Generator, device) -> dict:
    """rows (pool, k, 37), goals_r (pool, k, 3), goals_yaw (pool, k), t0s
    (pool, k)."""
    P, k = mix["pool"], cfg["n_candidates"]
    ground = terrain(harness.terrain_grid(cfg, device), cfg)
    x = traffic.uniform(g, (P,), *mix["com_x"], device)
    y = traffic.uniform(g, (P,), *mix["com_y"], device)
    yaw = traffic.uniform(g, (P,), *mix["yaw"], device)
    speed = traffic.uniform(g, (P,), *mix["speed"], device)
    i = torch.arange(k, device=device, dtype=torch.float32)
    lag = i * cfg["candidate_stride"] / 1000.0                          # (k,) s
    cx = x[:, None] + speed[:, None] * lag * torch.cos(yaw)[:, None]   # (P, k)
    cy = y[:, None] + speed[:, None] * lag * torch.sin(yaw)[:, None]
    h = Solo12.stand_height
    nominal = torch.tensor(Solo12.nominal_feet, dtype=torch.float32, device=device)[:, :2]
    c, s = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
    fx = cx[..., None] + c * nominal[:, 0] - s * nominal[:, 1]         # (P, k, 4)
    fy = cy[..., None] + s * nominal[:, 0] + c * nominal[:, 1]
    feet = torch.stack([fx, fy, height_at(ground, fx, fy)], -1).reshape(P, k, 12)
    cz = h + height_at(ground, cx, cy)
    t0 = cx / cfg["avg_speed"]
    zeros = torch.zeros((P, k), device=device)
    yaw_k = yaw[:, None].expand(P, k)
    vx = (speed * torch.cos(yaw))[:, None].expand(P, k)
    vy = (speed * torch.sin(yaw))[:, None].expand(P, k)
    force = torch.tensor([0.0, 0.0, Solo12.mass * traffic.G / 4.0], device=device).repeat(4).expand(P, k, 12)
    rows = torch.cat([
        t0[..., None], cx[..., None], cy[..., None], cz[..., None],
        zeros[..., None], zeros[..., None], yaw_k[..., None], feet,
        vx[..., None], vy[..., None], zeros[..., None], torch.zeros((P, k, 3), device=device), force,
    ], -1)
    advance = cfg["avg_speed"] * cfg["window_duration"] * (1.0 - cfg["candidate_goal_backoff"] * i)
    gx = cx + advance
    goals = torch.stack([gx, zeros, h + height_at(ground, gx, zeros)], -1)
    return dict(rows=rows.contiguous(), goals_r=goals.contiguous(), goals_yaw=zeros.clone(),
                t0s=t0.contiguous())
