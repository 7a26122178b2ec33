"""Traffic kind `replans_world`: replans on a world that changes while the
robot walks.  A pool of `worlds` worlds, world w the configuration's
terrain with one box dropped into it (the configuration's `box`: half-extent
and top) at x drawn from `box_x`, y = `box_y`; each carries `world_every`
replans of the configuration's `n_candidates` start rows (the 37-column row
format), replan p standing on world p // `world_every`.

A replan stands beside its world's box, as the global planner's detour
passes it: the CoM at the box's x plus `com_dx`, at `com_side` to one side of
the box's y (the side drawn per world), yaw and forward speed drawn from
`yaw` and `speed`.  Candidate i starts `candidate_stride` rows (ms) later
along the heading at that speed and aims (1 - i * `candidate_goal_backoff`)
of one window's advance (`avg_speed` x `window_duration`) straight ahead
along x at the CoM's y, yaw 0.  Feet stand on that world's grid, the CoM and
the goal `stand_height` above it.  A replan with a start foot over a raised
cell of its world (the box's, a wall's) is drawn again, from the draws made
for that purpose.  The first replan of a world takes, of those draws, the
first that also stands a foot on ground the box changed (the box's ramp,
where the world decides the plan) when one does; `seen` marks the worlds
with such a foot among their replans'.  At the mix's lateral range most
draws stand every foot clear of the ramp, so the check's sample (the
driver's) keeps seen worlds only."""

from __future__ import annotations

import torch

from benchmark import harness, traffic
from benchmark.reference import world as ref_world
from benchmark.reference.heightfield import height_at
from benchmark.reference.solo12 import Solo12
from benchmark.reference.solver import terrain

TRIES = 32           # draws made for each replan; the first whose feet stand clear is kept


def worlds(cfg: dict, box_x: torch.Tensor, box_y: float, device) -> torch.Tensor:
    """(W, H, Wd) the reference's worlds: the configuration's grid with one
    box each, centred at (box_x[w], box_y)."""
    base = harness.terrain_grid(cfg, device)
    res, origin, box = cfg["terrain_resolution"], tuple(cfg["terrain_origin"]), cfg["box"]
    return torch.stack([ref_world.add_box(base, res, origin, float(x), box_y, box["half"], box["top"])
                        for x in box_x.tolist()])


def rows_on(ground, x, y, yaw, speed, cfg: dict) -> tuple:
    """Start rows (n, k, 37), goals (n, k, 3), path times (n, k) of standing
    trot replans with the CoM at (x, y), heading yaw, speed, on `ground`;
    and the feet (n, k, 4, 3)."""
    n, k, device = x.shape[0], cfg["n_candidates"], x.device
    i = torch.arange(k, device=device, dtype=torch.float32)
    lag = i * cfg["candidate_stride"] / 1000.0
    cx = x[:, None] + speed[:, None] * lag * torch.cos(yaw)[:, None]
    cy = y[:, None] + speed[:, None] * lag * torch.sin(yaw)[:, None]
    h = Solo12.stand_height
    nominal = torch.tensor(Solo12.nominal_feet, dtype=torch.float32, device=device)[:, :2]
    c, s = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
    fx = cx[..., None] + c * nominal[:, 0] - s * nominal[:, 1]
    fy = cy[..., None] + s * nominal[:, 0] + c * nominal[:, 1]
    feet = torch.stack([fx, fy, height_at(ground, fx, fy)], -1)
    cz = h + height_at(ground, cx, cy)
    t0 = cx / cfg["avg_speed"]
    zeros = torch.zeros((n, k), device=device)
    yaw_k = yaw[:, None].expand(n, k)
    vx = (speed * torch.cos(yaw))[:, None].expand(n, k)
    vy = (speed * torch.sin(yaw))[:, None].expand(n, k)
    force = torch.tensor([0.0, 0.0, Solo12.mass * traffic.G / 4.0], device=device).repeat(4).expand(n, k, 12)
    rows = torch.cat([
        t0[..., None], cx[..., None], cy[..., None], cz[..., None],
        zeros[..., None], zeros[..., None], yaw_k[..., None], feet.reshape(n, k, 12),
        vx[..., None], vy[..., None], zeros[..., None], torch.zeros((n, k, 3), device=device), force,
    ], -1)
    advance = cfg["avg_speed"] * cfg["window_duration"] * (1.0 - cfg["candidate_goal_backoff"] * i)
    gx = cx + advance
    goals = torch.stack([gx, cy, h + height_at(ground, gx, cy)], -1)
    return rows, goals, t0, feet


def make(mix: dict, cfg: dict, g: torch.Generator, device) -> dict:
    """rows (P, k, 37), goals_r (P, k, 3), goals_yaw (P, k), t0s (P, k),
    world_of (P,) for P = worlds x world_every replans; box_x (W,), box_y,
    the reference's worlds (W, H, Wd) and seen (W,)."""
    Wn, per = mix["worlds"], mix["world_every"]
    P, T = Wn * per, TRIES
    box_x = traffic.uniform(g, (Wn,), *mix["box_x"], device)
    side = torch.where(torch.rand((Wn,), generator=g, device=device) < 0.5, -1.0, 1.0)
    dx = traffic.uniform(g, (P, T), *mix["com_dx"], device)
    dy = traffic.uniform(g, (P, T), *mix["com_side"], device)
    yaw = traffic.uniform(g, (P, T), *mix["yaw"], device)
    speed = traffic.uniform(g, (P, T), *mix["speed"], device)
    grids = worlds(cfg, box_x, mix["box_y"], device)
    res, origin = cfg["terrain_resolution"], tuple(cfg["terrain_origin"])
    world_of = torch.arange(P, device=device) // per
    base = terrain(harness.terrain_grid(cfg, device), cfg)
    first_replan = (torch.arange(per, device=device) == 0)[:, None]
    out = {key: [] for key in ("rows", "goals_r", "t0s", "seen")}
    for w in range(Wn):
        ground = terrain(grids[w], cfg)
        blocked = ref_world.raised(grids[w])
        p = slice(w * per, (w + 1) * per)
        x = box_x[w] + dx[p].reshape(-1)
        y = mix["box_y"] + side[w] * dy[p].reshape(-1)
        rows, goals, t0, feet = rows_on(ground, x, y, yaw[p].reshape(-1), speed[p].reshape(-1), cfg)
        r, c = ref_world.cell_of(tuple(grids[w].shape), res, origin, feet[..., 0], feet[..., 1])
        clear = ~blocked[r, c].flatten(1).any(1).reshape(per, T)
        if not bool(clear.any(1).all()):
            raise RuntimeError(f"world {w}: no draw of {T} stands clear of its raised cells")
        sees = (feet[..., 2] != height_at(base, feet[..., 0], feet[..., 1])).flatten(1).any(1).reshape(per, T)
        # the first clear draw of each replan, the first replan's first clear
        # draw that sees the box where one does
        first = torch.argmax(clear.to(torch.int8) + (clear & sees & first_replan).to(torch.int8), 1)
        pick = torch.arange(per, device=device) * T + first
        out["rows"].append(rows[pick])
        out["goals_r"].append(goals[pick])
        out["t0s"].append(t0[pick])
        out["seen"].append(sees.flatten()[pick].any())
    rows, goals, t0s = (torch.cat(out[key]).contiguous() for key in ("rows", "goals_r", "t0s"))
    return dict(rows=rows, goals_r=goals, goals_yaw=torch.zeros_like(t0s), t0s=t0s, world_of=world_of,
                box_x=box_x, box_y=float(mix["box_y"]), worlds=grids, seen=torch.stack(out["seen"]))
