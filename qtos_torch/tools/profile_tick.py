r"""What one tick of the plain 1 kHz control loop launches on one CUDA card.

    python3 -m qtos_torch.tools.profile_tick [TICKS]

The loop profiled is the plain version, `control.loop._scan_ticks`, which
`playback` runs on the CPU; on the card `playback` is one launch of the tick
kernel (`qtos_torch.ops.tick`), timed by `chip_smoke.py`.

Solves 256 trot windows on flat ground (plane x3, K=41, goals 0.3-0.8 m, three
LM iterations), samples them to 1 kHz tables, and plays the first TICKS rows
(default 50) at B = 1 and B = 256.  It prints

  - the aten operations one tick dispatches (counted on the host with a
    `TorchDispatchMode`; views included);
  - from `torch.profiler`: the device kernels one tick launches, the device's
    busy time per tick and its share of the same call's wall time without the
    profiler, and the ten kernels with the most device time ("not measured"
    if the profiler reports no device activity);
  - the card's name, power limit and SM clock, before and after the runs.

Times per tick of the plain loop and the kernel at full length are
`chip_smoke.py`'s (phase 6e).  It needs a
card and exits non-zero without one.
"""

from __future__ import annotations

import sys
from collections import Counter

import torch

from qtos_torch.control import ControlParams
from qtos_torch.control.loop import _hold_ticks, _scan_ticks, state_from_row
from qtos_torch.solver import SolverConfig, default_spec, sample_trajectory, solve_batch
from qtos_torch.solver.spec import index_spec
from qtos_torch.terrain import make_terrain
from qtos_torch.tools.kit import CountOps, card, synced


def _device_events(prof):
    """(name, microseconds) of every device-side event of a profile."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, float(e.device_time)))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_tick: needs a CUDA card", file=sys.stderr)
        return 1
    ticks = int(argv[1]) if len(argv) > 1 else 50
    dev = torch.device("cuda")
    print(card(("name", "power.limit", "clocks.sm")), flush=True)

    terrain = make_terrain(["plane"] * 3)
    params = ControlParams()
    Bmax = 256
    specs = default_spec(terrain, goal_xy=(torch.linspace(0.3, 0.8, Bmax, device=dev), 0.0), K=41)
    res = solve_batch(specs, terrain, SolverConfig(max_iters=3, rescue_iters=12))
    all_tables = torch.stack(
        [sample_trajectory(res.x[i], index_spec(specs, i))[0][:ticks] for i in range(Bmax)]
    )

    for B in (1, Bmax):
        tables = all_tables if B > 1 else all_tables[0]
        s0 = _hold_ticks(state_from_row(tables[..., 0, :], terrain, params), terrain, params, 20)
        if B == 1:
            with CountOps() as counter:
                _scan_ticks(tables[:10], s0, terrain, params)
            print(f"aten operations dispatched: {sum(counter.ops.values()) / 10:.1f} per tick (B=1, 10 ticks "
                  f"incl. the trace stacking); most frequent: {counter.ops.most_common(8)}", flush=True)
        _scan_ticks(tables[..., :5, :], s0, terrain, params)
        t0 = synced(dev)
        _scan_ticks(tables, s0, terrain, params)
        plain = synced(dev) - t0
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t0 = synced(dev)
            _scan_ticks(tables, s0, terrain, params)
            wall = synced(dev) - t0
        events = _device_events(prof)
        busy_us = sum(t for _, t in events)
        if not events or busy_us == 0.0:
            print(f"B={B}: device kernels per tick, busy share: not measured "
                  f"(the profiler reported no device activity)", flush=True)
            continue
        by_name = Counter()
        for name, t in events:
            by_name[name] += t
        top = ", ".join(f"{name[:60]} {t / busy_us:.1%}" for name, t in by_name.most_common(10))
        busy_ms, ms_tick = busy_us / 1e3 / ticks, plain / ticks * 1e3
        print(f"B={B}: {len(events) / ticks:.1f} device kernels and copies per tick, device busy "
              f"{busy_ms:.3f} ms per tick = {busy_ms / ms_tick:.1%} of the {ms_tick:.3f} ms per tick of the same "
              f"call without the profiler ({wall / ticks * 1e3:.3f} ms per tick under it; {ticks} ticks); "
              f"top by device time: {top}", flush=True)
    print(card(("name", "power.limit", "clocks.sm")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
