"""Run a function on every rank of a fresh local process group.

`run_ranks(target, n, device, *args)` spawns n processes (the `spawn` start
method: each imports this module anew), joins them into one process group
over `tcp://127.0.0.1:<free port>` (NCCL on `device="cuda"`, one card per
rank; gloo on `"cpu"`), calls `target(mesh, *args)` on each and returns the
results in rank order.  `target` must be a module-level function and its
result picklable (numpy arrays, not tensors).
"""

from __future__ import annotations

import socket
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(target, rank: int, n: int, port: int, device: str, args: tuple, queue) -> None:
    import torch.distributed as dist

    from qtos_torch.parallel.distributed import global_scenario_mesh, initialize_multihost

    try:
        dev = initialize_multihost(f"127.0.0.1:{port}", n, rank, device=device)
        try:
            queue.put((rank, True, target(global_scenario_mesh(device=dev), *args)))
        finally:
            dist.destroy_process_group()
    except Exception:                    # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(target, n: int, device: str, *args, timeout: float = 600.0) -> list:
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(target, r, n, port, device, args, queue)) for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(n):                    # drain before joining
            rank, ok, out = queue.get(timeout=timeout)
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [results[r] for r in range(n)]


def solve_cases(mesh, batches, K: int = 13, max_iters: int = 3) -> list:
    """This rank's view of the tiny problem (`qtos_torch.entry`) at each batch
    size in `batches`, solved both ways: `solve_batch_sharded` (every result
    gathered) and `solve_batch_collective` (this rank's x and statuses, and
    the gathered statuses).  Numpy results."""
    from qtos_torch.entry import _tiny_problem
    from qtos_torch.parallel.distributed import solve_batch_collective
    from qtos_torch.parallel.mesh import solve_batch_sharded

    out = []
    for B in batches:
        terrain, cfg, specs = _tiny_problem(B, K=K, max_iters=max_iters, device=mesh.device)
        res = solve_batch_sharded(specs, terrain, cfg, mesh)
        x_loc, st_loc, st_all = solve_batch_collective(specs, terrain, cfg, mesh)
        np_ = lambda t: t.cpu().numpy()                                 # noqa: E731
        out.append(dict(rank=mesh.rank, world=mesh.world, slice=mesh.slice_of(B), x=np_(res.x),
                        status=np_(res.status), max_violation=np_(res.max_violation), x_local=np_(x_loc),
                        status_local=np_(st_loc), status_gathered=np_(st_all)))
    return out
