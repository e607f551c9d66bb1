"""Start R ranks of one function on this host and collect what each returns.

``spawn_ranks(fn, world, store_dir, device, args)`` starts
``world`` fresh processes (the ``spawn`` method), joins them into one
``torch.distributed`` group through a file store under ``store_dir`` (no
port to race for), runs ``fn(rank, world, *args)`` in each and returns the
results in rank order. The group is torn down in each process when ``fn``
returns. A rank that raises, dies or outlasts ``timeout`` fails the call
with what it printed; the others are stopped.

On a CUDA ``device`` rank r takes card ``r % torch.cuda.device_count()``:
ranks that outnumber the cards share them, which NCCL refuses, so the
group's backend is ``parallel.mesh.default_backend``'s (gloo there).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback

import torch


def _rank_main(fn, rank, world, init, device, threads, args, results):
    import torch.distributed as dist

    from .mesh import initialize_multihost

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        initialize_multihost(init, world, rank, device=dev)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it with this traceback
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world: int, store_dir: str, device: str = "cuda", args: tuple = (),
                timeout: float = 600.0, threads: int | None = None) -> list:
    """``[fn(0, world, *args), ..., fn(world-1, world, *args)]``, each run in
    its own rank process. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, f"file://{store}", device, threads, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                if not dead and time.monotonic() < deadline:
                    continue
                if not dead:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                       f"finish within {timeout} s") from None
                try:  # a rank that just exited may still have its result in flight
                    rank, ok, value = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} and no result"
                                       ) from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        results.close()
    return [out[r] for r in range(world)]
