"""One launcher for every multi-rank run: run_ranks.

The counterpart of the subprocess __graft_entry__.py starts to host a
virtual JAX mesh. Here each rank is a process of its own, joined to the
others by torch.distributed through a FileStore in a fresh temporary
directory (a TCP port could collide with another run on the same host),
so the sharded functions of parallel.sharding run as they would under
torchrun, on one host.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _rank_main(rank, world_size, backend, device_type, store_path,
               timeout_s, jobs, results):
    """One rank: take fn from `jobs`, join the process group, run fn(),
    report (rank, ok, result or traceback) on `results`."""
    try:
        fn = jobs.get()
        if device_type == "cpu":
            torch.set_num_threads(1)
        elif device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        result = fn()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, result))


def run_ranks(fn, world_size: int, *, backend: str | None = None,
              device_type: str = "cuda", timeout_s: float = 600.0) -> list:
    """Run fn() on `world_size` ranks and return their results, rank 0
    first.

    Each rank is a process started with the 'spawn' method; it joins the
    default process group (`backend`: None means NCCL for 'cuda' and gloo
    for 'cpu'), with a FileStore in a fresh temporary directory as the
    rendezvous, then calls fn(). On the CPU each rank runs one thread; on
    'cuda' rank r takes card r modulo the card count (gloo may put several
    ranks on one card; NCCL refuses that). fn must be picklable: a
    module-level function, or a functools.partial of one, in a module that
    a fresh interpreter can import (the child imports it by name), and its
    result picklable (numpy arrays and Python objects; CUDA tensors passed
    IN as arguments reach the ranks through CUDA IPC, with this process
    holding them). Raises RuntimeError with the rank's traceback when a
    rank fails, or when one dies without a result, and TimeoutError when
    `timeout_s` runs out; either way every rank still running is killed.
    device_type 'cuda' without a card raises RuntimeError before any rank
    starts."""
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_ranks: device_type 'cuda' but torch finds no CUDA device "
            "(device_type='cpu' runs the ranks on the CPU)")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    ctx = mp.get_context("spawn")
    # fn goes through a queue, not the Process arguments: those are
    # written to each child before start() returns, so a large fn would
    # start the ranks one after another
    jobs, results = ctx.Queue(), ctx.Queue()
    done = {}
    with tempfile.TemporaryDirectory(prefix="lif_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, args=(
                rank, world_size, backend, device_type, store, timeout_s,
                jobs, results), daemon=True)
            for rank in range(world_size)
        ]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            for _ in procs:
                jobs.put(fn)
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} ranks: {sorted(done)} finished within "
                        f"{timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} and no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                done[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            for q in (jobs, results):
                q.cancel_join_thread()  # a killed rank may leave fn unread
                q.close()
    return [done[r] for r in range(world_size)]
