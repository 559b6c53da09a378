"""Spawned gloo ranks for the ``test_torch_dist_*`` files.

``run_ranks(fn, world, *args)`` starts ``world`` processes (``spawn``), each
joining one gloo process group over ``tcp://127.0.0.1:<free port>`` with
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_*`` set as torchrun sets
them, calls ``fn(rank, world, *args)`` and sends its result back; the
results come in rank order. A rank that raises ends every rank, and the
traceback is raised here. ``fn`` must be a module-level function of a
module that imports no JAX at import time: each rank checks at its end that
JAX was never imported, so the port's distributed code runs without it.
"""

from __future__ import annotations

import os
import queue
import socket
import sys
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, results, init):
    try:
        import torch
        import torch.distributed as dist

        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        torch.set_num_threads(1)
        if init:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world)
        out = fn(rank, world, *args)
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        if "jax" in sys.modules:
            raise AssertionError("a rank imported JAX")
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 240.0, init: bool = True):
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)] from spawned
    ranks; ``init=False`` leaves the group to ``fn`` (the CLI joins it)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, results, init),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} sent nothing "
                                   f"in {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world)]
