"""Start the ranks of a torch.distributed group on one host and gather what
each returns.

tpuslam runs its distributed solves from one controller over a JAX mesh;
PyTorch runs one process per rank. `run(fn, world)` starts `world` fresh
processes (the spawn method: nothing of the caller's state is inherited),
makes each a rank of a group at tcp://localhost:<a free port>, calls
`fn(rank, world, *args)` there and returns the ranks' results in rank order.
`fn` must be a module-level function of a module that the ranks can import.
A rank that raises, dies or outlives `timeout` fails the whole run, and
every rank still alive is killed before `run` returns or raises.

Backends: gloo for CPU tensors, and for CUDA tensors of ranks that share
one card (gloo stages them through the host); NCCL where each rank has a
card of its own (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, port: int, backend: str, timeout: float) -> None:
    """Join the default process group at tcp://localhost:port; every
    collective of the group fails after `timeout` seconds."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))


def _rank_main(fn, rank, world, port, backend, timeout, args, results):
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_rank(rank, world, port, backend, timeout)
        results.put((rank, None, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, world: int, args=(), backend: str = "gloo", timeout: float = 120.0) -> list:
    """fn(rank, world, *args) on `world` new processes, each a rank of one
    group; returns [result of rank 0, ..., result of rank world-1]. Raises
    if a rank fails or the run takes longer than `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, timeout, args, results))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    out = [None] * world
    try:
        for p in procs:
            p.start()
        pending = set(range(world))
        while pending:
            try:
                rank, err, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {world} exited with code "
                                       f"{procs[dead[0]].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} of {world} still running "
                                       f"after {timeout} s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            out[rank] = res
            pending.discard(rank)
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {world} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
    return out
