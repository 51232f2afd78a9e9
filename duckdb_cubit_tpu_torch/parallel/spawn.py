"""Run a function on every rank of a fresh `torch.distributed` world.

`run(fn, n, *args)` starts n processes by the `spawn` method (never `fork`:
the caller may have threads running, torch's pool or jax's), joins them in
one world through a `file://` rendezvous in a fresh temporary directory (so
concurrent launches never share a port), and calls `fn(mesh, *args)` on each
with the mesh over the whole world; it returns each rank's result in rank
order.  `fn` must be importable by name and its results picklable.

Every rank runs torch on one thread.  When a rank raises, dies or the
deadline passes, every rank is killed and `run` raises, so a broken rank
cannot stall the caller in a collective.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import make_mesh

INIT_TIMEOUT_S = 60


class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


def _rank_main(rank, n, init_file, backend, device, fn, args, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        mesh = make_mesh(n, backend=backend, device=device)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, n: int, *args, backend: str = "nccl", device="cuda",
        deadline_s: float = 120.0) -> list:
    """-> [fn(mesh, *args) on rank 0, ..., on rank n-1].  Rank r's mesh is
    on card r (modulo the cards) over NCCL unless the caller asks for
    another backend and device (the CPU tests: `backend="gloo",
    device="cpu"`)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rendezvous-")
    init_file = os.path.join(tmp, "init")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, init_file, backend, str(device), fn,
                               args, results))
             for r in range(n)]
    got = {}
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"rank {dead[0]} died with exit code "
                                    f"{procs[dead[0]].exitcode}") from None
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"{n - len(got)} of {n} ranks had not finished "
                        f"after {deadline_s} s") from None
                continue
            if not ok:
                raise RankError(f"rank {rank} raised:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(n)]
