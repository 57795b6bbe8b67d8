"""Start a multi-rank run: ``run_ranks(fn, world)`` runs ``fn(rank, world,
*args)`` in ``world`` processes, each in a process group of its own
backend over a ``file://`` store (never a fixed TCP port, so runs side by
side do not collide), with a ``timeout``: a rank that hangs in a
collective fails the run instead of blocking it.  Each rank's return
value comes back to the caller, in rank order.

``fn`` must be importable by name (a module-level function): the ranks
are spawned processes.  On ``backend="nccl"`` rank r runs on ``cuda:r``.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_group(rank: int, world: int, backend: str, init_file: str,
               timeout_s: float = 300.0) -> None:
    """Join the process group of ``world`` ranks through ``init_file``."""
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def _entry(rank: int, fn: Callable, world: int, backend: str,
           init_file: str, out_dir: str, timeout_s: float, threads: int,
           args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_group(rank, world, backend, init_file, timeout_s)
    try:
        result = fn(rank, world, *args)
        with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, backend: str = "gloo",
              init_file: str | None = None, *, args: tuple = (),
              timeout_s: float = 300.0, threads: int = 1) -> list[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process of one process group.  A rank that raises
    fails the call (``torch.multiprocessing.ProcessRaisedException``)."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = init_file or os.path.join(tmp, "store")
        mp.spawn(_entry, args=(fn, world, backend, init, tmp, timeout_s,
                               threads, args),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(pathlib.Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
