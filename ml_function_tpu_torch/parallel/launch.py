"""Run a function on several local CPU ranks (gloo), or one card's process
alone in a group (NCCL).

``spawn(fn, nprocs, args, store_dir)`` starts ``nprocs`` processes with the
``spawn`` start method; each sets its CPU threads (one by default), joins a process group
initialised from a ``FileStore`` in ``store_dir`` (no TCP port, so that
concurrent runs never collide), calls ``fn(rank, *args)`` and leaves the
group. A child re-imports ``fn``'s module, so keep ``fn`` in a module that
imports only what the ranks need. ``torchrun --nproc_per_node=N`` is the
other way in (``multihost.init_multihost`` reads its environment).
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, fn: Callable, nprocs: int, store_path: str, args: Sequence,
           threads: int) -> None:
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(store_path, nprocs)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=nprocs)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), store_dir: str = ".",
          threads: int = 1) -> None:
    """``fn(rank, *args)`` on ``nprocs`` CPU ranks of a fresh gloo process
    group; raises if any rank raises."""
    path = os.path.join(store_dir, f"filestore_{os.getpid()}_{id(fn)}")
    if os.path.exists(path):
        os.remove(path)
    mp.start_processes(_child, args=(fn, nprocs, path, tuple(args), threads),
                       nprocs=nprocs, join=True, start_method="spawn")


def init_single(store_dir: str) -> None:
    """An NCCL process group of this process alone, from a ``FileStore`` in
    ``store_dir``: a collective path at world size 1 (one card)."""
    path = os.path.join(store_dir, f"filestore_single_{os.getpid()}")
    if os.path.exists(path):
        os.remove(path)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
