"""Multi-process runtime: initialisation, the rank's rows of a batch, global
metrics and heartbeat files.

Counterpart of ``ml_function_tpu/parallel/multihost.py``. JAX runs one
process a host and joins them with ``jax.distributed.initialize``; the port
runs one process a mesh coordinate and joins them with
``torch.distributed.init_process_group``:

- ``init_multihost()``: from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or the
  arguments; a no-op for a single process;
- ``host_batch_slice``: this rank's rows of each global batch, by its
  *data* coordinate (the ranks of one model group feed the same rows);
- ``global_metrics``: the streaming-AUC histograms summed over the data
  group only (the model ranks hold copies of the same metrics);
- ``Heartbeat``: a liveness file a rank and the reference's stale-rank
  rule, the failure detector for checkpoint-restart.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..train.metrics import MetricState
from . import comm


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: DeviceLike = None) -> Tuple[int, int]:
    """Join the process group from the arguments or torchrun's environment
    (``coordinator`` is ``host:port``, else ``MASTER_ADDR:MASTER_PORT``).
    NCCL when ``device`` is the card (the default), gloo on the CPU.
    Returns ``(rank, world size)``; a no-op for one process or when the
    group exists already."""
    if _live():
        return process_index(), process_count()
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    coordinator = coordinator or (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                                  f"{os.environ['MASTER_PORT']}")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("a run on the card needs NCCL, which this torch lacks")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return rank, world


def host_batch_slice(global_batch: int, mesh=None) -> Tuple[int, int]:
    """``(start, size)`` of this rank's rows of each global batch: the data
    coordinate's contiguous block (the whole batch without a mesh)."""
    d = 1 if mesh is None else mesh.data
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} % data axis {d} != 0")
    per = global_batch // d
    return (0 if mesh is None else mesh.data_index) * per, per


def global_metrics(local: MetricState, mesh=None) -> MetricState:
    """The metric state summed over the mesh's data group (histograms and
    sums are linear); unchanged on one rank."""
    group = None if mesh is None else mesh.data_group
    if group is None:
        return local
    return {k: comm.all_reduce_(v.detach().clone(), group) for k, v in local.items()}


@dataclass
class Heartbeat:
    """File-based liveness: each rank writes ``<dir>/host_<i>.hb`` every
    ``interval_s``; ``stale_hosts`` lists the ranks silent past
    ``timeout_s`` (a rank that never wrote one counts from the monitor's
    start)."""

    dir: str
    interval_s: float = 30.0
    timeout_s: float = 180.0
    _last_beat: float = 0.0
    _t0: float = 0.0

    def __post_init__(self):
        self._t0 = time.time()

    def path(self, idx: Optional[int] = None) -> str:
        i = process_index() if idx is None else idx
        return os.path.join(self.dir, f"host_{i}.hb")

    def beat(self, step: int = 0) -> None:
        now = time.time()
        if now - self._last_beat < self.interval_s:
            return
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": now, "step": step, "host": socket.gethostname()}, f)
        os.replace(tmp, self.path())
        self._last_beat = now

    def stale_hosts(self) -> List[int]:
        out = []
        now = time.time()
        for i in range(process_count()):
            p = self.path(i)
            try:
                with open(p) as f:
                    t = json.load(f)["t"]
                if now - t > self.timeout_s:
                    out.append(i)
            except FileNotFoundError:
                if now - self._t0 > self.timeout_s:
                    out.append(i)
            except (OSError, ValueError, KeyError):
                # a torn beat file: its mtime stands for the beat
                try:
                    if now - os.path.getmtime(p) > self.timeout_s:
                        out.append(i)
                except OSError:
                    if now - self._t0 > self.timeout_s:
                        out.append(i)
        return out

    def check_or_raise(self) -> None:
        stale = self.stale_hosts()
        if stale:
            raise RuntimeError(f"hosts {stale} missed heartbeat for >{self.timeout_s}s "
                               "— initiate checkpoint-restart")
