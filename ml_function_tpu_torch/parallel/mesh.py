"""The ``(data, model)`` mesh over ``torch.distributed`` ranks.

Counterpart of ``ml_function_tpu/parallel/mesh.py``. Where JAX lays devices
out as ``np.asarray(devices).reshape(data, model)``, the port lays out
ranks row-major: rank ``r`` sits at ``(r // model, r % model)``, one rank a
coordinate, its device ``cuda:LOCAL_RANK`` (or the CPU when asked).

Axes:
- ``data``: batch sharding; gradients are summed over it;
- ``model``: embedding-table row sharding; lookups exchange ids and rows
  over it.

Every rank belongs to one *model group* (the ranks of its data row, which
share its batch shard) and one *data group* (the ranks of its model
column, which share its table shard). ``dist.new_group`` is collective, so
``make_mesh`` creates every group on every rank in the same order.

NCCL carries the groups on the card and gloo on the CPU; nothing falls
back: a mesh on ``cuda`` over a process group that is not NCCL raises.
Without an initialised process group the mesh is one rank with no groups,
and every collective of ``comm.py`` is the identity there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from . import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh: the ``(data, model)`` shape, its
    coordinates, its two groups (None without a process group) and its
    device."""

    data: int
    model: int
    coords: Tuple[int, int]
    ranks: Tuple[int, ...]
    data_group: Optional[object]
    model_group: Optional[object]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, coords={self.coords}, "
                f"device={self.device})")


def _local_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1,
              ranks: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> Mesh:
    """The mesh over ``ranks`` (default: every rank of the process group,
    or this process alone without one), laid out row-major over
    ``(data, model)``; ``data=None`` takes ``len(ranks) // model``. Raises
    as the reference does when ``data·model`` is not the number of ranks,
    and when a mesh on ``cuda`` would run over a process group that is not
    NCCL."""
    dev = _local_device(device)
    live = dist.is_available() and dist.is_initialized()
    if ranks is None:
        ranks = range(dist.get_world_size()) if live else (0,)
    ranks = tuple(int(r) for r in ranks)
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    me = dist.get_rank() if live else 0
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh's ranks {ranks}")
    if not live:
        return Mesh(data, model, (0, 0), ranks, None, None, dev)
    backend = dist.get_backend()
    if dev.type == "cuda" and backend != "nccl":
        raise RuntimeError(f"a mesh on {dev} needs an NCCL process group, "
                           f"not {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pos = ranks.index(me)
    i, j = divmod(pos, model)
    model_group = data_group = None
    # dist.new_group is collective over the whole world: every rank creates
    # every group, in this order
    for row in range(data):
        g = dist.new_group([ranks[row * model + c] for c in range(model)])
        if row == i:
            model_group = g
    for col in range(model):
        g = dist.new_group([ranks[row * model + col] for row in range(data)])
        if col == j:
            data_group = g
    comm.name_group(model_group, MODEL_AXIS)
    comm.name_group(data_group, DATA_AXIS)
    return Mesh(data, model, (i, j), ranks, data_group, model_group, dev)
