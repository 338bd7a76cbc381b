"""The sparse-row step over row-sharded tables.

Counterpart of ``ml_function_tpu/parallel/sparse.py``: tables too big for
one device (row-sharded over ``model``, ``parallel/embedding.py``) and too
big for full-table moment streams (row updates, ``train/sparse.py``).

A step:
1. records the lookup ids through the RowTape;
2. gathers the rows outside the loss through the collective lookup
   (``ShardedLookup``, psum or a2a: the exchange the dense forward uses);
3. differentiates the dense parameters and the gathered rows under the
   global batch's loss (``parallel/train.global_loss``), sums the dense
   gradients over the data group and updates them;
4. routes each row gradient to the rank that owns its row
   (``grad_exchange``):

   - ``'a2a'`` (default), owner-routed, the backward twin of the forward
     id all-to-all: the rank takes its model slice (S = ⌈N/m⌉) of its
     (id, gradient row) pairs, sorts it by id, adds the rows of duplicate
     ids into one slot of a capacity-bounded bucket a destination (the
     dedup-sum happens before the wire), ``all_to_all``s the buckets to
     their owners over the model group, and one ``all_gather`` over the
     data group collects the contributions to this block's rows only;
   - ``'allgather'``, the reference path: every rank gathers all (id, row)
     pairs of its model column over the data group, dedups the whole N and
     masks to the rows it owns.

   Either way the row optimizer updates the rows this block owns (the
   other slots clip to a row of the block with exact-zero deltas), and its
   moments live beside their rows.

All vocab-row tables take this path: the fused column groups and the
auxiliary tables (FFM's ``ffm``, OENN's ``order{k}``), row-sharded like the
fused table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..models.base import as_tensors
from ..ops.embedding import has_int8_tables
from ..train.sparse import (SparseTrainState, dedup_sum, row_table_groups,
                            sparse_dense_tree, sparse_step_core)
from . import comm
from .context import sharded_embeddings
from .embedding import ShardedLookup, _bucket, _wire
from .mesh import Mesh
from .train import (_is_expert_name, _is_table_name, global_loss, shard_model_,
                    sync_grads)


@dataclass
class SparseShardedTrainState(SparseTrainState):
    """A ``SparseTrainState`` over this rank's blocks (``mesh``, ``layout``
    as ``parallel/train.ShardedTrainState``)."""
    mesh: Optional[Mesh] = None
    layout: Dict[str, Tuple[int, int]] = field(default_factory=dict)


def sharded_row_groups(model, layout) -> Dict[str, torch.nn.Parameter]:
    """The row-updated tables of a sharded model by group: the embedding's
    column groups and its sharded top-level (aux) tables."""
    aux = tuple(k for k in layout
                if "." not in k and not _is_table_name(k) and not _is_expert_name(k))
    return row_table_groups(model, aux_keys=aux)


def create_sparse_sharded_state(model, dense_opt, row_opt, mesh: Mesh,
                                init_params=None) -> SparseShardedTrainState:
    """Shard ``model`` as ``create_sharded_state`` does (the aux tables
    too), fill it from ``init_params`` if given, bind ``dense_opt`` to every
    parameter but the row tables and give each row table this block's row
    state."""
    from ..bridge import shard_params_from_numpy
    if has_int8_tables(model):
        raise ValueError("a model with int8 serving tables cannot train")
    layout = shard_model_(model, mesh)
    if init_params is not None:
        params, state = (init_params if isinstance(init_params, tuple)
                         else (init_params, None))
        shard_params_from_numpy(model, params, mesh, layout, state=state)
    groups = sharded_row_groups(model, layout)
    return SparseShardedTrainState(
        model=model, dense=dense_opt.init(sparse_dense_tree(model, groups)),
        row_opt=row_opt, rows={g: row_opt.init(t.detach()) for g, t in groups.items()},
        step=0, mesh=mesh, layout=layout)


def _owned(table, sid, g, is_end, j):
    r = table.shape[0]
    local = sid - j * r
    owned = (local >= 0) & (local < r)
    return local.clamp(0, r - 1), torch.where(owned[:, None], g, 0.0), is_end & owned


def row_update_allgather(row_opt, table, state, gids, grads, mesh: Mesh) -> None:
    """Every (id, row) pair of the model column gathered over the data
    group, deduped, masked to this block's rows, applied in place."""
    ids_all = comm.all_gather_tensor(gids, mesh.data_group)
    g_all = comm.all_gather_tensor(grads, mesh.data_group)
    sid, g, is_end = dedup_sum(ids_all, g_all)
    row_opt.apply_rows(table, state, *_owned(table, sid, g, is_end, mesh.model_index))


def row_update_a2a(row_opt, table, state, gids, grads, mesh: Mesh,
                   capacity: Optional[int] = None, compress=None) -> None:
    """The owner-routed update (module docstring), in place."""
    r, w = table.shape[0], grads.shape[1]
    m, j = mesh.model, mesh.model_index
    n = gids.shape[0]
    s = -(-n // m)
    sentinel = r * m
    ids_p = torch.cat([gids, gids.new_full((s * m - n,), sentinel)])
    g_p = torch.cat([grads, grads.new_zeros((s * m - n, w))])
    mine, mine_g = ids_p[j * s:(j + 1) * s], g_p[j * s:(j + 1) * s]
    order, s_ids, s_owner, pos, _ = _bucket(mine, r, m)
    s_g = mine_g[order]
    cap = capacity or s
    live = (s_owner < m) & (pos < cap)
    send_ids = gids.new_full((m + 1, cap), sentinel)
    send_ids[s_owner[live], pos[live]] = s_ids[live]
    send_g = grads.new_zeros((m + 1, cap, w))
    # duplicates add into their unique id's slot: the dedup-sum before the wire
    send_g.index_put_((s_owner[live], pos[live]), s_g[live], accumulate=True)
    recv_ids = comm.all_to_all(send_ids[:m], mesh.model_group)
    recv_g = comm.all_to_all(_wire(send_g[:m], compress), mesh.model_group)
    all_ids = comm.all_gather_tensor(recv_ids.reshape(-1), mesh.data_group)
    all_g = comm.all_gather_tensor(recv_g.reshape(-1, w), mesh.data_group).to(grads.dtype)
    sid, g, is_end = dedup_sum(all_ids, all_g)
    row_opt.apply_rows(table, state, *_owned(table, sid, g, is_end, j))


def make_sparse_sharded_train_step(ts: SparseShardedTrainState, exchange: str = "psum",
                                   compress=None, grad_exchange: str = "a2a",
                                   grad_capacity: Optional[int] = None):
    """``train_step(batch) -> {"loss", "bce", "logits", "label", "weight"}``
    on this rank's rows of a global batch, the state updated in place.
    ``exchange``/``compress`` configure the forward's row gather,
    ``grad_exchange`` ('a2a' | 'allgather') the row gradients' routing and
    ``grad_capacity`` the unique ids of an a2a bucket (None: the lossless
    worst case, S); with a finite one the output carries
    ``grad_a2a_overflow``."""
    if grad_exchange not in ("a2a", "allgather"):
        raise ValueError(f"unknown grad_exchange {grad_exchange!r}")
    model, mesh = ts.model, ts.mesh
    fs = model.feature_set
    sl = ShardedLookup(mesh, fs, mode=exchange, compress=compress)
    groups = sharded_row_groups(model, ts.layout)
    dense_params = [p for _, p in sparse_dense_tree(model, groups)]

    def gather(group, table, gids):
        return sl.lookup(table, gids)

    def loss(model_, batch):
        logits, state, aux = model_(batch, train=True)
        total, bce = global_loss((logits, state, aux), batch, mesh)
        return total, (logits, state, aux, bce)

    def train_step(batch):
        batch = as_tensors(batch, mesh.device)
        with sharded_embeddings(mesh, mode=exchange, compress=compress):
            out, per_group = sparse_step_core(
                model, ts.dense, batch, gather, groups=groups, loss=loss,
                sync=lambda: sync_grads(dense_params, mesh))
        for g, (gids, grads) in per_group.items():
            table = groups[g].data
            if grad_exchange == "a2a":
                row_update_a2a(ts.row_opt, table, ts.rows[g], gids, grads, mesh,
                               grad_capacity, compress)
            else:
                row_update_allgather(ts.row_opt, table, ts.rows[g], gids, grads, mesh)
        pair = comm.all_reduce_(torch.stack([out["loss"], out["bce"]]), mesh.data_group)
        out["loss"], out["bce"] = pair[0], pair[1]
        out["weight"] = batch.get("weight")
        if grad_exchange == "a2a" and grad_capacity:
            obs = ShardedLookup(mesh, fs, mode="a2a", capacity=grad_capacity)
            out["grad_a2a_overflow"] = sum(
                obs.overflow_count(gids, rows=groups[g].shape[0] * mesh.model)
                for g, (gids, _) in per_group.items())
        ts.step += 1
        return out

    return train_step

