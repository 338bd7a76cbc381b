"""Row-sharded tables and their collective lookups.

Counterpart of ``ml_function_tpu/parallel/embedding.py``. A table of V rows
is padded with zero rows to ``rows_per_shard(V, m) · m`` and split over the
``model`` axis in contiguous blocks of ``r = rows_per_shard(V, m)``: the
rank at model index j holds rows ``[j·r, (j+1)·r)``. The batch is split
over ``data``; the ranks of one model group hold the same batch shard and
compute the same dense forward from it.

Two exchanges, one interface (``mode=``), each a ``torch.autograd.Function``
over the rank's table block:

1. ``psum``: every rank gathers the rows it owns (mask, clamp,
   ``index_select``, zeros elsewhere) and an ``all_reduce`` over the model
   group sums the partials. Every rank of the group holds the same
   cotangent of the summed activation, so the backward is the identity on
   it (what psum's transpose is under ``shard_map``), then a masked
   ``index_add`` into the rank's block.
2. ``a2a``: the id all-to-all. The rank's N ids are split into m slices of
   S = ⌈N/m⌉ (padded with the sentinel r·m, owned by no rank); rank j takes
   slice j, sorts it by id, dedups it and gives each unique id one slot in
   a bucket of ``capacity`` slots a destination. ``all_to_all`` ships the
   ids to their owners, the owners gather, a second ``all_to_all`` ships
   the rows back, and an ``all_gather`` over the model group reassembles
   the (N, W) activation. The backward mirrors it: the rank's slice of the
   cotangent (summing nothing, as above), summed into each unique id's slot,
   ``all_to_all`` back to the owners and ``index_add`` into their blocks.
   The capacity defaults to S, the lossless worst case; unique ids past it
   read as zero rows and get no gradient (``overflow_count`` counts them).
   ``a2a_fetch`` is that exchange alone, with no closing gather and no
   gradient: the sequence-sharded search (``longseq.py``) fetches the rows
   of its block of the stream with it.

``compress='bf16'`` ships the exchanged rows (and their cotangents) in
bfloat16; the ids stay integers. Under psum each row has one non-zero
contributor, so that costs only the cast.

The ids go over the wire as int32, as the reference's do (``jnp.int32``
buffers), and come back to int64 only where an index needs it. So a table
whose padded row count (the sentinel r·m) does not fit int32 is refused
(``check_int32_rows``), where the reference's ``astype(jnp.int32)`` would
wrap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..features.schema import FeatureSet
from . import comm
from .mesh import Mesh


INT32_MAX = 2 ** 31 - 1


def check_int32_rows(padded_rows: int) -> None:
    """Refuse a row-sharded table whose padded row count, the exchanges'
    sentinel, does not fit the int32 ids they ship."""
    if padded_rows > INT32_MAX:
        raise ValueError(f"a sharded table of {padded_rows} padded rows does not fit the "
                         f"int32 ids of the exchanges (at most {INT32_MAX})")


def rows_per_shard(total_vocab: int, num_shards: int) -> int:
    return -(-total_vocab // num_shards)


def pad_table_for_shards(table: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Zero rows appended so that the table divides evenly across shards."""
    v = table.shape[0]
    target = rows_per_shard(v, num_shards) * num_shards
    if target == v:
        return table
    pad = table.new_zeros((target - v,) + tuple(table.shape[1:]))
    return torch.cat([table, pad], dim=0)


def _wire(x: torch.Tensor, compress: Optional[str]) -> torch.Tensor:
    return x.bfloat16() if compress == "bf16" else x


# ---------------------------------------------------------------------------
# psum: mask + all_reduce


class _PsumLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, flat, j, group, compress):
        r = shard.shape[0]
        local = flat - j * r
        owned = (local >= 0) & (local < r)
        safe = local.clamp(0, r - 1)
        rows = torch.where(owned[:, None], shard.index_select(0, safe), 0.0)
        out = comm.all_reduce_(_wire(rows, compress), group).to(shard.dtype)
        ctx.save_for_backward(safe, owned)
        ctx.r, ctx.compress = r, compress
        return out

    @staticmethod
    def backward(ctx, g):
        safe, owned = ctx.saved_tensors
        g = _wire(g, ctx.compress).to(g.dtype) * owned[:, None]
        grad = g.new_zeros((ctx.r, g.shape[1])).index_add_(0, safe, g)
        return grad, None, None, None, None


# ---------------------------------------------------------------------------
# a2a: the deduped id all-to-all


def _bucket(mine: torch.Tensor, r: int, m: int):
    """Sort a slice by id and give each unique id its rank within its
    owner's bucket: ``(order, s_ids, s_owner, pos, is_first)``; the owner of
    the sentinel r·m is m (no rank)."""
    order = torch.argsort(mine, stable=True)
    s_ids = mine[order]
    s_owner = torch.div(s_ids, r, rounding_mode="floor")
    counts = torch.bincount(s_owner, minlength=m + 1)
    offsets = torch.cumsum(counts, 0) - counts
    is_first = torch.ones_like(s_ids, dtype=torch.bool)
    is_first[1:] = s_ids[1:] != s_ids[:-1]
    cum_u = torch.cumsum(is_first.long(), 0)          # uniques up to i, inclusive
    before = torch.cat([cum_u.new_zeros(1), cum_u])[offsets[s_owner]]
    pos = cum_u - 1 - before
    return order, s_ids, s_owner, pos, is_first


def _slice_of(flat: torch.Tensor, m: int, j: int, sentinel: int) -> torch.Tensor:
    n = flat.shape[0]
    s = -(-n // m)
    pad = flat.new_full((s * m - n,), sentinel)
    return torch.cat([flat, pad])[j * s:(j + 1) * s]


def _fetch(shard, mine, j: int, m: int, group, cap: int, compress):
    """The owner-routed exchange for this rank's id slice ``mine`` (S,):
    sort and dedup it, ship each unique id to its owner, gather, ship the
    rows back. Returns (the (S, W) rows of ``mine`` in its order, what the
    backward needs). Ids ≥ r·m read as zero rows, as do unique ids past
    ``cap`` in their owner's bucket."""
    r, w = shard.shape
    sentinel = r * m
    check_int32_rows(sentinel)
    order, s_ids, s_owner, pos, _ = _bucket(mine, r, m)
    live = (s_owner < m) & (pos < cap)
    send = torch.full((m + 1, cap), sentinel, dtype=torch.int32, device=mine.device)
    # duplicates write the same id to the same slot
    send[s_owner[live], pos[live]] = s_ids[live].int()
    req = comm.all_to_all(send[:m], group)                    # (m, cap), int32
    local = req - j * r
    ok = (local >= 0) & (local < r)
    safe = local.clamp(0, r - 1).reshape(-1)
    rows = torch.where(ok[..., None], shard.index_select(0, safe).reshape(m, cap, w), 0.0)
    back = comm.all_to_all(_wire(rows, compress), group).to(shard.dtype)
    got = torch.where(live[:, None],
                      back[s_owner.clamp(max=m - 1), pos.clamp(0, cap - 1)], 0.0)
    my_rows = torch.empty_like(got)
    my_rows[order] = got
    return my_rows, (order, s_owner, pos, live, safe, ok)


@torch.no_grad()
def a2a_fetch(shard: torch.Tensor, mine: torch.Tensor, j: int, m: int, group,
              capacity: int, compress: Optional[str] = None) -> torch.Tensor:
    """The (S, W) rows of this rank's id slice ``mine`` (S,) through the
    owner-routed exchange over the model group (``j`` this rank's index in
    it, ``m`` its size), with no closing gather and no gradient: the
    counterpart of the reference's ``_a2a_fetch``, the core that the a2a
    lookup and the sequence-sharded search share."""
    return _fetch(shard, mine.long(), j, m, group, capacity, compress)[0]


class _A2ALookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, flat, j, m, group, capacity, compress):
        r, w = shard.shape
        n = flat.shape[0]
        mine = _slice_of(flat, m, j, r * m)
        cap = capacity or mine.shape[0]
        my_rows, saved = _fetch(shard, mine, j, m, group, cap, compress)
        ctx.save_for_backward(*saved)
        ctx.dims = (r, w, n, m, j, cap)
        ctx.group, ctx.compress = group, compress
        return comm.all_gather_tensor(my_rows, group)[:n]

    @staticmethod
    def backward(ctx, g):
        order, s_owner, pos, live, safe, ok = ctx.saved_tensors
        r, w, n, m, j, cap = ctx.dims
        s = order.shape[0]
        gp = torch.cat([g, g.new_zeros((s * m - n, w))])
        mine = gp[j * s:(j + 1) * s][order] * live[:, None]      # sorted
        mine = _wire(mine, ctx.compress).to(g.dtype)
        g_back = g.new_zeros((m, cap, w))
        g_back.index_put_((s_owner[live], pos[live]), mine[live], accumulate=True)
        g_rows = comm.all_to_all(_wire(g_back, ctx.compress), ctx.group).to(g.dtype)
        g_rows = (g_rows * ok[..., None]).reshape(-1, w)
        grad = g.new_zeros((r, w)).index_add_(0, safe, g_rows)
        return grad, None, None, None, None, None, None


def overflow_in_slice(flat: torch.Tensor, r: int, m: int, j: int, cap: int) -> int:
    """Unique ids of model slice j past ``cap`` in their owner's bucket."""
    mine = _slice_of(flat, m, j, r * m)
    _, _, s_owner, pos, is_first = _bucket(mine, r, m)
    return int((is_first & (pos >= cap) & (s_owner < m)).sum())


@dataclass(frozen=True)
class ShardedLookup:
    """The collective lookups of one rank of ``mesh`` (``mode`` 'psum' or
    'a2a'), over its block of a row-sharded table."""

    mesh: Mesh
    feature_set: FeatureSet
    mode: str = "psum"
    capacity: Optional[int] = None   # a2a unique ids a bucket; None: lossless
    compress: Optional[str] = None   # None | 'bf16'

    def lookup(self, table: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
        """(…,) global row ids → (…, W) rows from this rank's ``table``
        block, by the selected exchange."""
        flat = global_ids.reshape(-1).long()
        mesh, j = self.mesh, self.mesh.model_index
        if self.mode == "a2a":
            rows = _A2ALookup.apply(table, flat, j, mesh.model, mesh.model_group,
                                    self.capacity, self.compress)
        elif self.mode == "psum":
            rows = _PsumLookup.apply(table, flat, j, mesh.model_group, self.compress)
        else:
            raise ValueError(f"unknown exchange mode {self.mode!r}")
        return rows.reshape(*global_ids.shape, table.shape[1])

    def sparse(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) per-field ids → (B, F, W) through one lookup."""
        offs = torch.as_tensor(self.feature_set.sparse_offsets(), device=ids.device)
        return self.lookup(table, ids.long() + offs[None, :])

    def overflow_count(self, global_ids: torch.Tensor,
                       rows: Optional[int] = None) -> int:
        """Unique ids that the a2a capacity drops for one lookup of this
        rank's ``global_ids``, summed over the model group and then over the
        data group (0 without a finite capacity). ``rows`` is the table's
        padded row count (default: the fused table's)."""
        if self.mode != "a2a" or self.capacity is None:
            return 0
        m = self.mesh.model
        r = rows_per_shard(rows or self.feature_set.total_vocab, m)
        flat = global_ids.reshape(-1).long()
        local = torch.tensor(
            [overflow_in_slice(flat, r, m, self.mesh.model_index, self.capacity)],
            dtype=torch.int64, device=flat.device)
        comm.all_reduce_(local, self.mesh.model_group)
        comm.all_reduce_(local, self.mesh.data_group)
        return int(local.item())

