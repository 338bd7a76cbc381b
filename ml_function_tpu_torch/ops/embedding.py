"""Fused embedding tables.

Counterpart of ``FusedEmbedding`` and ``gather_rows`` in
``ml_function_tpu/ops/embedding.py``. All primary-width vocabs share one
``table`` (V, D) of cross embeddings and one ``linear`` (V, 1) of
first-order weights, addressed by global row ids (per-field id + vocab
offset). Id 0 of every vocab is the padding row. A store may hold
``linear`` alone (FFM, LR).

Vocabs declared narrower than the primary width D form per-width
sub-tables, ``table{d}`` (V_d, d) and ``linear{d}`` (V_d, 1) with their own
row space (``FeatureSet.aux_vocab_offsets``), and a learned ``align{d}``
(d, D) projection through ``bf16_matmul`` brings their rows to D, so models
see (B, ·, D) whatever the widths; a mixed lookup re-interleaves the
columns in field order.

Lookups take the reference's routes:
- the primary sparse lookups (``sparse_all``, ``sparse``, ``sparse_linear``)
  are one ``index_select`` over the global ids, flag or not, as the
  reference's grouped gather never reaches its merge-scatter kernel (the
  grouping itself exists for the TPU's scheduling and is not carried over);
- sequence lookups (``seq``), the narrow sub-tables and the auxiliary
  tables' ``gather_rows`` go through ``_gather``, which takes
  ``kernels/embedding_grad.fused_gather`` (its backward the merge-scatter
  kernel) when ``ML_FUNCTION_TPU_MERGE_SCATTER=1``, read once at import into
  ``_USE_MERGE_SCATTER`` as in the reference, and ``index_select``
  otherwise.

Under an active ``parallel.context.sharded_embeddings`` whose model axis is
above 1, each table holds only this rank's row block, and every lookup past
the two modes below (the primary ``table`` and ``linear`` reads, the narrow
sub-tables, the sequences and ``gather_rows``) goes through the collective
``parallel/embedding.ShardedLookup`` in their place, in the reference's
order: the RowTape first, then int8, then the sharded route.

Two modes replace the tables' rows before any of that:
- **the RowTape** (``row_tape``, the sparse-row path of ``train/sparse.py``):
  in ``record`` mode every lookup logs (column group, global ids) and returns
  zeros; in ``inject`` mode it returns the next pre-gathered rows, which the
  caller differentiates as inputs, so no (V, W) table gradient forms;
- **int8 serving storage** (``quantize_()``, ``serving.quantize_for_serving``):
  each row holds int8 values and the exponent of a power-of-2 scale,
  ``[q·W, e]``; the fused pair packs into one ``qpl`` row
  ``[q_cross·D, e_cross, q_lin, e_lin]``. The rows are dequantised as they
  are gathered; the int8 tables are buffers, not parameters.
"""

from __future__ import annotations

import os
import threading
from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..features.schema import FeatureSet
from ..parallel import context as pctx
from .base import bf16_matmul, glorot_uniform, normal_init
from .kernels.embedding_grad import fused_gather

# ML_FUNCTION_TPU_MERGE_SCATTER=1 takes the merge-scatter backward for
# sequence lookups; read once, at import, as the reference reads it.
_USE_MERGE_SCATTER = os.environ.get("ML_FUNCTION_TPU_MERGE_SCATTER") == "1"


# ---------------------------------------------------------------------------
# the row tape: the sparse-row path's interception of every lookup

# one active tape a thread: two sparse steps run from two threads must not
# interleave their records or take each other's rows
_TAPE_TLS = threading.local()


class RowTape:
    """``record``: each lookup appends (group, global ids) to ``records``
    and returns zeros of its shape. ``inject``: each lookup returns the next
    of ``rows``, in the order they were recorded."""

    def __init__(self, mode: str, rows=None):
        assert mode in ("record", "inject")
        self.mode = mode
        self.records: List[Tuple[str, torch.Tensor]] = []
        self._rows = list(rows or [])
        self._i = 0

    def gather(self, group: str, gids: torch.Tensor, width: int) -> torch.Tensor:
        if self.mode == "record":
            self.records.append((group, gids))
            return torch.zeros(*gids.shape, width, device=gids.device)
        rows = self._rows[self._i]
        self._i += 1
        assert tuple(rows.shape) == (*gids.shape, width), \
            f"row tape out of sync: {tuple(rows.shape)} vs {(*gids.shape, width)}"
        return rows


class row_tape:
    """Context manager that makes ``tape`` the lookups' tape on this thread."""

    def __init__(self, tape: RowTape):
        self.tape = tape

    def __enter__(self) -> RowTape:
        prev = getattr(_TAPE_TLS, "tape", None)
        assert prev is None or prev.mode != self.tape.mode, (
            f"a {self.tape.mode!r} RowTape is already active on this thread "
            "— nested tapes of the same mode would interleave records")
        self._prev, _TAPE_TLS.tape = prev, self.tape
        return self.tape

    def __exit__(self, *exc):
        _TAPE_TLS.tape = self._prev
        return False


def active_row_tape() -> Optional[RowTape]:
    return getattr(_TAPE_TLS, "tape", None)


# ---------------------------------------------------------------------------
# int8 serving storage: per-row symmetric pow2 scale packed into the row


def quantize_table(table: torch.Tensor) -> torch.Tensor:
    """(V, W) f32 → int8 (V, W+1): W values scaled by a per-row power of 2
    whose exponent is the last column. ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    table = table.detach().float()
    absmax = torch.clamp_min(table.abs().amax(dim=1, keepdim=True), 1e-30)
    e = torch.clamp(torch.ceil(torch.log2(absmax / 127.0)), -126, 126)
    q = torch.clamp(torch.round(table * torch.exp2(-e)), -127, 127)
    return torch.cat([q, e], dim=1).to(torch.int8)


def quantize_fused(table: torch.Tensor, linear: torch.Tensor) -> torch.Tensor:
    """cross (V, D) + linear (V, 1) → int8 (V, D+3),
    ``[q_cross·D, e_cross, q_lin, e_lin]``: one gather serves both groups."""
    return torch.cat([quantize_table(table), quantize_table(linear)], dim=1)


def _dequant(packed: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Rows of an int8 (V, W+1) table → (N, W) f32 (exact: q·2^e)."""
    r = packed.index_select(0, flat_ids).float()
    return r[:, :-1] * torch.exp2(r[:, -1:])


def _dequant_fused(qpl: torch.Tensor, flat_ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of a packed (V, D+3) pair → ((N, D) cross, (N,) linear)."""
    r = qpl.index_select(0, flat_ids).float()
    d = r.shape[1] - 3
    return (r[:, :d] * torch.exp2(r[:, d:d + 1]),
            r[:, d + 1] * torch.exp2(r[:, d + 2]))


class QuantizedTable(nn.Module):
    """One row table in int8 serving storage: the buffer ``qp`` (V, W+1)."""

    def __init__(self, qp: torch.Tensor):
        super().__init__()
        self.register_buffer("qp", qp)

    @property
    def width(self) -> int:
        return self.qp.shape[1] - 1

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """(…,) row ids → (…, W) dequantised rows."""
        return _dequant(self.qp, ids.reshape(-1)).reshape(*ids.shape, self.width)


Table = Union[torch.Tensor, QuantizedTable]


def _width(table: Table) -> int:
    return table.width if isinstance(table, QuantizedTable) else table.shape[-1]


def _sharded():
    """The active context's collective lookup when its model axis is above
    1, else None."""
    if pctx.model_axis_size() <= 1:
        return None
    from ..parallel.embedding import ShardedLookup
    return ShardedLookup(pctx.active_mesh(), None, mode=pctx.exchange_mode(),
                         compress=pctx.exchange_compress(),
                         capacity=pctx.exchange_capacity())


def _take(table: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """(…,) global row ids → (…, W) rows of one table (``index_select``,
    whose backward is PyTorch's ``index_add``; the collective lookup over
    this rank's block under a sharded context)."""
    sh = _sharded()
    if sh is not None:
        return sh.lookup(table, global_ids)
    rows = table.index_select(0, global_ids.reshape(-1))
    return rows.reshape(*global_ids.shape, table.shape[1])


def _gather(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """(N,) ids → (N, W) rows; the merge-scatter backward under the flag."""
    if _USE_MERGE_SCATTER:
        return fused_gather(table, flat_ids)
    return table.index_select(0, flat_ids)


def gather_rows(table: Table, ids: torch.Tensor,
                tape_key: Optional[str] = None) -> torch.Tensor:
    """(…,) row ids → (…, W) rows of one table, through ``_gather``: the
    sequence lookups and the tables that live outside a ``FusedEmbedding``
    (FFM's (V, F·K) blocks, OENN's per-order tables).

    ``tape_key`` names the lookup for the sparse-row path: under an active
    RowTape the call records or injects under that key and never reads
    ``table`` (only its width). Keys 'table'/'linear' are the
    FusedEmbedding's column groups; an auxiliary table's key is its
    top-level parameter name ('ffm', 'order2'). A ``QuantizedTable`` (int8
    serving) is dequantised as it is gathered."""
    if tape_key is not None:
        tape = active_row_tape()
        if tape is not None:
            return tape.gather(tape_key, ids, _width(table))
    if isinstance(table, QuantizedTable):
        return table.rows(ids)
    sh = _sharded()
    if sh is not None:
        return sh.lookup(table, ids)
    rows = _gather(table, ids.reshape(-1))
    return rows.reshape(*ids.shape, table.shape[1])


class FusedEmbedding(nn.Module):
    """``table`` (V, D) + ``linear`` (V, 1) over a FeatureSet's primary
    vocabs, and ``table{d}``/``linear{d}``/``align{d}`` for each narrower
    width d; ``with_table=False`` keeps ``linear`` alone (one width only)."""

    def __init__(self, feature_set: FeatureSet, with_linear: bool = True,
                 with_table: bool = True):
        super().__init__()
        if not (with_table or with_linear):
            raise ValueError("a FusedEmbedding holds a table, a linear or both")
        fs = feature_set
        self.feature_set = fs
        self.with_linear = with_linear
        d0 = fs.embed_dim
        self.narrow_dims = tuple(sorted(d for d in fs.width_groups if d != d0))
        if self.narrow_dims and not with_table:
            raise ValueError("a linear-only store takes one width: the narrow "
                             "sub-tables carry cross rows and their align")
        self._narrow_sparse = any(s.dim != d0 for s in fs.sparse)
        v = fs.total_vocab
        self.register_parameter(
            "table", nn.Parameter(torch.empty(v, d0)) if with_table else None)
        self.register_parameter(
            "linear", nn.Parameter(torch.empty(v, 1)) if with_linear else None)
        for d in self.narrow_dims:
            vd = fs.aux_total_vocab(d)
            self.register_parameter(f"table{d}", nn.Parameter(torch.empty(vd, d)))
            if with_linear:
                self.register_parameter(f"linear{d}", nn.Parameter(torch.empty(vd, 1)))
            self.register_parameter(f"align{d}", nn.Parameter(torch.empty(d, d0)))
        # the packed int8 (table, linear) pair, once quantised
        self.register_buffer("qpl", None)
        if not self._narrow_sparse:
            self.register_buffer("_offsets", torch.as_tensor(
                fs.sparse_offsets(), dtype=torch.int64), persistent=False)
        else:   # each width group's fields and offsets, on the tables' device
            for d, (cols, offs) in self._width_offsets().items():
                self.register_buffer(f"_cols_w{d}", torch.as_tensor(
                    cols, dtype=torch.int64), persistent=False)
                self.register_buffer(f"_offsets_w{d}", torch.as_tensor(
                    offs, dtype=torch.int64), persistent=False)
        self.register_buffer("_l2_coef", torch.tensor(
            [s.emb_l2 for s in fs.sparse], dtype=torch.float32), persistent=False)

    @property
    def dim(self) -> int:
        return self.feature_set.embed_dim

    @property
    def quantized(self) -> bool:
        return self.qpl is not None or isinstance(self.table, QuantizedTable)

    def reset_parameters(self, generator: torch.Generator,
                         pre_weight: Optional[Mapping[str, np.ndarray]] = None
                         ) -> None:
        """Normal(0.05) rows, glorot ``align{d}``; ``pre_weight`` {vocab:
        (n, w) matrix} warm-starts the first n rows and w columns of that
        vocab's block."""
        fs = self.feature_set
        if self.table is not None:
            self.table.copy_(normal_init(self.table.shape, generator))
        elif pre_weight:
            raise ValueError("pre_weight needs a table")
        for name, w in (pre_weight or {}).items():
            w = torch.as_tensor(np.asarray(w, dtype=np.float32))
            off = fs.vocab_offsets[name]
            self.table[off:off + w.shape[0], :w.shape[1]] = w
        if self.linear is not None:
            self.linear.copy_(normal_init(self.linear.shape, generator))
        for d in self.narrow_dims:
            for key in (f"table{d}", f"linear{d}"):
                t = getattr(self, key, None)
                if t is not None:
                    t.copy_(normal_init(t.shape, generator))
            getattr(self, f"align{d}").copy_(glorot_uniform((d, self.dim), generator))

    # ---- int8 serving storage -------------------------------------------

    @torch.no_grad()
    def quantize_(self) -> "FusedEmbedding":
        """Serving storage in place (``serving.quantize_for_serving``): the
        (table, linear) pair packs into one int8 ``qpl`` (V, D+3) buffer;
        every other table wider than 1 (``table`` without ``linear``,
        ``table{d}``) becomes a ``QuantizedTable``; ``linear{d}`` and
        ``align{d}`` stay f32. The store cannot train after this."""
        if self.quantized:
            return self
        if self.table is not None and self.linear is not None:
            self.register_buffer("qpl", quantize_fused(self.table, self.linear))
            self.register_parameter("table", None)
            self.register_parameter("linear", None)
        for k in ("table", *(f"table{d}" for d in self.narrow_dims)):
            t = self._parameters.get(k)
            if t is not None and t.shape[1] > 1:
                del self._parameters[k]
                self.add_module(k, QuantizedTable(quantize_table(t)))
        return self

    # ---- keyed row access (tape and int8 aware) -------------------------

    def _keyed_rows(self, key: str, gids: torch.Tensor, width: int) -> torch.Tensor:
        tape = active_row_tape()
        if tape is not None:
            return tape.gather(key, gids, width)
        return gather_rows(getattr(self, key), gids)

    def _width_offsets(self):
        """Width → (its sparse fields, their offsets in that width's table)."""
        fs, d0 = self.feature_set, self.dim
        out = {}
        for d in sorted(fs.width_groups):
            cols = [i for i, s in enumerate(fs.sparse) if s.dim == d]
            if cols:
                offs = fs.vocab_offsets if d == d0 else fs.aux_vocab_offsets(d)
                out[d] = (cols, [offs[fs.sparse[i].vocab] for i in cols])
        return out

    def _sparse_mixed(self, ids: torch.Tensor, want_cross: bool,
                      want_linear: bool):
        """Each width group from its own table (narrow ones aligned to D),
        the columns re-interleaved in field order: (cross (B, F, D) | None,
        linear (B, F) | None)."""
        fs, d0 = self.feature_set, self.dim
        n = len(fs.sparse)
        cross_cols: list = [None] * n
        lin_cols: list = [None] * n
        for d, (cols, _) in self._width_offsets().items():
            tkey, lkey = ("table", "linear") if d == d0 else (f"table{d}", f"linear{d}")
            gids = (ids.index_select(1, getattr(self, f"_cols_w{d}")).long()
                    + getattr(self, f"_offsets_w{d}")[None, :])
            if d == d0 and self.qpl is not None:
                cr, ln = _dequant_fused(self.qpl, gids.reshape(-1))
                cr, ln = cr.reshape(*gids.shape, d0), ln.reshape(gids.shape)
            else:
                cr = self._keyed_rows(tkey, gids, d) if want_cross else None
                ln = (self._keyed_rows(lkey, gids, 1)[..., 0]
                      if want_linear else None)
            if want_cross and d != d0:
                cr = bf16_matmul(cr, getattr(self, f"align{d}"))   # (B, n, D)
            for j, i in enumerate(cols):
                if want_cross:
                    cross_cols[i] = cr[:, j, :]
                if want_linear:
                    lin_cols[i] = ln[:, j]
        return (torch.stack(cross_cols, dim=1) if want_cross else None,
                torch.stack(lin_cols, dim=1) if want_linear else None)

    # ---- lookups --------------------------------------------------------

    def global_sparse_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) per-field ids → global row ids (one primary width only)."""
        if self._narrow_sparse:
            raise ValueError("global_sparse_ids is the one-width fast path; this "
                             "FeatureSet has narrow-width sparse fields")
        return ids.long() + self._offsets[None, :]

    def sparse_all(self, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, F) ids → ((B, F, D) cross, (B, F) linear or None)."""
        if self._narrow_sparse:
            return self._sparse_mixed(ids, True, self.with_linear)
        gids = self.global_sparse_ids(ids)
        tape = active_row_tape()
        if tape is not None:
            cross = tape.gather("table", gids, self.dim)
            lin = tape.gather("linear", gids, 1)[..., 0] if self.with_linear else None
            return cross, lin
        if self.qpl is not None:      # int8 serving: one packed gather
            cross, lin = _dequant_fused(self.qpl, gids.reshape(-1))
            return (cross.reshape(*ids.shape, self.dim),
                    lin.reshape(ids.shape) if self.with_linear else None)
        cross = self._primary(self.table, gids)
        if not self.with_linear:
            return cross, None
        return cross, _take(self.linear, gids)[..., 0]

    def sparse(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) ids → (B, F, D) cross embeddings (no linear lookup)."""
        if self._narrow_sparse:
            return self._sparse_mixed(ids, True, False)[0]
        gids = self.global_sparse_ids(ids)
        tape = active_row_tape()
        if tape is not None:
            return tape.gather("table", gids, self.dim)
        if self.qpl is not None:
            return _dequant_fused(self.qpl, gids.reshape(-1))[0].reshape(
                *ids.shape, self.dim)
        return self._primary(self.table, gids)

    def sparse_linear(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) ids → (B, F) first-order weights (no cross lookup)."""
        if self._narrow_sparse:
            return self._sparse_mixed(ids, False, True)[1]
        gids = self.global_sparse_ids(ids)
        tape = active_row_tape()
        if tape is not None:
            return tape.gather("linear", gids, 1)[..., 0]
        if self.qpl is not None:
            return _dequant_fused(self.qpl, gids.reshape(-1))[1].reshape(ids.shape)
        return _take(self.linear, gids)[..., 0]

    @staticmethod
    def _primary(table: Table, gids: torch.Tensor) -> torch.Tensor:
        if isinstance(table, QuantizedTable):
            return table.rows(gids)
        return _take(table, gids)

    def seq(self, name: str, ids: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) ids → ((B, L, D) rows with pad rows zeroed, (B, L) mask).
        A narrow sequence field takes its width group's sub-table and
        ``align{d}``."""
        fs = self.feature_set
        spec = fs.seq_spec(name)
        mask = ids != 0
        if spec.dim != self.dim:
            d = spec.dim
            off = fs.aux_vocab_offsets(d)[spec.vocab]
            rows = self._keyed_rows(f"table{d}", ids.long() + off, d)
            rows = bf16_matmul(rows, getattr(self, f"align{d}"))
            return rows * mask[..., None], mask
        gids = ids.long() + fs.seq_offset(name)
        if self.qpl is not None and active_row_tape() is None:
            rows = _dequant_fused(self.qpl, gids.reshape(-1))[0].reshape(
                *ids.shape, self.dim)
        else:
            rows = self._keyed_rows("table", gids, self.dim)
        return rows * mask[..., None], mask

    # ---- regularisation ---------------------------------------------------

    def l2_from_sparse(self, emb: torch.Tensor) -> torch.Tensor:
        """emb_l2-weighted ||rows||² from already-gathered (B, F, D) rows."""
        return (self._l2_coef * emb.square().sum(dim=(0, 2))).sum()

    def l2_from_seq(self, name: str, emb: torch.Tensor) -> torch.Tensor:
        """The same for a gathered (B, L, D) sequence (pad rows zeroed)."""
        return self.feature_set.seq_spec(name).emb_l2 * emb.square().sum()

    def l2_loss(self, sparse_ids: Optional[torch.Tensor] = None,
                seq_ids: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """Σ emb_l2·||rows used||² over the given lookups; looks the rows up
        again (the models use ``l2_from_*`` on rows they already have)."""
        total = self._l2_coef.new_zeros(())
        if sparse_ids is not None and len(self.feature_set.sparse):
            total = total + self.l2_from_sparse(self.sparse(sparse_ids))
        for name, ids in (seq_ids or {}).items():
            total = total + self.l2_from_seq(name, self.seq(name, ids)[0])
        return total


def has_int8_tables(model: nn.Module) -> bool:
    """Whether ``model`` holds int8 serving storage, which cannot train."""
    return any(isinstance(m, QuantizedTable)
               or (isinstance(m, FusedEmbedding) and m.quantized)
               for m in model.modules())


def masked_sum_pool(seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B, L) → (B, D) sum over the valid steps."""
    return (seq * mask[..., None]).sum(dim=1)


def masked_mean_pool(seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B, L) → (B, D) mean over the valid steps (at least 1)."""
    denom = torch.clamp_min(mask.sum(dim=1, keepdim=True).float(), 1.0)
    return (seq * mask[..., None]).sum(dim=1) / denom
