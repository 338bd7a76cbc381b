"""Fused embedding tables (primary width).

Counterpart of ``FusedEmbedding`` and ``gather_rows`` in
``ml_function_tpu/ops/embedding.py``. All vocabs share one ``table`` (V, D)
of cross embeddings and one ``linear`` (V, 1) of first-order weights,
addressed by global row ids (per-field id + vocab offset). Id 0 of every
vocab is the padding row. A store may hold ``linear`` alone (FFM, LR).

Lookups take the reference's two routes:
- the sparse lookups (``sparse_all``, ``sparse``, ``sparse_linear``) are one
  ``index_select`` over the global ids, flag or not, as the reference's
  grouped gather never reaches its merge-scatter kernel (the grouping
  itself exists for the TPU's scheduling and is not carried over);
- sequence lookups (``seq``) and the auxiliary tables' ``gather_rows`` go
  through ``_gather``, which takes
  ``kernels/embedding_grad.fused_gather`` (its backward the merge-scatter
  kernel) when ``ML_FUNCTION_TPU_MERGE_SCATTER=1``, read once at import into
  ``_USE_MERGE_SCATTER`` as in the reference, and ``index_select``
  otherwise.

Routes of the reference that the port does not take yet raise
``NotImplementedError``: narrow-width sub-tables (a mixed-width
FeatureSet) and the RowTape of the sparse-row path here, int8 tables in
``serving.load_scorer`` and row-sharded tables in ``serving.ShardedScorer``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..features.schema import FeatureSet
from .base import normal_init
from .kernels.embedding_grad import fused_gather

# ML_FUNCTION_TPU_MERGE_SCATTER=1 takes the merge-scatter backward for
# sequence lookups; read once, at import, as the reference reads it.
_USE_MERGE_SCATTER = os.environ.get("ML_FUNCTION_TPU_MERGE_SCATTER") == "1"


def row_tape(tape):
    """The sparse-row path's lookup interception (reference ``row_tape``)."""
    raise NotImplementedError("RowTape (the sparse-row path) comes with "
                              "slice 7, the sparse path and serving")


def _take(table: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """(…,) global row ids → (…, W) rows of one table (``index_select``,
    whose backward is PyTorch's ``index_add``)."""
    rows = table.index_select(0, global_ids.reshape(-1))
    return rows.reshape(*global_ids.shape, table.shape[1])


def _gather(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """(N,) ids → (N, W) rows; the merge-scatter backward under the flag."""
    if _USE_MERGE_SCATTER:
        return fused_gather(table, flat_ids)
    return table.index_select(0, flat_ids)


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                tape_key: Optional[str] = None) -> torch.Tensor:
    """(…,) row ids → (…, W) rows of one table, through ``_gather``: the
    sequence lookups and the tables that live outside a ``FusedEmbedding``
    (FFM's (V, F·K) blocks).

    ``tape_key`` names the lookup for the sparse-row path's RowTape, which
    the port does not have yet (``row_tape`` raises), so no lookup is ever
    taped and the key is only carried. The reference's int8 branch (a
    quantized serving table) comes with ``load_scorer(quantize='int8')``,
    Queue 1 item 6 of ``ROADMAP.md``; the port's tables are f32."""
    rows = _gather(table, ids.reshape(-1))
    return rows.reshape(*ids.shape, table.shape[1])


class FusedEmbedding(nn.Module):
    """``table`` (V, D) + ``linear`` (V, 1) over a FeatureSet's vocabs;
    ``with_table=False`` keeps ``linear`` alone."""

    def __init__(self, feature_set: FeatureSet, with_linear: bool = True,
                 with_table: bool = True):
        super().__init__()
        if feature_set.mixed_width:
            raise NotImplementedError(
                "mixed-width tables (narrow sub-tables with align "
                "projections) come with the slice of the remaining models")
        if not (with_table or with_linear):
            raise ValueError("a FusedEmbedding holds a table, a linear or both")
        self.feature_set = feature_set
        self.with_linear = with_linear
        v, d = feature_set.total_vocab, feature_set.embed_dim
        if with_table:
            self.table = nn.Parameter(torch.empty(v, d))
        else:
            self.register_parameter("table", None)
        if with_linear:
            self.linear = nn.Parameter(torch.empty(v, 1))
        else:
            self.register_parameter("linear", None)
        self.register_buffer("_offsets", torch.as_tensor(
            feature_set.sparse_offsets(), dtype=torch.int64), persistent=False)
        self.register_buffer("_l2_coef", torch.tensor(
            [s.emb_l2 for s in feature_set.sparse], dtype=torch.float32),
            persistent=False)

    @property
    def dim(self) -> int:
        return self.feature_set.embed_dim

    def reset_parameters(self, generator: torch.Generator,
                         pre_weight: Optional[Mapping[str, np.ndarray]] = None
                         ) -> None:
        """Normal(0.05) rows; ``pre_weight`` {vocab: (n, w) matrix}
        warm-starts the first n rows and w columns of that vocab's block."""
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

    def global_sparse_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) per-field ids → global row ids."""
        return ids.long() + self._offsets[None, :]

    def sparse_all(self, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, F) ids → ((B, F, D) cross, (B, F) linear or None)."""
        gids = self.global_sparse_ids(ids)
        cross = _take(self.table, gids)
        if self.linear is None:
            return cross, None
        return cross, _take(self.linear, gids)[..., 0]

    def sparse(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) ids → (B, F, D) cross embeddings (no linear lookup)."""
        return _take(self.table, self.global_sparse_ids(ids))

    def sparse_linear(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) ids → (B, F) first-order weights (no cross lookup)."""
        return _take(self.linear, self.global_sparse_ids(ids))[..., 0]

    def seq(self, name: str, ids: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) ids → ((B, L, D) rows with pad rows zeroed, (B, L) mask)."""
        mask = ids != 0
        rows = gather_rows(self.table, ids.long() + self.feature_set.seq_offset(name))
        return rows * mask[..., None], mask

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
        total = self.table.new_zeros(())
        if sparse_ids is not None and len(self.feature_set.sparse):
            total = total + self.l2_from_sparse(self.sparse(sparse_ids))
        for name, ids in (seq_ids or {}).items():
            total = total + self.l2_from_seq(name, self.seq(name, ids)[0])
        return total


def masked_sum_pool(seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B, L) → (B, D) sum over the valid steps."""
    return (seq * mask[..., None]).sum(dim=1)


def masked_mean_pool(seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B, L) → (B, D) mean over the valid steps (at least 1)."""
    denom = torch.clamp_min(mask.sum(dim=1, keepdim=True).float(), 1.0)
    return (seq * mask[..., None]).sum(dim=1) / denom
