"""Fused embedding tables (primary width).

Counterpart of ``FusedEmbedding`` in ``ml_function_tpu/ops/embedding.py``.
All vocabs share one ``table`` (V, D) of cross embeddings and one ``linear``
(V, 1) of first-order weights, addressed by global row ids (per-field id +
vocab offset). Id 0 of every vocab is the padding row.

A lookup is one ``index_select`` over the global ids, through ``_gather``,
the single place a later slice routes to a kernel. The reference's forward
is XLA's ``take`` and no Pallas kernel; its per-vocab grouped gather exists
for the TPU's scheduling and is not carried over.

Routes of the reference that the port does not take yet raise
``NotImplementedError``: narrow-width sub-tables (a mixed-width
FeatureSet) and the RowTape of the sparse-row path here, int8 tables in
``serving.load_scorer`` and row-sharded tables in ``serving.ShardedScorer``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..features.schema import FeatureSet
from .base import normal_init


def row_tape(tape):
    """The sparse-row path's lookup interception (reference ``row_tape``)."""
    raise NotImplementedError("RowTape (the sparse-row path) comes with "
                              "slice 7, the sparse path and serving")


def _gather(table: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """(…,) global row ids → (…, W) rows of one table."""
    rows = table.index_select(0, global_ids.reshape(-1))
    return rows.reshape(*global_ids.shape, table.shape[1])


class FusedEmbedding(nn.Module):
    """``table`` (V, D) + ``linear`` (V, 1) over a FeatureSet's vocabs."""

    def __init__(self, feature_set: FeatureSet, with_linear: bool = True):
        super().__init__()
        if feature_set.mixed_width:
            raise NotImplementedError(
                "mixed-width tables (narrow sub-tables with align "
                "projections) come with the slice of the remaining models")
        self.feature_set = feature_set
        self.with_linear = with_linear
        v, d = feature_set.total_vocab, feature_set.embed_dim
        self.table = nn.Parameter(torch.empty(v, d))
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
        self.table.copy_(normal_init(self.table.shape, generator))
        for name, w in (pre_weight or {}).items():
            w = torch.as_tensor(np.asarray(w, dtype=np.float32))
            off = fs.vocab_offsets[name]
            self.table[off:off + w.shape[0], :w.shape[1]] = w
        if self.linear is not None:
            self.linear.copy_(normal_init(self.linear.shape, generator))

    def _global_sparse_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids.long() + self._offsets[None, :]

    def sparse_all(self, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, F) ids → ((B, F, D) cross, (B, F) linear or None)."""
        gids = self._global_sparse_ids(ids)
        cross = _gather(self.table, gids)
        if self.linear is None:
            return cross, None
        return cross, _gather(self.linear, gids)[..., 0]

    def sparse(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) ids → (B, F, D) cross embeddings (no linear lookup)."""
        return _gather(self.table, self._global_sparse_ids(ids))

    def sparse_linear(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, F) ids → (B, F) first-order weights (no cross lookup)."""
        return _gather(self.linear, self._global_sparse_ids(ids))[..., 0]

    def l2_from_sparse(self, emb: torch.Tensor) -> torch.Tensor:
        """emb_l2-weighted ||rows||² from already-gathered (B, F, D) rows."""
        return (self._l2_coef * emb.square().sum(dim=(0, 2))).sum()
