"""Behavior-sequence models of the port: DIN and DIEN.

Counterpart of ``DIN``, ``_auxiliary_loss`` and ``DIEN`` in
``ml_function_tpu/models/sequence.py``; BST, DSIN and SeqFM come with later
slices. Submodules carry the JAX pytree's keys (``embedding``, ``gru1``,
``gru2``, ``attn``, ``aux``, ``mlp``), so the bridge copies JAX weights as
they are.

DIEN's recurrences are the port's ``GRU``/``AUGRU`` with the reference's
default route, ``kernel='scan'``; setting ``kernel = 'pallas'`` on
``model.gru1`` and ``model.gru2`` takes the fused (AU)GRU kernel, as
building the JAX DIEN with ``GRU(kd, kd, kernel='pallas')`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..features.schema import FeatureSet
from ..ops.attention import TargetAttention
from ..ops.core import MLP
from ..ops.embedding import FusedEmbedding, masked_sum_pool
from ..ops.recurrent import AUGRU, GRU
from .base import Model, behavior_inputs, stateless


def _other_sparse(fs: FeatureSet, emb: torch.Tensor,
                  candidate: Sequence[str]) -> Optional[torch.Tensor]:
    """Flat rows of the sparse fields that are not candidates, or None."""
    cand_idx = {fs.sparse_index(n) for n in candidate}
    rest = [i for i in range(len(fs.sparse)) if i not in cand_idx]
    if not rest:
        return None
    return emb[:, rest, :].reshape(emb.shape[0], -1)


def _beh_dims(fs: FeatureSet, candidate):
    """(D, k·D, number of other sparse fields)."""
    d = fs.embed_dim
    return d, len(candidate) * d, len(fs.sparse) - len(candidate)


def _tower_input(fs: FeatureSet, batch, cand, pooled, emb, candidate):
    """[cand, pooled…, other sparse rows, dense] → (B, ·)."""
    parts = [cand, *pooled]
    other = _other_sparse(fs, emb, candidate)
    if other is not None:
        parts.append(other)
    if batch.get("dense") is not None and batch["dense"].shape[-1] > 0:
        parts.append(batch["dense"])
    return torch.cat(parts, dim=-1)


def DIN(fs: FeatureSet,
        candidate: Tuple[str, ...] = ("item", "cate"),
        behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
        hidden: Tuple[int, ...] = (200, 80),
        activation: str = "dice",
        attention_hidden: Tuple[int, ...] = (36, 1)) -> Model:
    """Deep Interest Network: sum-pooled and target-attention-pooled
    behaviors + candidate + other fields → Dice MLP with LayerNorm."""
    d, kd, n_other = _beh_dims(fs, candidate)
    in_dim = kd * 3 + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "attn": TargetAttention(kd, attention_hidden, activation="sigmoid"),
             "mlp": MLP(in_dim, hidden, activation=activation, norm="layer",
                        out_dim=1)}

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        pooled = (masked_sum_pool(beh, mask), m.attn(cand, beh, mask))
        h = _tower_input(fs, batch, cand, pooled, emb, candidate)
        return m.mlp(h, train)[:, 0], {"emb_l2": l2}

    return stateless("DIN", fs, parts, fwd)


def _auxiliary_loss(aux_mlp: MLP, states: torch.Tensor, beh: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """DIEN's auxiliary loss: (h_t, e_{t+1}) scored as a click and
    (h_t, e_neg) as a non-click, with negatives from the batch rolled by one
    row, over the steps where both t and t+1 are valid."""
    h_t = states[:, :-1, :]
    pos = beh[:, 1:, :]
    neg = torch.roll(beh, 1, 0)[:, 1:, :]
    m = (mask[:, 1:] & mask[:, :-1]).float()

    def score(e):
        return aux_mlp(torch.cat([h_t, e], dim=-1))[..., 0]

    ll = F.logsigmoid(score(pos)) + F.logsigmoid(-score(neg))
    return -(ll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def DIEN(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         hidden: Tuple[int, ...] = (200, 80),
         activation: str = "prelu",
         aux_weight: float = 1.0,
         mode: str = "augru") -> Model:
    """Deep Interest Evolution Network: GRU interest extractor (with its
    auxiliary loss), then the attention-gated AUGRU evolution
    (``mode='aigru'``: the attention-weighted states into a plain GRU).
    ``model.interest(cand, beh, mask)`` is the shared core SIM reuses."""
    d, kd, n_other = _beh_dims(fs, candidate)
    in_dim = kd * 2 + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "gru1": GRU(kd, kd),
             "gru2": GRU(kd, kd) if mode == "aigru" else AUGRU(kd, kd),
             "attn": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "aux": MLP(2 * kd, (100, 50), activation="sigmoid", out_dim=1),
             "mlp": MLP(in_dim, hidden, activation=activation, norm="layer",
                        out_dim=1)}

    def interest(m, cand, beh, mask):
        """(final interest state (B, kd), aux loss)."""
        states, _ = m.gru1(beh, mask)
        aux = _auxiliary_loss(m.aux, states, beh, mask)
        scores = m.attn.scores(cand, states, mask)
        if mode == "aigru":
            _, final = m.gru2(states * scores[..., None], mask)
        else:
            _, final = m.gru2(states, mask, att_scores=scores)
        return final, aux

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        final, aux = interest(m, cand, beh, mask)
        h = _tower_input(fs, batch, cand, (final,), emb, candidate)
        return m.mlp(h, train)[:, 0], {"aux_loss": aux_weight * aux, "emb_l2": l2}

    model = stateless("DIEN", fs, parts, fwd)
    model.interest = lambda cand, beh, mask: interest(model, cand, beh, mask)
    return model
