"""Long-sequence models of the port: SIM.

Counterpart of ``SIM`` in ``ml_function_tpu/models/longseq.py``; DTS, MIMN
and HPMN come with a later slice. Submodules carry the JAX pytree's keys
(``dien``, the whole DIEN model whose embedding table the SIM shares,
``mha``, ``attn``, ``mlp`` and the optional ``align_long``), so the bridge
copies JAX weights as they are.

The exact search unit's ``MultiHeadAttention`` takes the flash-attention
kernel at a key length of 512 or more (hard search over a raw lifelong
stream); the DIEN core takes the (AU)GRU kernel when ``kernel = 'pallas'`` is
set on ``model.dien.gru1`` and ``model.dien.gru2``, as for DIEN.

Routes of the reference that the port does not take yet: the RowTape branch
of soft search (the port's ``ops.embedding.row_tape`` raises, slice 7), the
sequence-sharded search unit (slice 8; the port has no mesh context that
could ask for it) and ``esu_attention='lsh'``, which raises here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..features.schema import FeatureSet
from ..ops.attention import MultiHeadAttention, TargetAttention
from ..ops.core import MLP, Dense
from .base import Model, behavior_inputs, stateless
from .sequence import DIEN, _beh_dims, _tower_input


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) scores → (B, k) indices of the k largest of each row, in
    descending order, the lower index first among equal scores: the choice
    and order of ``lax.top_k`` (``torch.topk`` promises no order for ties)."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def SIM(fs: FeatureSet,
        candidate: Tuple[str, ...] = ("item", "cate"),
        behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
        long_behavior: Optional[Tuple[str, ...]] = None,
        search: str = "soft",
        top_k: int = 8,
        num_heads: int = 2,
        hidden: Tuple[int, ...] = (200, 80),
        aux_weight: float = 1.0,
        esu_attention: str = "softmax") -> Model:
    """Search-based Interest Model: a general search unit reduces the long
    stream ('hard': the stream was filtered in data preparation by
    ``features.encoders.hard_search``; 'soft': inner-product scores against
    the candidate's fields of the same vocabs, then the top k), and the exact
    search unit runs multi-head and target attention over what is left.
    Short-term interest comes from the DIEN core with its aux loss."""
    long_behavior = long_behavior or behavior
    if esu_attention == "lsh":
        raise NotImplementedError("esu_attention='lsh' (LSHSelfAttention) comes "
                                  "with the LSH item of the long-sequence tier")
    d, kd, n_other = _beh_dims(fs, candidate)
    # The long stream may carry fewer fields than the short behavior: soft
    # search scores it in the raw embedding space against the candidate
    # fields of the same vocabs, and only the k reduced rows are projected
    # to the ESU's width.
    kd_long = sum(fs.seq_spec(n).dim for n in long_behavior)
    cand_vocab_col = {fs.sparse[fs.sparse_index(n)].vocab: fs.sparse_index(n)
                      for n in candidate}
    long_score_cols = [cand_vocab_col.get(fs.seq_spec(n).vocab) for n in long_behavior]
    if search == "soft" and any(c is None for c in long_score_cols):
        raise ValueError(
            f"every long_behavior field must share a vocab with a candidate "
            f"field for soft search (long vocabs "
            f"{[fs.seq_spec(n).vocab for n in long_behavior]}, candidate "
            f"vocabs {list(cand_vocab_col)})")
    parts = {"dien": DIEN(fs, candidate, behavior, hidden=hidden),
             "mha": MultiHeadAttention(kd, num_heads),
             "attn": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "mlp": MLP(kd * 3 + n_other * d + len(fs.dense), hidden,
                        activation="prelu", norm="layer", out_dim=1)}
    if kd_long != kd:
        parts["align_long"] = Dense(kd_long, kd)
    cand_cols = [fs.sparse_index(n) for n in candidate]

    def soft_search(fe, batch):
        """The stop-gradient scoring pass over the whole stream, the top k,
        then a differentiable lookup of the selected ids only: (cand,
        reduced, red_mask, l2_long, emb). The full-stream lookup keeps
        nothing for backward, and the table's gradient covers B·k rows."""
        emb = fe.sparse(batch["sparse"])
        cand = torch.cat([emb[:, c, :] for c in cand_cols], dim=-1)
        with torch.no_grad():
            rows, long_mask = [], None
            for n in long_behavior:
                e, m = fe.seq(n, batch["seq"][n])
                rows.append(e)
                long_mask = m if long_mask is None else long_mask | m
            cand_long = torch.cat([emb[:, c, :] for c in long_score_cols], dim=-1)
            scores = torch.einsum("bld,bd->bl", torch.cat(rows, dim=-1), cand_long)
            scores = torch.where(long_mask, scores, -torch.inf)
        top_i = top_k_indices(scores, min(top_k, scores.shape[1]))
        reduced, red_mask = [], None
        l2 = fe.l2_from_sparse(emb)     # emb_l2 covers the rows used downstream
        for n in long_behavior:
            e, m = fe.seq(n, torch.gather(batch["seq"][n], 1, top_i))
            reduced.append(e)
            red_mask = m if red_mask is None else red_mask | m
            l2 = l2 + fe.l2_from_seq(n, e)
        return cand, torch.cat(reduced, dim=-1), red_mask, l2, emb

    def fwd(m, batch, train):
        fe = m.dien.embedding
        if search == "soft":
            cand, reduced, red_mask, l2_long, emb = soft_search(fe, batch)
        else:   # hard search was applied in data preparation
            cand, reduced, red_mask, l2_long, emb = behavior_inputs(
                fe, batch, candidate, long_behavior)
        if kd_long != kd:
            reduced = m.align_long(reduced)
        any_valid = red_mask.any(dim=1)
        safe_mask = red_mask | ~any_valid[:, None]
        esu = m.mha(reduced, mask=safe_mask)
        long_term = m.attn(cand, esu, safe_mask) * any_valid[:, None]
        s_cand, s_beh, s_mask, l2_short, _ = behavior_inputs(fe, batch, candidate,
                                                             behavior)
        short_term, aux = m.dien.interest(s_cand, s_beh, s_mask)
        h = _tower_input(fs, batch, (cand, long_term, short_term), emb, candidate)
        # both lookups count the sparse fields' l2: subtract one
        l2 = l2_long + l2_short - fe.l2_from_sparse(emb)
        return m.mlp(h, train)[:, 0], {"aux_loss": aux_weight * aux, "emb_l2": l2}

    return stateless("SIM", fs, parts, fwd)
