"""Behavior-sequence models of the port: DIN, DIEN, BST, DSIN, SeqFM,
DSTN, DMIN and MIND.

Counterpart of ``ml_function_tpu/models/sequence.py``. Submodules carry the
JAX pytree's keys (``embedding``, ``gru1``, ``gru2``, ``attn``, ``aux``,
``mlp``, ``bilstm``, ``block0``, …), so the bridge copies JAX weights as
they are.

The self-attention of DSIN's sessions, DMIN's refiner and SeqFM's static
view is ``MultiHeadAttention``, so under ``ML_FUNCTION_TPU_FIELD_ATTN=1`` it
takes the field-attention kernels wherever the reference's gate admits the
shape (Lq·Lk ≤ 4096, head dim ≤ 64, no extra bias, not causal).

DIEN's recurrences are the port's ``GRU``/``AUGRU`` with the reference's
default route, ``kernel='scan'``; setting ``kernel = 'pallas'`` on
``model.gru1`` and ``model.gru2`` takes the fused (AU)GRU kernel, as
building the JAX DIEN with ``GRU(kd, kd, kernel='pallas')`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..features.schema import FeatureSet
from ..ops.attention import (NEG_INF, MultiHeadAttention, SessionPositionBias,
                             TargetAttention, TransformerBlock,
                             sincos_position_encoding)
from ..ops.base import bf16_matmul, glorot_uniform, normal_init
from ..ops.core import MLP, Dense
from ..ops.embedding import FusedEmbedding, masked_mean_pool, masked_sum_pool
from ..ops.recurrent import AUGRU, GRU, BiLSTM
from .base import Model, as_tensors, behavior_inputs, stateless


def _other_fields(fs: FeatureSet, candidate: Sequence[str]) -> torch.Tensor:
    """The positions of the sparse fields that are not candidates, a model's
    ``other_fields`` buffer (a step that copied them from the host could
    not be captured into a CUDA graph)."""
    cand_idx = {fs.sparse_index(n) for n in candidate}
    return torch.tensor([i for i in range(len(fs.sparse)) if i not in cand_idx],
                        dtype=torch.long)


def _beh_dims(fs: FeatureSet, candidate):
    """(D, k·D, number of other sparse fields)."""
    d = fs.embed_dim
    return d, len(candidate) * d, len(fs.sparse) - len(candidate)


def _tower_input(m, batch, lead, emb):
    """[lead…, flat rows of the other sparse fields, dense] → (B, ·)."""
    parts = list(lead)
    if m.other_fields.numel():
        parts.append(emb.index_select(1, m.other_fields).reshape(emb.shape[0], -1))
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

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        pooled = (masked_sum_pool(beh, mask), m.attn(cand, beh, mask))
        h = _tower_input(m, batch, (cand, *pooled), emb)
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

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        final, aux = interest(m, cand, beh, mask)
        h = _tower_input(m, batch, (cand, final), emb)
        return m.mlp(h, train)[:, 0], {"aux_loss": aux_weight * aux, "emb_l2": l2}

    model = stateless("DIEN", fs, parts, fwd)
    model.add_helper("interest", interest)
    return model


def BST(fs: FeatureSet,
        candidate: Tuple[str, ...] = ("item", "cate"),
        behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
        n_blocks: int = 1,
        num_heads: int = 2,
        hidden: Tuple[int, ...] = (200, 80),
        attention: str = "softmax") -> Model:
    """Behavior Sequence Transformer: the candidate appended as the last
    position, sin/cos positions added, ``n_blocks`` transformer blocks
    (``block{i}``), masked mean pool → ReLU MLP with LayerNorm.
    ``attention='lsh'`` takes Reformer's LSH attention in the blocks."""
    d, kd, n_other = _beh_dims(fs, candidate)
    in_dim = kd + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "mlp": MLP(in_dim, hidden, activation="relu", norm="layer", out_dim=1)}
    for i in range(n_blocks):
        parts[f"block{i}"] = TransformerBlock(kd, num_heads, ffn_hidden=(4 * kd,),
                                              attention=attention)

    parts["other_fields"] = _other_fields(fs, candidate)
    # the encodings of the spec's longest history and the candidate, kept on
    # the model's device (a step that copied them from the host could not be
    # captured); a shorter history takes their first rows
    parts["positions"] = sincos_position_encoding(fs.seq_spec(behavior[0]).max_len + 1, kd)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        seq = torch.cat([beh, cand[:, None, :]], dim=1)             # (B, L+1, kd)
        full_mask = torch.cat([mask, mask.new_ones((mask.shape[0], 1))], dim=1)
        if seq.shape[1] > m.positions.shape[0]:
            raise ValueError(f"BST: a history of {seq.shape[1] - 1} past the spec's "
                             f"max_len {m.positions.shape[0] - 1}")
        seq = seq + m.positions[:seq.shape[1]][None]
        for i in range(n_blocks):
            seq = getattr(m, f"block{i}")(seq, mask=full_mask)
        pooled = masked_mean_pool(seq, full_mask)
        h = _tower_input(m, batch, (pooled,), emb)
        return m.mlp(h, train)[:, 0], {"emb_l2": l2}

    return stateless("BST", fs, parts, fwd)


def DSIN(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         session_shape: Optional[Tuple[int, int]] = None,
         num_heads: int = 2,
         lstm_hidden: Optional[int] = None,
         hidden: Tuple[int, ...] = (200, 80)) -> Model:
    """Deep Session Interest Network: the history as S sessions of Ls steps
    (``session_shape``, else the sequence spec's, else (4, L // 4)) plus a
    learned bias (``bias``), per-session self-attention (``mha``) mean-pooled
    into one interest a session (a fully padded session attends over all
    its keys, then its interest is zeroed), a BiLSTM across sessions, two
    target attentions (over the interests, ``attn_i``, and over the LSTM
    states, ``attn_l``, whose candidate passes ``align`` when 2·H ≠ kd)
    → PReLU MLP with LayerNorm."""
    d, kd, n_other = _beh_dims(fs, candidate)
    spec = fs.seq_spec(behavior[0])
    L = spec.max_len
    S, Ls = session_shape or spec.session_shape or (4, L // 4)
    if S * Ls != L:
        raise ValueError(f"session shape {S}x{Ls} != max_len {L}")
    H = lstm_hidden or kd // 2
    in_dim = kd * 2 + 2 * H + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "bias": SessionPositionBias(S, Ls, kd),
             "mha": MultiHeadAttention(kd, num_heads),
             "bilstm": BiLSTM(kd, H),
             "attn_i": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "attn_l": TargetAttention(2 * H, (36, 1), activation="sigmoid"),
             "mlp": MLP(in_dim, hidden, activation="prelu", norm="layer", out_dim=1)}
    if 2 * H != kd:
        parts["align"] = Dense(kd, 2 * H)

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        b = beh.shape[0]
        sess = m.bias(beh.reshape(b, S, Ls, kd)).reshape(b * S, Ls, kd)
        sess_mask = mask.reshape(b * S, Ls)
        any_valid = sess_mask.any(dim=1)
        safe_mask = sess_mask | ~any_valid[:, None]
        interests = masked_mean_pool(m.mha(sess, mask=safe_mask), safe_mask)
        interests = (interests * any_valid[:, None]).reshape(b, S, kd)
        sess_valid = mask.reshape(b, S, Ls).any(dim=2)
        lstm_out = m.bilstm(interests, sess_valid)
        cand_l = cand if 2 * H == kd else m.align(cand)
        pooled_i = m.attn_i(cand, interests, sess_valid)
        pooled_l = m.attn_l(cand_l, lstm_out, sess_valid)
        h = _tower_input(m, batch, (cand, pooled_i, pooled_l), emb)
        return m.mlp(h, train)[:, 0], {"emb_l2": l2}

    return stateless("DSIN", fs, parts, fwd)


def SeqFM(fs: FeatureSet,
          candidate: Tuple[str, ...] = ("item", "cate"),
          behavior: Tuple[str, ...] = ("hist_item",),
          num_heads: int = 2,
          ffn_hidden: Tuple[int, ...] = (32,)) -> Model:
    """Sequence-aware FM: three attention views, each mean-pooled over its
    positions and passed through one shared ReLU FFN (``ffn``): ``static``
    (self-attention over the sparse fields), ``dynamic`` (causal
    self-attention over the behaviors) and ``cross`` (over fields and
    behaviors, an extra bias allowing only field↔behavior pairs); their
    concatenation (with dense) → ``head``, plus the scalar ``bias`` and the
    fields' linear term. ``candidate`` is not read, as in the reference."""
    d, f = fs.embed_dim, len(fs.sparse)
    L = fs.seq_spec(behavior[0]).max_len
    parts = {"embedding": FusedEmbedding(fs, with_linear=True),
             "static": MultiHeadAttention(d, num_heads, use_res=False),
             "dynamic": MultiHeadAttention(d, num_heads, use_res=False, causal=True),
             "cross": MultiHeadAttention(d, num_heads, use_res=False),
             "ffn": MLP(d, ffn_hidden, activation="relu"),
             "head": Dense(3 * ffn_hidden[-1] + len(fs.dense), 1),
             "bias": nn.Parameter(torch.zeros(()))}

    def fwd(m, batch, train):
        fe = m.embedding
        emb = fe.sparse(batch["sparse"])                               # (B, F, D)
        seq_e, mask = fe.seq(behavior[0], batch["seq"][behavior[0]])
        l2 = fe.l2_from_sparse(emb) + fe.l2_from_seq(behavior[0], seq_e)
        b = emb.shape[0]
        v_static = m.static(emb).mean(dim=1)
        v_dyn = masked_mean_pool(m.dynamic(seq_e, mask=mask), mask)
        both = torch.cat([emb, seq_e], dim=1)                          # (B, F+L, D)
        is_static = torch.cat([mask.new_ones((b, f)), mask.new_zeros((b, L))], dim=1)
        valid = torch.cat([mask.new_ones((b, f)), mask], dim=1)
        cross_ok = is_static[:, :, None] ^ is_static[:, None, :]
        bias_q = torch.where(cross_ok & valid[:, None, :], 0.0, NEG_INF)
        v_cross = masked_mean_pool(m.cross(both, extra_bias=bias_q), valid)
        views = [m.ffn(v) for v in (v_static, v_dyn, v_cross)]
        h = torch.cat(views + ([batch["dense"]] if len(fs.dense) else []), dim=-1)
        logit = m.head(h)[:, 0] + m.bias
        return logit + fe.sparse_linear(batch["sparse"]).sum(dim=1), {"emb_l2": l2}

    return stateless("SeqFM", fs, parts, fwd)


def DSTN(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         aux_sets: Tuple[Tuple[str, ...], ...] = (("hist_item", "hist_cate"),),
         hidden: Tuple[int, ...] = (200, 80),
         activation: str = "prelu") -> Model:
    """Deep Spatio-Temporal Network, interaction-attention variant: each
    auxiliary set of sequences is pooled by a target attention on the
    candidate (``attn{i}``) and by a plain masked sum; [candidate, those
    pools, other fields, dense] → MLP with LayerNorm. ``emb_l2`` counts the
    sparse rows once and each set's sequences."""
    d, kd, n_other = _beh_dims(fs, candidate)
    in_dim = kd + len(aux_sets) * 2 * kd + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "mlp": MLP(in_dim, hidden, activation=activation, norm="layer",
                        out_dim=1)}
    for i in range(len(aux_sets)):
        parts[f"attn{i}"] = TargetAttention(kd, (36, 1), activation="sigmoid")

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        pools, l2_total = [], None
        for i, names in enumerate(aux_sets):
            cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                       candidate, names)
            pools += [getattr(m, f"attn{i}")(cand, beh, mask),
                      masked_sum_pool(beh, mask)]
            l2_total = (l2 if l2_total is None
                        else l2_total + l2 - m.embedding.l2_from_sparse(emb))
        h = _tower_input(m, batch, (cand, *pools), emb)
        return m.mlp(h, train)[:, 0], {"emb_l2": l2_total}

    return stateless("DSTN", fs, parts, fwd)


def DMIN(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         num_interests: int = 2,
         hidden: Tuple[int, ...] = (200, 80),
         activation: str = "prelu",
         aux_weight: float = 1.0) -> Model:
    """Deep Multi-Interest Network: a behavior refiner (``refiner``, 2-head
    self-attention over the history, a fully padded row attending over all
    its keys) trained by DIEN's auxiliary loss (``aux``) to retrieve the
    next behavior; a multi-interest extractor whose ``num_interests`` heads
    of width kd (``extractor``'s q, k and v; its ``o`` and ``ln`` are never
    read, ``ROADMAP.md`` R6) stay apart, each plus the refined state and a
    learned position bias (``pos``, normal(0.02)) pooled by its own target
    attention (``attn{k}``); [candidate, interests…, other fields, dense]
    → MLP with LayerNorm."""
    d, kd, n_other = _beh_dims(fs, candidate)
    L = fs.seq_spec(behavior[0]).max_len
    K = num_interests
    in_dim = kd * (1 + K) + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "refiner": MultiHeadAttention(kd, num_heads=2),
             "extractor": MultiHeadAttention(kd, num_heads=K, head_dim=kd),
             "aux": MLP(2 * kd, (100, 50), activation="sigmoid", out_dim=1),
             "pos": nn.Parameter(torch.empty(L, kd)),
             "mlp": MLP(in_dim, hidden, activation=activation, norm="layer",
                        out_dim=1)}
    for k in range(K):
        parts[f"attn{k}"] = TargetAttention(kd, (36, 1), activation="sigmoid")
    inits = {"pos": lambda g: normal_init((L, kd), g, stddev=0.02)}

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        b = beh.shape[0]
        any_valid = mask.any(dim=1)
        safe_mask = mask | ~any_valid[:, None]
        z = m.refiner(beh, mask=safe_mask)                              # (B, L, kd)
        aux = _auxiliary_loss(m.aux, z, beh, mask)
        ex = m.extractor
        q, kk, v = (bf16_matmul(z, w).reshape(b, L, K, kd) for w in (ex.q, ex.k, ex.v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(kd)
        logits = logits + torch.where(safe_mask, 0.0, NEG_INF)[:, None, None, :]
        heads = torch.einsum("bhqk,bkhd->bhqd", torch.softmax(logits, dim=-1), v)
        heads = heads + z[:, None, :, :] + m.pos[None, None]           # (B, K, L, kd)
        interests = [getattr(m, f"attn{k}")(cand, heads[:, k], mask) for k in range(K)]
        h = _tower_input(m, batch, (cand, *interests), emb)
        return m.mlp(h, train)[:, 0], {"aux_loss": aux_weight * aux, "emb_l2": l2}

    return stateless("DMIN", fs, parts, fwd, inits)


def _squash(s: torch.Tensor) -> torch.Tensor:
    n2 = s.square().sum(dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


def MIND(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         num_interests: int = 4,
         routing_iters: int = 3,
         label_pow: float = 2.0,
         hidden: Tuple[int, ...] = (200, 80),
         activation: str = "prelu") -> Model:
    """Multi-Interest Network with Dynamic routing: behaviors through one
    shared ``bilinear`` (kd, kd) map, ``routing_iters`` rounds of
    behavior-to-interest capsule routing from the random logits ``b0``
    (K, L), a label-aware attention read of the capsules (softmax of
    ``label_pow``·⟨v_k, cand⟩) → MLP with LayerNorm. As in the reference
    the routing logits, ``b0`` and every round's behaviors but the last are
    detached, so ``b0`` gets no gradient and stays as drawn.
    ``model.interests(batch)`` returns the capsules (B, K, kd) that a recall
    index would serve."""
    d, kd, n_other = _beh_dims(fs, candidate)
    L = fs.seq_spec(behavior[0]).max_len
    K = num_interests
    in_dim = kd * 2 + n_other * d + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "bilinear": nn.Parameter(torch.empty(kd, kd)),
             "b0": nn.Parameter(torch.empty(K, L)),
             "mlp": MLP(in_dim, hidden, activation=activation, norm="layer",
                        out_dim=1)}
    inits = {"bilinear": lambda g: glorot_uniform((kd, kd), g),
             "b0": lambda g: normal_init((K, L), g, stddev=1.0)}

    def route(m, beh, mask, detach: bool):
        """The capsules (B, K, kd) after ``routing_iters`` rounds."""
        mb = bf16_matmul(beh, m.bilinear)                               # (B, L, kd)
        fixed = mb.detach() if detach else mb
        b0 = m.b0.detach() if detach else m.b0
        logits_b = b0.expand(beh.shape[0], K, L)
        key_mask = torch.where(mask, 0.0, NEG_INF)[:, None, :]
        v = None
        for it in range(routing_iters):
            last = it == routing_iters - 1
            w = torch.softmax(logits_b + key_mask, dim=1) * mask[:, None, :]
            v = _squash(torch.einsum("bkl,bld->bkd", w, mb if last else fixed))
            if not last:
                agree = torch.einsum("bkd,bld->bkl", v, fixed)
                logits_b = logits_b + (agree.detach() if detach else agree)
        return v

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch,
                                                   candidate, behavior)
        v = route(m, beh, mask, detach=True)
        att = torch.softmax(label_pow * torch.einsum("bkd,bd->bk", v, cand), dim=-1)
        read = torch.einsum("bk,bkd->bd", att, v)
        h = _tower_input(m, batch, (cand, read), emb)
        return m.mlp(h, train)[:, 0], {"emb_l2": l2}

    def interests(m, batch):
        batch = as_tensors(batch, m.bilinear.device)
        _, beh, mask, _, _ = behavior_inputs(m.embedding, batch, candidate, behavior)
        return route(m, beh, mask, detach=False)

    model = stateless("MIND", fs, parts, fwd, inits)
    model.add_helper("interests", interests)
    return model
