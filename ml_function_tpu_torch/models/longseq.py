"""Long-sequence models of the port: DTS, MIMN, SIM and HPMN.

Counterpart of ``ml_function_tpu/models/longseq.py``. Submodules carry the
JAX pytree's keys (SIM's ``dien``, the whole DIEN model whose embedding
table the SIM shares, ``mha``, ``attn``, ``mlp`` and the optional
``align_long``; HPMN's ``cells``, a list, which the bridge walks by index;
MIMN's ``ctrl``, ``miu``, ``key_r``, … ``mem0``, ``ch0``), so the bridge
copies JAX weights as they are.

DTS, MIMN and HPMN are step loops over the history, as the reference's
``lax.scan``s are: MIMN's controller and HPMN's layers call ``GRU._step``
themselves, so none of them reaches the (AU)GRU kernel; their sequence
lookups take the merge-scatter kernel under ``ML_FUNCTION_TPU_MERGE_SCATTER``.

The exact search unit's ``MultiHeadAttention`` takes the flash-attention
kernel at a key length of 512 or more (hard search over a raw lifelong
stream); the DIEN core takes the (AU)GRU kernel when ``kernel = 'pallas'`` is
set on ``model.dien.gru1`` and ``model.dien.gru2``, as for DIEN.

``esu_attention='lsh'`` makes the exact search unit an
``LSHSelfAttention``. Under a RowTape (the sparse-row path) soft search
scores and selects from the whole stream's looked-up rows, as the
reference does there, since a lookup's ids may depend on the batch alone.
Under a sharding context with ``seq_shard`` and a model group above 1, soft
search runs with the long key axis sharded over ``model``
(``parallel/longseq.py``), and the selected ids are looked up as on the
unsharded route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..features.schema import FeatureSet
from ..ops.attention import LSHSelfAttention, MultiHeadAttention, TargetAttention
from ..ops.base import bf16_matmul, normal_init
from ..ops.core import MLP, Dense
from ..ops.embedding import FusedEmbedding, active_row_tape
from ..ops.recurrent import GRU
from .base import Model, behavior_inputs, stateless
from .sequence import DIEN, _beh_dims, _other_fields, _tower_input


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
             "mha": (LSHSelfAttention(kd, num_heads) if esu_attention == "lsh"
                     else MultiHeadAttention(kd, num_heads)),
             "attn": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "mlp": MLP(kd * 3 + n_other * d + len(fs.dense), hidden,
                        activation="prelu", norm="layer", out_dim=1)}
    if kd_long != kd:
        parts["align_long"] = Dense(kd_long, kd)
    cand_cols = [fs.sparse_index(n) for n in candidate]

    def seq_shard_mesh():
        """The active mesh when the sequence-sharded search applies: soft
        search, no RowTape, ``seq_shard`` and a model group above 1."""
        from ..parallel import context as pctx
        if (search == "soft" and active_row_tape() is None
                and pctx.seq_shard_active() and pctx.model_axis_size() > 1):
            return pctx.active_mesh()
        return None

    def soft_search(fe, batch):
        """The scoring pass without a gradient, the top k, then a
        differentiable lookup of the selected ids only: (cand, reduced,
        red_mask, l2_long, emb). The full-stream lookup keeps nothing for
        backward, and the table's gradient covers B·k rows. Under the
        sequence-sharded context the scoring pass runs sharded."""
        emb = fe.sparse(batch["sparse"])
        cand = torch.cat([emb[:, c, :] for c in cand_cols], dim=-1)
        cand_long = torch.cat([emb[:, c, :] for c in long_score_cols], dim=-1).detach()
        mesh = seq_shard_mesh()
        if mesh is not None:
            from ..parallel import context as pctx
            from ..parallel.longseq import seq_sharded_soft_search
            k = min(top_k, fs.seq_spec(long_behavior[0]).max_len)
            top_i, _ = seq_sharded_soft_search(
                mesh, fs, long_behavior, k, fe.table, batch["seq"], cand_long,
                capacity=pctx.exchange_capacity(), compress=pctx.exchange_compress())
        else:
            with torch.no_grad():
                rows, long_mask = [], None
                for n in long_behavior:
                    e, m = fe.seq(n, batch["seq"][n])
                    rows.append(e)
                    long_mask = m if long_mask is None else long_mask | m
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

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        fe = m.dien.embedding
        if search == "soft" and active_row_tape() is None:
            cand, reduced, red_mask, l2_long, emb = soft_search(fe, batch)
        else:   # hard search (applied in data preparation), or under a RowTape
            cand, reduced, red_mask, l2_long, emb = behavior_inputs(
                fe, batch, candidate, long_behavior)
            if search == "soft":
                cand_long = torch.cat([emb[:, c, :] for c in long_score_cols], dim=-1)
                scores = torch.einsum("bld,bd->bl", reduced, cand_long)
                top_i = top_k_indices(torch.where(red_mask, scores, -torch.inf),
                                      min(top_k, scores.shape[1]))
                reduced = torch.gather(
                    reduced, 1, top_i[..., None].expand(-1, -1, reduced.shape[-1]))
                red_mask = torch.gather(red_mask, 1, top_i)
        if kd_long != kd:
            reduced = m.align_long(reduced)
        any_valid = red_mask.any(dim=1)
        safe_mask = red_mask | ~any_valid[:, None]
        esu = m.mha(reduced, mask=safe_mask)
        long_term = m.attn(cand, esu, safe_mask) * any_valid[:, None]
        s_cand, s_beh, s_mask, l2_short, _ = behavior_inputs(fe, batch, candidate,
                                                             behavior)
        short_term, aux = m.dien.interest(s_cand, s_beh, s_mask)
        h = _tower_input(m, batch, (cand, long_term, short_term), emb)
        # both lookups count the sparse fields' l2: subtract one
        l2 = l2_long + l2_short - fe.l2_from_sparse(emb)
        return m.mlp(h, train)[:, 0], {"aux_loss": aux_weight * aux, "emb_l2": l2}

    return stateless("SIM", fs, parts, fwd)


def DTS(fs: FeatureSet,
        candidate: Tuple[str, ...] = ("item", "cate"),
        behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
        latent_dim: int = 0,
        hidden: Tuple[int, ...] = (200, 80),
        guide_weight: float = 1.0) -> Model:
    """Deep Time-Stream: a latent state z (from ``z0``) takes an Euler step
    z + Δt·f(z, e_t, Δt) a valid behavior, f the tanh ``dyn`` MLP (padded
    steps hold z); ``dec`` decodes each z_t into the behavior space, a guide
    loss pulls it toward behavior t+1 against the batch rolled by one row,
    and a target attention over the decoded stream feeds the PReLU MLP with
    LayerNorm. Δt is ``batch['seq'][behavior[0] + '_time']`` where the batch
    carries it, else 1."""
    d, kd, n_other = _beh_dims(fs, candidate)
    z_dim = latent_dim or kd
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "dyn": MLP(z_dim + kd + 1, (z_dim,), activation="tanh"),
             "dec": Dense(z_dim, kd),
             "attn": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "mlp": MLP(kd * 2 + n_other * d + len(fs.dense), hidden,
                        activation="prelu", norm="layer", out_dim=1),
             "z0": nn.Parameter(torch.empty(z_dim))}
    inits = {"z0": lambda g: normal_init((z_dim,), g, stddev=0.05)}
    tkey = behavior[0] + "_time"

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch, candidate,
                                                   behavior)
        b, L = mask.shape
        seq = batch.get("seq", {})
        dt = seq[tkey].float() if tkey in seq else beh.new_ones((b, L))
        z, zs = m.z0.expand(b, z_dim), []
        for t in range(L):
            dz = m.dyn(torch.cat([z, beh[:, t], dt[:, t, None]], dim=-1))
            z = torch.where(mask[:, t, None], z + dt[:, t, None] * dz, z)
            zs.append(z)
        decoded = m.dec(torch.stack(zs, dim=1))                       # (B, L, kd)
        # the guide loss: decoded_t should retrieve behavior t+1
        pred, target = decoded[:, :-1], beh[:, 1:]
        neg = torch.roll(beh, 1, 0)[:, 1:]
        valid = (mask[:, 1:] & mask[:, :-1]).float()
        ll = (F.logsigmoid((pred * target).sum(dim=-1))
              + F.logsigmoid(-(pred * neg).sum(dim=-1)))
        guide = -(ll * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
        h = _tower_input(m, batch, (cand, m.attn(cand, decoded, mask)), emb)
        return m.mlp(h, train)[:, 0], {"guide_loss": guide_weight * guide, "emb_l2": l2}

    return stateless("DTS", fs, parts, fwd, inits)


def _address(key: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """MIMN's content addressing: the softmax over slots of softplus(β) ×
    the cosine of the key (B, D) with each memory slot (B, M, D) → (B, M).
    At a zero key PyTorch's norm has a finite gradient where JAX's is NaN
    (``ROADMAP.md`` R8)."""
    kn = key / (torch.linalg.vector_norm(key, dim=-1, keepdim=True) + 1e-8)
    mn = mem / (torch.linalg.vector_norm(mem, dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("bd,bmd->bm", kn, mn)
    return torch.softmax(F.softplus(beta)[:, None] * sim, dim=-1)


def MIMN(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         memory_slots: int = 4,
         channels: int = 4,
         hidden: Tuple[int, ...] = (200, 80),
         reg_weight: float = 0.1) -> Model:
    """Multi-channel user Interest Memory Network. Each step: the
    controller ``ctrl`` (a GRU step over [e_t, read_{t−1}]), cosine
    addressing of the memory (``key_r``, ``key_w``, ``beta``), the NTM read
    and the erase/add write (``erase``, ``add``), and the MIU channel update
    (the ``miu`` GRU cell inlined over the (B, channels, kd) channels, gated
    by a softmax of the behavior against each channel). Padded steps carry
    the memory, the channels, the read and the write mass (the controller's
    own mask holds h). ``util_reg`` is ``reg_weight`` × the mean squared
    deviation of the normalised write mass from 1/M; target attention over
    the slots (``attn_mem``) and the channels (``attn_ch``), with the
    candidate and the controller state, feed the PReLU MLP with LayerNorm.
    ``mem0`` (M, kd) and ``ch0`` (channels, kd) start every row."""
    d, kd, n_other = _beh_dims(fs, candidate)
    H, M = kd, memory_slots
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "ctrl": GRU(2 * kd, H), "miu": GRU(kd, kd),
             "key_r": Dense(H, kd), "key_w": Dense(H, kd), "beta": Dense(H, 2),
             "erase": Dense(H, kd), "add": Dense(H, kd),
             "mem0": nn.Parameter(torch.empty(M, kd)),
             "ch0": nn.Parameter(torch.empty(channels, kd)),
             "attn_mem": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "attn_ch": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "mlp": MLP(kd * 3 + H + n_other * d + len(fs.dense), hidden,
                        activation="prelu", norm="layer", out_dim=1)}
    inits = {"mem0": lambda g: normal_init((M, kd), g, stddev=0.05),
             "ch0": lambda g: normal_init((channels, kd), g, stddev=0.05)}

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch, candidate,
                                                   behavior)
        b, L = mask.shape
        ctrl, miu = m.ctrl, m.miu
        mem, ch = m.mem0.expand(b, M, kd), m.ch0.expand(b, channels, kd)
        h, r, wsum = beh.new_zeros((b, H)), beh.new_zeros((b, kd)), beh.new_zeros((b, M))
        for t in range(L):
            e_t, m_t = beh[:, t], mask[:, t]
            xw = bf16_matmul(torch.cat([e_t, r], dim=-1), ctrl.wx) + ctrl.b
            h = ctrl._step(h, xw, m_t)
            betas = m.beta(h)
            w_r = _address(m.key_r(h), mem, betas[:, 0])
            w_w = _address(m.key_w(h), mem, betas[:, 1])
            r_new = torch.einsum("bm,bmd->bd", w_r, mem)
            erase, add = torch.sigmoid(m.erase(h)), torch.tanh(m.add(h))
            mem_new = (mem * (1.0 - w_w[..., None] * erase[:, None, :])
                       + w_w[..., None] * add[:, None, :])
            # the MIU: the GRU cell on (B, channels, kd), gated per channel
            ch_w = torch.softmax(torch.einsum("bd,bcd->bc", e_t, ch), dim=-1)
            xu, xr, xn = (bf16_matmul(e_t, miu.wx) + miu.b)[:, None, :].chunk(3, dim=-1)
            hu, hr, hn = bf16_matmul(ch, miu.wh).chunk(3, dim=-1)
            u_g, r_g = torch.sigmoid(xu + hu), torch.sigmoid(xr + hr)
            ch_upd = (1.0 - u_g) * ch + u_g * torch.tanh(xn + r_g * hn)
            ch_new = ch + ch_w[..., None] * (ch_upd - ch)
            keep = m_t[:, None]
            mem = torch.where(keep[..., None], mem_new, mem)
            ch = torch.where(keep[..., None], ch_new, ch)
            r = torch.where(keep, r_new, r)
            wsum = torch.where(keep, wsum + w_w, wsum)
        # write balance: the normalised write mass's deviation from uniform
        wnorm = wsum / torch.clamp_min(wsum.sum(dim=-1, keepdim=True), 1e-6)
        reg = (wnorm - 1.0 / M).square().sum(dim=-1).mean()
        mem_read = m.attn_mem(cand, mem, mask.new_ones((b, M)))
        ch_read = m.attn_ch(cand, ch, mask.new_ones((b, channels)))
        x = _tower_input(m, batch, (cand, mem_read, ch_read, h), emb)
        return m.mlp(x, train)[:, 0], {"util_reg": reg_weight * reg, "emb_l2": l2}

    return stateless("MIMN", fs, parts, fwd, inits)


def HPMN(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         layers: int = 3,
         hidden: Tuple[int, ...] = (200, 80),
         cov_weight: float = 0.1) -> Model:
    """Hierarchical Periodic Memory Network: ``layers`` GRU memory slots
    (``cells``, a list: ``cells.0`` GRU(kd, kd) over the behaviors, the
    others GRU(kd, kd) over the new state of the layer below), starting
    from ``m0`` (layers, kd). Layer l ticks at a valid step whose valid-step
    count is a multiple of 2^l; layer 0's input projections are one product
    over (B·L, kd). The final states are the user memory, read by target
    attention (``attn``) into the PReLU MLP with LayerNorm; ``cov_reg`` is
    ``cov_weight`` × the mean squared off-diagonal covariance of the
    slots."""
    d, kd, n_other = _beh_dims(fs, candidate)
    H = kd
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "cells": nn.ModuleList([GRU(kd if l == 0 else H, H) for l in range(layers)]),
             "m0": nn.Parameter(torch.empty(layers, H)),
             "attn": TargetAttention(kd, (36, 1), activation="sigmoid"),
             "mlp": MLP(kd * 2 + n_other * d + len(fs.dense), hidden,
                        activation="prelu", norm="layer", out_dim=1)}
    inits = {"m0": lambda g: normal_init((layers, H), g, stddev=0.05)}

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch, candidate,
                                                   behavior)
        b, L = mask.shape
        cells = m.cells
        xw0 = (bf16_matmul(beh.reshape(b * L, kd), cells[0].wx)
               + cells[0].b).reshape(b, L, 3 * H)
        states = [m.m0[l].expand(b, H) for l in range(layers)]
        count = torch.zeros(b, dtype=torch.int64, device=mask.device)
        for t in range(L):
            m_t = mask[:, t]
            count = count + m_t
            below = None
            for l in range(layers):
                tick = m_t & (count % 2 ** l == 0)
                xw = (xw0[:, t] if l == 0
                      else bf16_matmul(below, cells[l].wx) + cells[l].b)
                states[l] = below = cells[l]._step(states[l], xw, tick)
        mem = torch.stack(states, dim=1)                               # (B, layers, H)
        mbar = mem - mem.mean(dim=1, keepdim=True)
        cov = torch.einsum("bld,bkd->blk", mbar, mbar) / H
        off = cov * (1.0 - torch.eye(layers, device=mem.device))
        cov_reg = off.square().sum(dim=(1, 2)).mean()
        read = m.attn(cand, mem, mask.new_ones((b, layers)))
        x = _tower_input(m, batch, (cand, read), emb)
        return m.mlp(x, train)[:, 0], {"cov_reg": cov_weight * cov_reg, "emb_l2": l2}

    return stateless("HPMN", fs, parts, fwd, inits)
