"""Match models of the port: DSSM and DeepMCP.

Counterpart of ``ml_function_tpu/models/match.py``. Submodules carry the JAX
pytree's keys (``embedding``, ``u_mlp``, ``i_mlp``; DeepMCP's ``pred``,
``a_mlp``, ``h_mlp`` and ``bias``), so the bridge copies JAX weights as they
are. Both read each sparse row once; the reference looks the same rows up
again for each tower and for ``emb_l2``, which gives the same values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..features.schema import FeatureSet
from ..ops.base import zeros
from ..ops.core import MLP
from ..ops.embedding import FusedEmbedding, masked_mean_pool
from ..train.metrics import bce_with_logits
from .base import Model, as_tensors, stateless


def _has_dense(batch) -> bool:
    return batch.get("dense") is not None and batch["dense"].shape[-1] > 0


def _unit(x: torch.Tensor) -> torch.Tensor:
    """x / (‖x‖ + 1e-9). At x = 0 the norm's gradient is finite here (0),
    where JAX's is NaN (``ROADMAP.md`` R9)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


def DSSM(fs: FeatureSet,
         user_fields: Optional[Tuple[str, ...]] = None,
         item_fields: Tuple[str, ...] = ("item", "cate"),
         behavior: Optional[Tuple[str, ...]] = None,
         hidden: Tuple[int, ...] = (256, 128, 64),
         temperature: float = 0.05) -> Model:
    """Two-tower DSSM: the user tower over [user fields, mean-pooled
    histories, dense] and the item tower over the item fields, each an MLP
    with LayerNorm to a unit vector; logit ⟨u, i⟩ / ``temperature``.
    ``model.user_vec(batch)``, ``model.item_vec(batch)`` give the towers'
    vectors and ``model.in_batch_softmax_loss(batch)`` the retrieval
    objective with the batch's other items as negatives."""
    if user_fields is None:
        user_fields = tuple(s.name for s in fs.sparse if s.name not in item_fields)
    if behavior is None:
        behavior = tuple(s.name for s in fs.seq)
    d = fs.embed_dim
    u_in = len(user_fields) * d + len(behavior) * d + len(fs.dense)
    i_in = len(item_fields) * d
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "u_mlp": MLP(u_in, hidden[:-1], activation="relu", norm="layer",
                          out_dim=hidden[-1]),
             "i_mlp": MLP(i_in, hidden[:-1], activation="relu", norm="layer",
                          out_dim=hidden[-1])}
    u_cols = [fs.sparse_index(n) for n in user_fields]
    i_cols = [fs.sparse_index(n) for n in item_fields]

    def users(m, batch, emb):
        parts = [emb[:, c, :] for c in u_cols]
        for name in behavior:
            parts.append(masked_mean_pool(*m.embedding.seq(name, batch["seq"][name])))
        if _has_dense(batch):
            parts.append(batch["dense"])
        return _unit(m.u_mlp(torch.cat(parts, dim=-1)))

    def items(m, emb):
        return _unit(m.i_mlp(torch.cat([emb[:, c, :] for c in i_cols], dim=-1)))

    def towers(m, batch):
        batch = as_tensors(batch, next(m.parameters()).device)
        emb = m.embedding.sparse(batch["sparse"])
        return users(m, batch, emb), items(m, emb), emb

    def fwd(m, batch, train):
        u, v, emb = towers(m, batch)
        return (u * v).sum(dim=-1) / temperature, {"emb_l2": m.embedding.l2_from_sparse(emb)}

    def in_batch_softmax_loss(m, batch):
        """Every positive (u_b, i_b) against the batch's other items as
        sampled negatives (sampled-softmax cross-entropy)."""
        u, v, _ = towers(m, batch)
        return -torch.diagonal(F.log_softmax((u @ v.T) / temperature, dim=-1)).mean()

    model = stateless("DSSM", fs, parts, fwd)
    model.add_helper("user_vec", lambda m, batch: towers(m, batch)[0])
    model.add_helper("item_vec", lambda m, batch: towers(m, batch)[1])
    model.add_helper("in_batch_softmax_loss", in_batch_softmax_loss)
    return model


def DeepMCP(fs: FeatureSet,
            ad_fields: Tuple[str, ...] = ("item", "cate"),
            user_fields: Optional[Tuple[str, ...]] = None,
            corr_seq: Optional[str] = None,
            hidden: Tuple[int, ...] = (256, 128, 64),
            match_hidden: Tuple[int, ...] = (128,),
            match_dim: int = 64,
            corr_hidden: Tuple[int, ...] = (64,),
            alpha: float = 0.1, beta: float = 0.01,
            context: int = 2, negatives: int = 2) -> Model:
    """DeepMCP: the prediction subnet (an MLP over every field's row, the
    mean-pooled histories and dense, plus ``bias``) gives the logit; in
    train mode, with a ``label`` in the batch, ``aux`` carries the matching
    subnet's BCE on ⟨tanh u_mlp(user), tanh a_mlp(ad)⟩ (``match``, weight
    ``alpha``) and the correlation subnet's skip-gram over ``corr_seq``
    (``corr``, weight ``beta``): pairs within ``context`` steps against
    ``negatives`` batch-rolled negatives each."""
    if user_fields is None:
        user_fields = tuple(s.name for s in fs.sparse if s.name not in ad_fields)
    if corr_seq is None and fs.seq:
        corr_seq = fs.seq[0].name
    d, nd, f = fs.embed_dim, len(fs.dense), len(fs.sparse)
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "pred": MLP(f * d + len(fs.seq) * d + nd, hidden, activation="relu",
                         out_dim=1),
             "u_mlp": MLP(len(user_fields) * d + nd, match_hidden, activation="relu",
                          out_dim=match_dim),
             "a_mlp": MLP(len(ad_fields) * d, match_hidden, activation="relu",
                          out_dim=match_dim),
             "h_mlp": MLP(d, corr_hidden, activation="relu", out_dim=match_dim),
             "bias": nn.Parameter(zeros(()))}
    u_cols = [fs.sparse_index(n) for n in user_fields]
    a_cols = [fs.sparse_index(n) for n in ad_fields]

    def correlation(m, e, seq_mask):
        h = torch.tanh(m.h_mlp(e))                          # (B, L, M)
        mask = seq_mask.to(h.dtype)
        total, n_pairs = h.new_zeros(()), h.new_zeros(())
        for j in range(1, context + 1):
            hi, hj = h[:, :-j], h[:, j:]
            valid = mask[:, :-j] * mask[:, j:]
            total = total + (F.logsigmoid((hi * hj).sum(dim=-1)) * valid).sum()
            for q in range(1, negatives + 1):
                neg = torch.roll(hj, q, 0)
                nv = valid * torch.roll(mask[:, j:], q, 0)
                total = total + (F.logsigmoid(-(hi * neg).sum(dim=-1)) * nv).sum()
            n_pairs = n_pairs + valid.sum()
        return beta * (-total / torch.clamp_min(n_pairs, 1.0))

    def fwd(m, batch, train):
        emb = m.embedding.sparse(batch["sparse"])          # (B, F, D)
        parts = [emb.reshape(emb.shape[0], -1)]
        seqs = {}
        for s in fs.seq:
            seqs[s.name] = m.embedding.seq(s.name, batch["seq"][s.name])
            parts.append(masked_mean_pool(*seqs[s.name]))
        if _has_dense(batch):
            parts.append(batch["dense"])
        logit = m.pred(torch.cat(parts, dim=-1))[:, 0] + m.bias
        aux = {"emb_l2": m.embedding.l2_from_sparse(emb)}
        if train and "label" in batch:
            u_in = [emb[:, c, :] for c in u_cols] + ([batch["dense"]] if nd else [])
            v_u = torch.tanh(m.u_mlp(torch.cat(u_in, dim=-1)))
            v_a = torch.tanh(m.a_mlp(torch.cat([emb[:, c, :] for c in a_cols], dim=-1)))
            m_logit = (v_u * v_a).sum(dim=-1)
            aux["match"] = alpha * bce_with_logits(m_logit, batch["label"]).mean()
            if corr_seq is not None:
                aux["corr"] = correlation(m, *seqs[corr_seq])
        return logit, aux

    return stateless("DeepMCP", fs, parts, fwd)
