"""Feature-interaction models of the port: DeepFM, xDeepFM and AutoInt.

Counterpart of ``ml_function_tpu/models/interaction.py``; the other models of
that file come with later slices.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.attention import MultiHeadAttention
from ..ops.base import zeros
from ..ops.core import MLP, Dense, flatten_concat
from ..ops.embedding import FusedEmbedding
from ..ops.interactions import CIN, LinearUnit, fm_interaction
from .base import Model, embed_inputs, stateless


def _dims(fs: FeatureSet):
    return len(fs.sparse), fs.embed_dim, len(fs.dense)


def _first_order(m: Model, inp) -> torch.Tensor:
    """Linear sparse terms + the optional dense linear unit: (B,)."""
    lo = inp["linear"].sum(dim=1)
    if inp["dense"] is not None and inp["dense"].shape[-1] > 0:
        lo = lo + m.dense_linear(inp["dense"])
    return lo


def _maybe_dense_linear(fs: FeatureSet):
    return {"dense_linear": LinearUnit(len(fs.dense))} if len(fs.dense) else {}


def _bias() -> nn.Parameter:
    return nn.Parameter(zeros(()))


def DeepFM(fs: FeatureSet, hidden: Tuple[int, ...] = (256, 128, 64)) -> Model:
    """DeepFM: first-order + FM second-order + MLP over shared embeddings."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(f * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        h = flatten_concat([inp["emb"]] + ([inp["dense"]] if nd else []))
        deep = m.mlp(h, train)
        logit = (_first_order(m, inp) + fm_interaction(inp["emb"])
                 + deep[:, 0] + m.bias)
        return logit, {"emb_l2": inp["l2"]}

    return stateless("DeepFM", fs, parts, fwd)


def xDeepFM(fs: FeatureSet, cin_hidden: Tuple[int, ...] = (128, 128),
            hidden: Tuple[int, ...] = (256, 128),
            cin_kernel: str = "auto") -> Model:
    """xDeepFM: CIN + DNN + linear terms summed into one logit.
    ``cin_kernel``: 'auto' | 'pallas' | 'off' (see ``ops.interactions.CIN``)."""
    f, d, nd = _dims(fs)
    parts = {"embedding": FusedEmbedding(fs),
             "cin": CIN(f, d, cin_hidden, out_logit=True, kernel=cin_kernel),
             "mlp": MLP(f * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        h = flatten_concat([inp["emb"]] + ([inp["dense"]] if nd else []))
        deep = m.mlp(h, train)
        logit = (_first_order(m, inp) + m.cin(inp["emb"])
                 + deep[:, 0] + m.bias)
        return logit, {"emb_l2": inp["l2"]}

    return stateless("xDeepFM", fs, parts, fwd)


def AutoInt(fs: FeatureSet, n_layers: int = 2, num_heads: int = 2,
            head_dim: int = 16) -> Model:
    """AutoInt: stacked multi-head self-attention over the field embeddings
    (``mha0`` … ``mha{n-1}``), then flatten → logit (``head``). Dense
    features join as one projected pseudo-field (``dense_proj``), the last.
    The embedding keeps its ``linear`` table, as the reference's does, and
    does not read it. The reference's pipeline-parallel branch comes with
    the parallelism slice."""
    f, d, nd = _dims(fs)
    n_fields = f + (1 if nd else 0)
    parts = {"embedding": FusedEmbedding(fs), "head": Dense(n_fields * d, 1)}
    if nd:
        parts["dense_proj"] = Dense(nd, d)
    for i in range(n_layers):
        parts[f"mha{i}"] = MultiHeadAttention(d, num_heads, head_dim,
                                              use_res=True, use_ln=True)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        e = inp["emb"]
        if nd:
            e = torch.cat([e, m.dense_proj(inp["dense"])[:, None, :]], dim=1)
        for i in range(n_layers):
            e = getattr(m, f"mha{i}")(e)
        logit = m.head(e.reshape(e.shape[0], -1))
        return logit[:, 0], {"emb_l2": inp["l2"]}

    return stateless("AutoInt", fs, parts, fwd)
