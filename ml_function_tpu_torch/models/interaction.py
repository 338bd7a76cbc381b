"""Feature-interaction models of the port: DeepFM, xDeepFM, DLRM, FiBiNET
and AutoInt.

Counterpart of ``ml_function_tpu/models/interaction.py``; the other models of
that file come with later slices. DLRM and FiBiNET run no kernel of their
own: their pair products are f32 tensor operations, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.attention import MultiHeadAttention
from ..ops.base import normal_init, zeros
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


def _triu_pairs(e: torch.Tensor):
    """(i, j) of every field pair i < j in row-major order (``np.triu_indices``
    with k = 1), made on e's device."""
    n = e.shape[1]
    return torch.triu_indices(n, n, offset=1, device=e.device)


class _SENet(nn.Module):
    """FiBiNET's squeeze-excitation: field weights relu(relu(z·w1)·w2) from
    the field means z, as plain f32 products (the reference uses no
    ``bf16_matmul`` here)."""

    def __init__(self, n_fields: int, mid: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(n_fields, mid))
        self.w2 = nn.Parameter(torch.empty(mid, n_fields))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w1.copy_(normal_init(self.w1.shape, generator, stddev=0.1))
        self.w2.copy_(normal_init(self.w2.shape, generator, stddev=0.1))

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        z = e.mean(dim=-1)                                         # squeeze (B, F)
        return torch.relu(torch.relu(z @ self.w1) @ self.w2)       # excitation


def FiBiNET(fs: FeatureSet, reduction: int = 3, bilinear_type: str = "each",
            hidden: Tuple[int, ...] = (128, 64)) -> Model:
    """FiBiNET: SENET reweights the field embeddings (``se``), a bilinear
    layer (``bilinear_w``: (F, D, D) for 'each', (D, D) for 'all') crosses
    every field pair of both the raw and the reweighted embeddings, and the
    pair vectors (with the dense features) feed ``mlp``; plus the first-order
    terms and ``bias``."""
    f, d, nd = _dims(fs)
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type {bilinear_type!r} not in "
                         "('all', 'each')")
    n_pairs = f * (f - 1) // 2
    kshape = (d, d) if bilinear_type == "all" else (f, d, d)
    parts = {"embedding": FusedEmbedding(fs),
             "se": _SENet(f, max(1, f // reduction)),
             "bilinear_w": nn.Parameter(torch.empty(kshape)),
             "mlp": MLP(2 * n_pairs * d + nd, hidden, activation="relu", out_dim=1),
             "bias": _bias(), **_maybe_dense_linear(fs)}
    inits = {"bilinear_w": lambda g: normal_init(kshape, g, stddev=0.05)}
    spec = "bfd,de->bfe" if bilinear_type == "all" else "bfd,fde->bfe"

    def bilinear(w, e, iu, ju):
        t = torch.einsum(spec, e, w)
        return (t[:, iu, :] * e[:, ju, :]).reshape(e.shape[0], -1)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch)
        e = inp["emb"]
        v = e * m.se(e)[..., None]                                 # reweight
        iu, ju = _triu_pairs(e)
        parts = [bilinear(m.bilinear_w, e, iu, ju), bilinear(m.bilinear_w, v, iu, ju)]
        if nd:
            parts.append(inp["dense"])
        deep = m.mlp(torch.cat(parts, dim=-1), train)
        logit = _first_order(m, inp) + deep[:, 0] + m.bias
        return logit, {"emb_l2": inp["l2"]}

    return stateless("FiBiNET", fs, parts, fwd, inits)


def DLRM(fs: FeatureSet, bottom: Tuple[int, ...] = (64,),
         top: Tuple[int, ...] = (256, 128)) -> Model:
    """DLRM: dense features through the ``bottom`` MLP into the embedding
    width, joined as the first pseudo-field; the f32 dot of every field pair
    (a Gram product read at the upper triangle); [bottom output ∥ pair dots]
    into the ``top`` MLP. No first-order term and no bias; the embedding has
    no ``linear`` table. Without dense features there is no ``bottom``."""
    f, d, nd = _dims(fs)
    n_fields = f + (1 if nd else 0)
    top_dim = (d if nd else 0) + n_fields * (n_fields - 1) // 2
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "top": MLP(top_dim, top, activation="relu", out_dim=1)}
    if nd:
        parts["bottom"] = MLP(nd, tuple(bottom) + (d,), activation="relu")

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        e = inp["emb"]
        parts = []
        if nd:
            x0 = m.bottom(inp["dense"], train)                     # (B, D)
            e = torch.cat([x0[:, None, :], e], dim=1)
            parts.append(x0)
        gram = torch.einsum("bid,bjd->bij", e, e)
        iu, ju = _triu_pairs(e)
        parts.append(gram[:, iu, ju])
        logit = m.top(torch.cat(parts, dim=-1), train)
        return logit[:, 0], {"emb_l2": inp["l2"]}

    return stateless("DLRM", fs, parts, fwd)


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
