"""Feature-interaction models of the port: DeepFM and xDeepFM.

Counterpart of ``ml_function_tpu/models/interaction.py``; the other models of
that file come with later slices.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.base import zeros
from ..ops.core import MLP, flatten_concat
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
