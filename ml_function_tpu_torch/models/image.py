"""DICM, the image-aware CTR model of the port.

Counterpart of ``ml_function_tpu/models/image.py``: a DIN-style id path, one
shared image tower (``tower``) over the ad's and every behavior's
pre-extracted image vector in one batched product, and a target attention
over the behavior images queried by the ad image (``img_attn``), beside
the one over the behavior ids (``id_attn``). The batch carries ``image``
(B, img_dim) and ``hist_image`` (B, L, img_dim), step t of the latter
aligned with step t of the first behavior sequence. No kernel but K1, on
the behavior lookups under ``ML_FUNCTION_TPU_MERGE_SCATTER``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..features.schema import FeatureSet
from ..ops.attention import TargetAttention
from ..ops.core import MLP
from ..ops.embedding import FusedEmbedding
from .base import Model, behavior_inputs, stateless
from .sequence import _beh_dims, _other_fields, _tower_input


def DICM(fs: FeatureSet,
         candidate: Tuple[str, ...] = ("item", "cate"),
         behavior: Tuple[str, ...] = ("hist_item", "hist_cate"),
         img_dim: int = 64,
         img_tower: Tuple[int, ...] = (64,),
         attention_hidden: Tuple[int, ...] = (36, 1),
         hidden: Tuple[int, ...] = (200, 80)) -> Model:
    """Deep Image CTR Model: [cand, id attention, ad image, image
    attention, other fields, dense] → a Dice MLP with LayerNorm."""
    d, kd, n_other = _beh_dims(fs, candidate)
    emb_img = img_tower[-1]
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "tower": MLP(img_dim, img_tower[:-1], activation="relu", out_dim=emb_img),
             "id_attn": TargetAttention(kd, attention_hidden, activation="sigmoid"),
             "img_attn": TargetAttention(emb_img, attention_hidden, activation="sigmoid"),
             "mlp": MLP(kd * 2 + emb_img * 2 + n_other * d + len(fs.dense), hidden,
                        activation="dice", norm="layer", out_dim=1)}

    parts["other_fields"] = _other_fields(fs, candidate)

    def fwd(m, batch, train):
        cand, beh, mask, l2, emb = behavior_inputs(m.embedding, batch, candidate,
                                                   behavior)
        hist_img = batch["hist_image"]                       # (B, L, img_dim)
        b, L = hist_img.shape[:2]
        stacked = torch.cat([batch["image"][:, None, :], hist_img], dim=1)
        projected = m.tower(stacked.reshape(b * (L + 1), img_dim)).reshape(
            b, L + 1, emb_img)
        ad_e, hist_e = projected[:, 0], projected[:, 1:] * mask[..., None]
        lead = (cand, m.id_attn(cand, beh, mask), ad_e, m.img_attn(ad_e, hist_e, mask))
        h = _tower_input(m, batch, lead, emb)
        return m.mlp(h, train)[:, 0], {"emb_l2": l2}

    return stateless("DICM", fs, parts, fwd)
