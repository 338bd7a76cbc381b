"""Scoring and model export of the port.

Counterpart of ``ml_function_tpu/serving.py``. The export format is the
reference's: ``weights.npz`` under flat ``params/...`` keys plus
``model.json`` (model name, feature schema, hyperparameters), so a directory
written by either package's ``export_model`` loads into the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .bridge import flat_params, params_from_numpy
from .features.schema import DenseSpec, FeatureSet, SeqSpec, SparseSpec
from .models import get_model
from .models.base import Model
from .train.loop import iter_batches


class Scorer:
    """Batched scoring on the model's device; the tail batch is padded to
    ``batch_size`` and only its real rows are returned."""

    def __init__(self, model: Model, batch_size: int = 4096):
        self.model = model
        self.batch_size = batch_size

    def predict_proba(self, data: Dict[str, Any]) -> np.ndarray:
        n = len(next(v for k, v in data.items() if k != "seq"))
        if "label" not in data:  # iter_batches keys off 'label' for length
            data = dict(data)
            data["label"] = np.zeros(n, np.float32)
        out = np.empty(n, np.float32)
        pos = 0
        with torch.inference_mode():
            for batch in iter_batches(data, self.batch_size):
                logits, _, _ = self.model(batch, train=False)
                p = torch.sigmoid(logits).cpu().numpy()
                take = int(batch["weight"].sum())
                out[pos:pos + take] = p[:take]
                pos += take
        return out


class ShardedScorer:
    """Scoring over row-sharded tables (reference ``ShardedScorer``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("row-sharded tables (ShardedScorer) come "
                                  "with slice 8, parallelism")


def _fs_to_json(fs: FeatureSet) -> dict:
    return {
        "dense": [dataclasses.asdict(d) for d in fs.dense],
        "sparse": [dataclasses.asdict(s) for s in fs.sparse],
        "seq": [dataclasses.asdict(s) for s in fs.seq],
    }


def _fs_from_json(d: dict) -> FeatureSet:
    return FeatureSet(
        dense=tuple(DenseSpec(**x) for x in d["dense"]),
        sparse=tuple(SparseSpec(**x) for x in d["sparse"]),
        seq=tuple(SeqSpec(**{**x, "session_shape":
                             tuple(x["session_shape"])
                             if x.get("session_shape") else None})
                  for x in d["seq"]),
    )


def export_model(path: str, model_name: str, fs: FeatureSet, model: Model,
                 hyperparams: Optional[dict] = None) -> str:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "weights.npz"), **flat_params(model))
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"model": model_name, "feature_set": _fs_to_json(fs),
                   "hyperparams": hyperparams or {}}, f)
    return path


def load_scorer(path: str, batch_size: int = 4096,
                quantize: Optional[str] = None,
                device: DeviceLike = None) -> Scorer:
    """Restore an exported model for scoring on ``device`` (default: the
    CUDA card; raises without one unless ``device='cpu'``)."""
    if quantize == "int8":
        raise NotImplementedError("int8 serving tables come with slice 7 "
                                  "(the sparse path and serving)")
    if quantize:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    dev = resolve_device(device)
    with open(os.path.join(path, "model.json")) as f:
        meta = json.load(f)
    fs = _fs_from_json(meta["feature_set"])
    hp = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in meta["hyperparams"].items()}
    model = get_model(meta["model"], fs, device=dev, **hp)
    with np.load(os.path.join(path, "weights.npz")) as arrays:
        params_from_numpy(model, dict(arrays))
    return Scorer(model, batch_size)
