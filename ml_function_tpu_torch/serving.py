"""Scoring and model export of the port.

Counterpart of ``ml_function_tpu/serving.py``. The export format is the
reference's: ``weights.npz`` under flat ``params/...`` keys (and
``state/...`` for BatchNorm's running statistics) plus ``model.json``
(model name, feature schema, hyperparameters), so a directory written by
either package's ``export_model`` loads into the other.
``load_scorer(..., quantize='int8')`` scores from int8 serving tables
(``quantize_for_serving``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .bridge import flat_params, flat_state, params_from_numpy
from .features.schema import DenseSpec, FeatureSet, SeqSpec, SparseSpec
from .models import get_model
from .models.base import Model
from .ops.embedding import FusedEmbedding, QuantizedTable, quantize_table
from .train.loop import iter_batches
from .train.sparse import aux_row_tables


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
    """Scoring over row-sharded tables (reference ``ShardedScorer``): a
    serving fleet whose tables outgrow one device. ``model``'s tables (and
    MMoE's expert stacks) are padded and replaced, in place, by this rank's
    blocks of ``mesh`` (``parallel/train.shard_model_``); each global batch
    is split over the data axis, its lookups ride the collective exchange
    of sharded training, and every rank returns the full probabilities,
    gathered over the data group. Every rank of the mesh calls
    ``predict_proba`` with the same data."""

    def __init__(self, model: Model, mesh, batch_size: int = 4096,
                 exchange: str = "psum", device: DeviceLike = None):
        from .parallel.train import shard_model_
        if batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} must divide the "
                             f"data axis ({mesh.data})")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.model = model
        self.mesh = mesh
        self.batch_size = batch_size
        self.exchange = exchange
        self.layout = shard_model_(model, mesh)

    def predict_proba(self, data: Dict[str, Any]) -> np.ndarray:
        from .parallel.comm import all_gather_tensor
        from .parallel.context import sharded_embeddings
        from .parallel.train import shard_batch
        n = len(next(v for k, v in data.items() if k != "seq"))
        if "label" not in data:
            data = dict(data)
            data["label"] = np.zeros(n, np.float32)
        out = np.empty(n, np.float32)
        pos = 0
        with torch.inference_mode(), sharded_embeddings(self.mesh, mode=self.exchange):
            for batch in iter_batches(data, self.batch_size):
                logits, _, _ = self.model(shard_batch(batch, self.mesh), train=False)
                p = all_gather_tensor(torch.sigmoid(logits), self.mesh.data_group)
                take = int(batch["weight"].sum())
                out[pos:pos + take] = p.cpu().numpy()[:take]
                pos += take
        return out


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
    np.savez(os.path.join(path, "weights.npz"), **flat_params(model),
             **flat_state(model))
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"model": model_name, "feature_set": _fs_to_json(fs),
                   "hyperparams": hyperparams or {}}, f)
    return path


@torch.no_grad()
def quantize_for_serving(model: Model) -> Model:
    """int8 serving storage for every vocab-row table, in place: the
    ``embedding``'s (table, linear) pair packs into one (V, D+3) row
    ``[q_cross·D, e_cross, q_lin, e_lin]`` (``FusedEmbedding.quantize_``),
    its other tables wider than 1 and the auxiliary (V, W > 1) tables
    (FFM's ``ffm``, OENN's ``order{k}``) into ``[q·W, e]`` rows, each with a
    per-row power-of-2 scale. About 4× less table memory; the model can
    score but not train. Returns the model."""
    emb = getattr(model, "embedding", None)
    if isinstance(emb, FusedEmbedding):
        emb.quantize_()
    for k, t in aux_row_tables(model).items():
        if t.shape[1] > 1:
            del model._parameters[k]
            model.add_module(k, QuantizedTable(quantize_table(t)))
    return model


def load_scorer(path: str, batch_size: int = 4096,
                quantize: Optional[str] = None,
                device: DeviceLike = None) -> Scorer:
    """Restore an exported model for scoring on ``device`` (default: the
    CUDA card; raises without one unless ``device='cpu'``);
    ``quantize='int8'`` scores from int8 serving tables
    (``quantize_for_serving``)."""
    if quantize not in (None, "int8"):
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
    if quantize == "int8":
        quantize_for_serving(model)
    return Scorer(model, batch_size)
