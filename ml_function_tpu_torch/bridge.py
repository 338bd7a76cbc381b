"""Weights across the two packages, by key path.

The JAX package keeps parameters as a nested dict; ``export_model`` writes it
to ``weights.npz`` under flat keys ``params/<a>/<b>/<c>``. The port's modules
are named after the same keys, so ``params/mlp/layer0/dense/w`` is the
state-dict key ``mlp.layer0.dense.w`` and the copy is one lookup per leaf.
Both directions are strict: a missing key, a key left over or a shape that
differs raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def params_from_numpy(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters from a nested dict of arrays (the JAX
    params after ``np.asarray``) or from the flat keys of ``weights.npz``
    (``params/...``, with ``state/...`` for running state)."""
    flat = _flatten(tree)
    if flat and all(k.startswith(("params/", "state/")) for k in flat):
        state = [k for k in flat if k.startswith("state/")]
        if state:
            raise NotImplementedError(
                f"model state {state[:3]} (BatchNorm running statistics) "
                "crosses with the slice that brings a stateful model")
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    want = dict(model.named_parameters())
    got = {k.replace("/", "."): v for k, v in flat.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in want.items():
            arr = np.asarray(got[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                                 f"{tuple(p.shape)}")
            if not np.issubdtype(arr.dtype, np.floating):
                raise ValueError(f"{name}: dtype {arr.dtype} is not floating")
            p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model


def params_to_numpy(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's nested dict of arrays."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return tree


def flat_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """``weights.npz`` keys (``params/<a>/<b>``) → arrays."""
    return {"params/" + k: v
            for k, v in _flatten(params_to_numpy(model)).items()}
