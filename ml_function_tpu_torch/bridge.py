"""Weights across the two packages, by key path.

The JAX package keeps parameters as a nested dict; ``export_model`` writes it
to ``weights.npz`` under flat keys ``params/<a>/<b>/<c>``, a list's entries
under their index (MMoE's ``params/experts/w/0``). The port's modules are
named after the same keys, so ``params/mlp/layer0/dense/w`` is the
state-dict key ``mlp.layer0.dense.w`` (a list is an ``nn.ParameterList``:
``experts.w.0``) and the copy is one lookup per leaf.
Both directions are strict: a missing key, a key left over or a shape that
differs raises.

Running state (the JAX ``model_state``, BatchNorm's running ``mean`` and
``var``) lives in the port's buffers. The JAX ``MLP`` keeps a layer's
statistics at ``layer{i}/mean`` where its parameters sit at
``layer{i}/norm/...``; the port's ``BatchNorm`` module sits at
``layer{i}.norm``, so its buffer ``layer{i}.norm.mean`` is the state key
``layer{i}/mean`` (``state_buffers``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .ops.core import BatchNorm


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by key path; a list or tuple's entries by their index, as
    ``tree_flatten_with_path`` names them."""
    out: Dict[str, Any] = {}
    items = (tree.items() if isinstance(tree, Mapping)
             else ((str(i), v) for i, v in enumerate(tree)))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _lists(node: Any) -> Any:
    """Nodes keyed "0" … "n-1" (an ``nn.ParameterList``) as lists, the
    JAX tree's form."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and set(node) == {str(i) for i in range(len(node))}:
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_numpy(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters from a nested dict of arrays (the JAX
    params after ``np.asarray``) or from the flat keys of ``weights.npz``
    (``params/...``, with ``state/...`` for running state)."""
    flat = _flatten(tree)
    if flat and all(k.startswith(("params/", "state/")) for k in flat):
        state = {k[len("state/"):]: v for k, v in flat.items()
                 if k.startswith("state/")}
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
        state_from_numpy(model, state)
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
    """The model's parameters as the JAX package's nested dict of arrays
    (lists where the JAX tree has them)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return _lists(tree)


def flat_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """``weights.npz`` keys (``params/<a>/<b>``) → arrays."""
    return {"params/" + k: v
            for k, v in _flatten(params_to_numpy(model)).items()}


def state_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's running state by its JAX ``model_state`` key path:
    every ``BatchNorm``'s ``mean`` and ``var`` buffers, keyed without the
    module's own ``norm`` name (``mlp/layer0/mean``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            path = name.split(".") if name else []
            if path and path[-1] == "norm":
                path = path[:-1]
            for b in ("mean", "var"):
                out["/".join(path + [b])] = getattr(mod, b)
    return out


def state_from_numpy(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s running state (``state_buffers``) from a nested
    dict of arrays (the JAX ``model_state``) or from its flat key paths;
    strict as ``params_from_numpy``."""
    got = _flatten(tree)
    want = state_buffers(model)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"model state keys differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for key, buf in want.items():
            arr = np.asarray(got[key])
            if tuple(arr.shape) != tuple(buf.shape):
                raise ValueError(f"state {key}: shape {tuple(arr.shape)} != "
                                 f"{tuple(buf.shape)}")
            buf.copy_(torch.tensor(arr, dtype=buf.dtype))
    return model


def flat_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """``weights.npz`` keys of the running state (``state/<path>``)."""
    return {"state/" + k: v.detach().cpu().numpy().copy()
            for k, v in state_buffers(model).items()}


def _unflag(flat: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split ``weights.npz``-style keys into (params, state); a nested tree
    passes as params."""
    if flat and all(k.startswith(("params/", "state/")) for k in flat):
        return ({k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")},
                {k[len("state/"):]: v for k, v in flat.items() if k.startswith("state/")})
    return flat, {}


def shard_params_from_numpy(model: nn.Module, tree: Mapping[str, Any], mesh,
                            layout: Mapping[str, Tuple[int, int]],
                            state: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Fill a sharded ``model`` from a nested dict of arrays (or flat
    ``params/...`` keys) by key path, strictly: a parameter of ``layout``
    (dotted name → (rows, padded rows)) takes this rank's block of the
    array's rows, the array whole (``rows``) or padded (``padded rows``);
    every other parameter takes the array as it is. ``state`` fills the
    BatchNorm buffers."""
    params, flat_state = _unflag(_flatten(tree))
    if state:
        flat_state = _flatten(state)
    if flat_state:
        state_from_numpy(model, flat_state)
    want = dict(model.named_parameters())
    got = {k.replace("/", "."): v for k, v in params.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in want.items():
            arr = np.asarray(got[name])
            if name in layout:
                rows, padded = layout[name]
                if arr.shape[0] not in (rows, padded):
                    raise ValueError(f"{name}: {arr.shape[0]} rows, want {rows} "
                                     f"or {padded}")
                if arr.shape[0] < padded:
                    arr = np.concatenate(
                        [arr, np.zeros((padded - arr.shape[0],) + arr.shape[1:], arr.dtype)])
                r = p.shape[0]
                arr = arr[mesh.model_index * r:(mesh.model_index + 1) * r]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} != {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model


def sharded_params_to_numpy(model: nn.Module, layout: Mapping[str, Tuple[int, int]],
                            mesh) -> Dict[str, Any]:
    """The JAX package's nested dict of a sharded model, every block gathered
    over the model group and the padding rows dropped (collective: every
    rank of the model group calls it)."""
    from .parallel.comm import all_gather_tensor
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if name in layout:
            t = all_gather_tensor(t.contiguous(), mesh.model_group)[:layout[name][0]]
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.cpu().numpy().copy()
    return _lists(tree)
