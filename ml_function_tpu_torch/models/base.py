"""Model API of the port.

Counterpart of ``ml_function_tpu/models/base.py``. A ``Model`` is an
``nn.Module`` over a ``FeatureSet`` whose submodules carry the JAX parameter
tree's top-level names (``embedding``, ``cin``, ``mlp``, ``bias``, …).

``model(batch, train=False) -> (logits, state, aux)`` as the reference's
``apply``: ``logits`` (B,) pre-sigmoid scores, ``state`` ({} for stateless
models), ``aux`` the named auxiliary losses (``emb_l2``). ``batch`` maps
names to numpy arrays or tensors, with ``seq`` a nested dict of them;
numpy arrays move to the model's device, nested ones included.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.embedding import FusedEmbedding

State = Dict[str, Any]
Aux = Dict[str, torch.Tensor]
FwdFn = Callable[["Model", Dict[str, Any], bool],
                 Tuple[torch.Tensor, Aux]]
Init = Callable[[torch.Generator], torch.Tensor]


def as_tensors(batch: Mapping[str, Any], device: torch.device) -> Dict[str, Any]:
    """numpy arrays (and nested dicts of them, ``seq``) → tensors on
    ``device``; anything else passes as it is."""
    return {k: as_tensors(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


class Model(nn.Module):
    def __init__(self, name: str, feature_set: FeatureSet,
                 parts: Mapping[str, Union[nn.Module, nn.Parameter, torch.Tensor]],
                 fwd: FwdFn, inits: Optional[Mapping[str, Init]] = None):
        super().__init__()
        self.name = name
        self.feature_set = feature_set
        self._helpers: Dict[str, Callable] = {}
        for key, part in parts.items():
            if isinstance(part, nn.Parameter):
                self.register_parameter(key, part)
            elif isinstance(part, torch.Tensor):   # a constant the steps read
                self.register_buffer(key, part, persistent=False)
            else:
                self.add_module(key, part)
        self._fwd = fwd
        self._inits = dict(inits or {})

    def add_helper(self, name: str, fn: Callable) -> None:
        """``model.<name>(*args)`` calls ``fn(model, *args)``: a model's own
        entry point beside ``forward`` (DIEN's ``interest``, MIND's
        ``interests``), bound at each access, so that a deep copy's helper
        reads the copy's parameters."""
        self._helpers[name] = fn

    def __getattr__(self, name: str):
        helpers = self.__dict__.get("_helpers", {})
        if name in helpers:
            return functools.partial(helpers[name], self)
        return super().__getattr__(name)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The model's own parameters start at zero (``bias``), or from
        their entry in ``inits`` (FiBiNET's ``bilinear_w``)."""
        for key, p in self.named_parameters(recurse=False):
            init = self._inits.get(key)
            if init is None:
                p.zero_()
            else:
                p.copy_(init(generator))

    def forward(self, batch: Mapping[str, Any], train: bool = False
                ) -> Tuple[torch.Tensor, State, Aux]:
        batch = as_tensors(batch, next(self.parameters()).device)
        logits, aux = self._fwd(self, batch, train)
        return logits, {}, aux


def embed_inputs(fe: FusedEmbedding, batch: Mapping[str, Any],
                 with_linear: bool = True, l2: bool = True) -> Dict[str, Any]:
    """One lookup for all sparse fields. Returns dense (B, Nd), emb
    (B, F, D), linear (B, F) and the embedding L2 aux term.

    The cold-start hook (``models/coldstart.py``): a batch entry
    ``emb_override`` {field: (B, D)} replaces that field's gathered cross
    rows, out of place, so that the gradient reaches the override and not
    the table's rows. The field's first-order weight is not replaced."""
    out: Dict[str, Any] = {"dense": batch.get("dense")}
    if with_linear:
        emb, out["linear"] = fe.sparse_all(batch["sparse"])
    else:
        emb = fe.sparse(batch["sparse"])
    for name, vec in (batch.get("emb_override") or {}).items():
        col = emb.new_full((1,), fe.feature_set.sparse_index(name), dtype=torch.long)
        emb = emb.index_copy(1, col, vec[:, None, :].to(emb.dtype))
    out["emb"] = emb
    out["l2"] = fe.l2_from_sparse(emb) if l2 else emb.new_zeros(())
    return out


def behavior_inputs(fe: FusedEmbedding, batch: Mapping[str, Any],
                    candidate: Sequence[str], behavior: Sequence[str]):
    """Candidate and behavior tensors of the DIN family: (cand (B, k·D),
    beh (B, L, k·D), mask (B, L), l2, emb (B, F, D)). cand concatenates the
    named sparse fields' rows, beh the named sequences' rows along the
    feature axis; the mask is the union of the sequences' masks and l2 covers
    the sparse and the sequence rows."""
    fs = fe.feature_set
    emb = fe.sparse(batch["sparse"])
    cand = torch.cat([emb[:, fs.sparse_index(n), :] for n in candidate], dim=-1)
    l2 = fe.l2_from_sparse(emb)
    seqs, mask = [], None
    for name in behavior:
        e, m = fe.seq(name, batch["seq"][name])
        seqs.append(e)
        mask = m if mask is None else mask | m
        l2 = l2 + fe.l2_from_seq(name, e)
    return cand, torch.cat(seqs, dim=-1), mask, l2, emb


def stateless(name: str, fs: FeatureSet,
              parts: Mapping[str, Union[nn.Module, nn.Parameter]],
              fwd: FwdFn, inits: Optional[Mapping[str, Init]] = None) -> Model:
    """A Model with no running state from its parts and a
    ``fwd(model, batch, train) -> (logits, aux)``."""
    return Model(name, fs, parts, fwd, inits)
