"""Model API of the port.

Counterpart of ``ml_function_tpu/models/base.py``. A ``Model`` is an
``nn.Module`` over a ``FeatureSet`` whose submodules carry the JAX parameter
tree's top-level names (``embedding``, ``cin``, ``mlp``, ``bias``, …).

``model(batch, train=False) -> (logits, state, aux)`` as the reference's
``apply``: ``logits`` (B,) pre-sigmoid scores, ``state`` ({} for stateless
models), ``aux`` the named auxiliary losses (``emb_l2``). ``batch`` maps
names to numpy arrays or tensors; numpy arrays move to the model's device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.embedding import FusedEmbedding

State = Dict[str, Any]
Aux = Dict[str, torch.Tensor]
FwdFn = Callable[["Model", Dict[str, Any], bool],
                 Tuple[torch.Tensor, Aux]]


class Model(nn.Module):
    def __init__(self, name: str, feature_set: FeatureSet,
                 parts: Mapping[str, Union[nn.Module, nn.Parameter]],
                 fwd: FwdFn):
        super().__init__()
        self.name = name
        self.feature_set = feature_set
        for key, part in parts.items():
            if isinstance(part, nn.Parameter):
                self.register_parameter(key, part)
            else:
                self.add_module(key, part)
        self._fwd = fwd

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The model's own scalar parameters (``bias``) start at zero."""
        for p in self.parameters(recurse=False):
            p.zero_()

    def forward(self, batch: Mapping[str, Any], train: bool = False
                ) -> Tuple[torch.Tensor, State, Aux]:
        dev = next(self.parameters()).device
        batch = {k: torch.as_tensor(v, device=dev)
                 if isinstance(v, np.ndarray) else v
                 for k, v in batch.items()}
        logits, aux = self._fwd(self, batch, train)
        return logits, {}, aux


def embed_inputs(fe: FusedEmbedding, batch: Mapping[str, Any],
                 with_linear: bool = True, l2: bool = True) -> Dict[str, Any]:
    """One lookup for all sparse fields. Returns dense (B, Nd), emb
    (B, F, D), linear (B, F) and the embedding L2 aux term."""
    if batch.get("emb_override"):
        raise NotImplementedError(
            "emb_override (the cold-start hook) comes with the slice of the "
            "remaining models")
    out: Dict[str, Any] = {"dense": batch.get("dense")}
    if with_linear:
        emb, out["linear"] = fe.sparse_all(batch["sparse"])
    else:
        emb = fe.sparse(batch["sparse"])
    out["emb"] = emb
    out["l2"] = fe.l2_from_sparse(emb) if l2 else emb.new_zeros(())
    return out


def stateless(name: str, fs: FeatureSet,
              parts: Mapping[str, Union[nn.Module, nn.Parameter]],
              fwd: FwdFn) -> Model:
    """A Model with no running state from its parts and a
    ``fwd(model, batch, train) -> (logits, aux)``."""
    return Model(name, fs, parts, fwd)
