"""Model registry of the port; it grows with each slice."""

from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike, resolve_device
from ..ops.base import init_parameters
from .base import Model
from .interaction import DLRM, AutoInt, DeepFM, FiBiNET, xDeepFM
from .longseq import SIM
from .sequence import DIEN, DIN

MODEL_REGISTRY = {
    "autoint": AutoInt,
    "deepfm": DeepFM,
    "dien": DIEN,
    "din": DIN,
    "dlrm": DLRM,
    "fibinet": FiBiNET,
    "sim": SIM,
    "xdeepfm": xDeepFM,
}


def get_model(name: str, feature_set, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None, **hp) -> Model:
    """Build a registered model with parameters drawn from ``generator``
    (default: a CPU generator seeded with 0) on ``device`` (default: the
    CUDA card; raises without one unless ``device='cpu'``)."""
    try:
        ctor = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    model = ctor(feature_set, **hp)
    init_parameters(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    return model.to(dev)


__all__ = ["Model", "MODEL_REGISTRY", "get_model", "AutoInt", "DeepFM",
           "DIEN", "DIN", "DLRM", "FiBiNET", "SIM", "xDeepFM"]
