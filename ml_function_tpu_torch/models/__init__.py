"""Model registry of the port; it grows with each slice."""

from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike, resolve_device
from ..ops.base import init_parameters
from .base import Model
from .interaction import DeepFM, xDeepFM

MODEL_REGISTRY = {
    "deepfm": DeepFM,
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


__all__ = ["Model", "MODEL_REGISTRY", "get_model", "DeepFM", "xDeepFM"]
