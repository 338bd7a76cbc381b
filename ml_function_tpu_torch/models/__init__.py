"""Model registry of the port: the reference's 42 names."""

from __future__ import annotations

from typing import Optional

import torch

from .._device import DeviceLike, resolve_device
from ..ops.base import init_parameters
from .base import Model
from .image import DICM
from .interaction import (AFM, DCN, DLRM, FFM, FM, FNN, LR, NFM, PNN,
                          AutoInt, DeepCross, DeepFM, FiBiNET, FwFM, WideDeep,
                          fnn_from_fm, xDeepFM)
from .interaction_ext import (CCPM, FGCNN, FLEN, MLR, OENN, ONN, FATDeepFFM,
                              FiGNN)
from .longseq import DTS, HPMN, MIMN, SIM
from .match import DSSM, DeepMCP
from .multitask import ESMM, PLE, MMoE
from .sequence import BST, DIEN, DIN, DMIN, DSIN, DSTN, MIND, SeqFM

MODEL_REGISTRY = {
    "lr": LR,
    "fm": FM,
    "fnn": FNN,
    "ffm": FFM,
    "fwfm": FwFM,
    "pnn": PNN,
    "deepcross": DeepCross,
    "wide_deep": WideDeep,
    "deepfm": DeepFM,
    "dcn": DCN,
    "nfm": NFM,
    "xdeepfm": xDeepFM,
    "afm": AFM,
    "autoint": AutoInt,
    "fibinet": FiBiNET,
    "dlrm": DLRM,
    "ccpm": CCPM,
    "fgcnn": FGCNN,
    "flen": FLEN,
    "onn": ONN,
    "oenn": OENN,
    "fat_deepffm": FATDeepFFM,
    "fignn": FiGNN,
    "mlr": MLR,
    "din": DIN,
    "dien": DIEN,
    "bst": BST,
    "dsin": DSIN,
    "seqfm": SeqFM,
    "dstn": DSTN,
    "dmin": DMIN,
    "mind": MIND,
    "dts": DTS,
    "mimn": MIMN,
    "sim": SIM,
    "hpmn": HPMN,
    "esmm": ESMM,
    "mmoe": MMoE,
    "ple": PLE,
    "dssm": DSSM,
    "deepmcp": DeepMCP,
    "dicm": DICM,
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


__all__ = ["Model", "MODEL_REGISTRY", "get_model", "fnn_from_fm", "AFM",
           "AutoInt", "BST", "CCPM", "DCN", "DeepCross", "DeepFM", "DeepMCP",
           "DICM", "DIEN", "DIN", "DLRM", "DMIN", "DSIN", "DSSM", "DSTN", "DTS",
           "ESMM", "FATDeepFFM", "FFM", "FGCNN", "FiBiNET", "FiGNN", "FLEN", "FM",
           "FNN", "FwFM", "HPMN", "LR", "MIMN", "MIND", "MLR", "MMoE", "NFM",
           "OENN", "ONN", "PLE", "PNN", "SeqFM", "SIM", "WideDeep", "xDeepFM"]
