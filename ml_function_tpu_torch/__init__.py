"""ml_function_tpu_torch — the PyTorch port of ml_function_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same structure and names. It
imports ``torch`` and numpy, never ``jax`` or ``ml_function_tpu``. Kernels
that the JAX package wrote in Pallas are CUDA kernels here, built from
``ops/kernels/csrc`` at first use. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .features.schema import (DenseSpec, FeatureSet, SeqSpec, SparseSpec,
                              criteo_feature_set)


def __getattr__(name):
    # lazy top-level conveniences (keep `import ml_function_tpu_torch` light)
    if name in ("get_model", "MODEL_REGISTRY"):
        from . import models
        return getattr(models, name)
    if name == "iter_batches":
        from .train import loop
        return loop.iter_batches
    if name in ("Scorer", "export_model", "load_scorer"):
        from . import serving
        return getattr(serving, name)
    raise AttributeError(name)


__all__ = [
    "DenseSpec", "SparseSpec", "SeqSpec", "FeatureSet", "criteo_feature_set",
    "get_model", "MODEL_REGISTRY", "iter_batches", "Scorer", "export_model",
    "load_scorer",
]
