"""Synthetic Criteo-like data with planted structure (numpy only).

The port's copy of ``make_criteo_like`` from
``ml_function_tpu/features/synthetic.py``: the same seed gives the same rows
in both packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .schema import DenseSpec, FeatureSet, SparseSpec


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def make_criteo_like(
    n_rows: int = 20000,
    n_dense: int = 13,
    n_sparse: int = 26,
    vocab_size: int = 100,
    embed_dim: int = 8,
    seed: int = 0,
) -> Tuple[FeatureSet, Dict[str, np.ndarray]]:
    """Criteo-format data (13 dense + 26 sparse) with a planted FM
    structure: y ~ Bernoulli(sigmoid(FM(z, v)))."""
    rng = np.random.default_rng(seed)
    dense = rng.uniform(0, 1, (n_rows, n_dense)).astype(np.float32)
    sparse = rng.integers(1, vocab_size, (n_rows, n_sparse)).astype(np.int32)

    # planted parameters
    true_emb = rng.normal(0, 0.35, (n_sparse, vocab_size, 4))
    true_lin = rng.normal(0, 0.5, (n_sparse, vocab_size))
    w_dense = rng.normal(0, 1.0, n_dense)

    e = np.stack([true_emb[f, sparse[:, f]] for f in range(n_sparse)], axis=1)
    lin = np.stack([true_lin[f, sparse[:, f]] for f in range(n_sparse)], axis=1)
    s = e.sum(axis=1)
    fm = 0.5 * (np.square(s) - np.square(e).sum(axis=1)).sum(axis=-1)
    logits = fm + lin.sum(axis=1) + dense @ w_dense
    logits = (logits - logits.mean()) / (logits.std() + 1e-9) * 2.0
    y = (rng.uniform(size=n_rows) < _sigmoid(logits)).astype(np.float32)

    fs = FeatureSet(
        dense=tuple(DenseSpec(f"I{i+1}") for i in range(n_dense)),
        sparse=tuple(SparseSpec(f"C{i+1}", vocab_size=vocab_size, dim=embed_dim)
                     for i in range(n_sparse)),
    )
    batch = {"dense": dense, "sparse": sparse, "label": y}
    return fs, batch
