"""Synthetic CTR data with planted structure (numpy only).

The port's copies of ``make_criteo_like`` and ``make_behavior_data`` from
``ml_function_tpu/features/synthetic.py``: the same seed gives the same rows
in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .schema import DenseSpec, FeatureSet, SeqSpec, SparseSpec


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


def make_behavior_data(
    n_rows: int = 8000,
    n_items: int = 200,
    n_cates: int = 20,
    seq_len: int = 16,
    n_sparse_extra: int = 2,
    vocab_size: int = 50,
    embed_dim: int = 8,
    seed: int = 0,
    session_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[FeatureSet, Dict[str, np.ndarray]]:
    """Behavior-sequence data (reference seq.py style: candidate item/cate +
    behavior history of items/cates, data_prepare.py:150-217).

    Planted structure: each user has a latent interest vector = mean of their
    history item embeddings; click prob depends on 〈interest, candidate〉 —
    exactly what target attention should exploit.
    """
    rng = np.random.default_rng(seed)
    item_emb = rng.normal(0, 1.0, (n_items + 1, 6))
    item_emb[0] = 0.0
    item_cate = np.concatenate([[0], rng.integers(1, n_cates, n_items)]).astype(np.int32)

    lengths = rng.integers(seq_len // 2, seq_len + 1, n_rows)
    seq_items = np.zeros((n_rows, seq_len), np.int32)
    # user interest clusters: draw history around a per-user anchor item
    for i in range(n_rows):
        anchor = rng.normal(0, 1.0, 6)
        sims = item_emb[1:] @ anchor
        p = np.exp(sims - sims.max())
        p /= p.sum()
        seq_items[i, :lengths[i]] = rng.choice(
            np.arange(1, n_items + 1), size=lengths[i], p=p)
    seq_cates = item_cate[seq_items] * (seq_items != 0)

    cand = rng.integers(1, n_items + 1, n_rows).astype(np.int32)
    cand_cate = item_cate[cand]

    interest = np.zeros((n_rows, 6))
    cnt = np.maximum((seq_items != 0).sum(1, keepdims=True), 1)
    for i in range(n_rows):
        interest[i] = item_emb[seq_items[i]].sum(0)
    interest /= cnt
    score = np.einsum("nd,nd->n", interest, item_emb[cand])
    score = (score - score.mean()) / (score.std() + 1e-9) * 2.2
    y = (rng.uniform(size=n_rows) < _sigmoid(score)).astype(np.float32)

    extra = rng.integers(1, vocab_size, (n_rows, n_sparse_extra)).astype(np.int32)
    sparse = np.concatenate([cand[:, None], cand_cate[:, None], extra], axis=1)

    item_v, cate_v = n_items + 1, n_cates + 1
    fs = FeatureSet(
        sparse=(SparseSpec("item", item_v, vocab_name="item", dim=embed_dim),
                SparseSpec("cate", cate_v, vocab_name="cate", dim=embed_dim))
        + tuple(SparseSpec(f"U{i+1}", vocab_size, dim=embed_dim)
                for i in range(n_sparse_extra)),
        seq=(SeqSpec("hist_item", item_v, seq_len, vocab_name="item",
                     dim=embed_dim, session_shape=session_shape),
             SeqSpec("hist_cate", cate_v, seq_len, vocab_name="cate",
                     dim=embed_dim, session_shape=session_shape)),
    )
    batch = {
        "dense": np.zeros((n_rows, 0), np.float32),
        "sparse": sparse.astype(np.int32),
        "seq": {"hist_item": seq_items, "hist_cate": seq_cates},
        "label": y,
        # user/group key for GAUC eval (train/loop.evaluate); drawn from a
        # SEPARATE rng so every pre-existing column stays bit-identical
        # for a given seed
        "group": np.random.default_rng(seed + 90001).integers(
            0, max(n_rows // 20, 2), n_rows).astype(np.int32),
    }
    return fs, batch
