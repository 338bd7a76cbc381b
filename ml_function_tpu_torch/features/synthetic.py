"""Synthetic CTR data with planted structure (numpy only).

The port's copies of ``make_criteo_like``, ``make_behavior_data``,
``make_interest_drift_data``, ``make_image_ctr_data`` and ``make_cvr_data`` from
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


def make_interest_drift_data(
    n_rows: int = 4000,
    n_items: int = 60,
    seq_len: int = 24,
    embed_dim: int = 8,
    noise: float = 0.1,
    seed: int = 0,
) -> Tuple[FeatureSet, Dict[str, np.ndarray]]:
    """Interest-drift data: the first half of each history follows a latent
    anchor A, the second half an anchor B; the candidate is drawn near one of
    them and the label says whether it matches the recent anchor (B), with
    a ``noise`` share of labels flipped. A position-blind model cannot tell
    the two classes apart."""
    rng = np.random.default_rng(seed)
    iv = n_items + 1
    emb = rng.normal(0, 1.0, (iv, 6))
    emb[0] = 0
    half = seq_len // 2
    hist = np.zeros((n_rows, seq_len), np.int32)
    cand = np.zeros(n_rows, np.int32)
    y = np.zeros(n_rows, np.float32)
    for i in range(n_rows):
        a, b = rng.normal(0, 1, 6), rng.normal(0, 1, 6)
        for anchor, sl in ((a, slice(0, half)), (b, slice(half, seq_len))):
            s = emb[1:] @ anchor
            p = np.exp(s - s.max())
            p /= p.sum()
            hist[i, sl] = rng.choice(np.arange(1, iv), half, p=p)
        recent = rng.random() < 0.5
        s = emb[1:] @ (b if recent else a)
        p = np.exp(s - s.max())
        p /= p.sum()
        cand[i] = rng.choice(np.arange(1, iv), p=p)
        y[i] = 1.0 if recent else 0.0
        if rng.random() < noise:
            y[i] = 1.0 - y[i]
    fs = FeatureSet(
        sparse=(SparseSpec("item", iv, vocab_name="item", dim=embed_dim),),
        seq=(SeqSpec("hist_item", iv, seq_len, vocab_name="item",
                     dim=embed_dim),),
    )
    data = {"dense": np.zeros((n_rows, 0), np.float32),
            "sparse": cand[:, None], "seq": {"hist_item": hist}, "label": y}
    return fs, data


def make_image_ctr_data(
    n_rows: int = 8000,
    n_items: int = 100,
    n_cates: int = 10,
    seq_len: int = 12,
    img_dim: int = 16,
    embed_dim: int = 8,
    seed: int = 0,
) -> Tuple[FeatureSet, Dict[str, np.ndarray]]:
    """Image-CTR data (DICM): every item has a unit-norm latent image
    vector (the pad item's is 0), and the label depends on the similarity
    of the ad's image to the mean of the history's images. The batch
    carries the pre-extracted vectors ``image`` (B, img_dim) and
    ``hist_image`` (B, L, img_dim)."""
    rng = np.random.default_rng(seed)
    fs, data = make_behavior_data(n_rows=n_rows, n_items=n_items,
                                  n_cates=n_cates, seq_len=seq_len,
                                  embed_dim=embed_dim, seed=seed)
    item_img = rng.normal(0, 1.0, (n_items + 1, img_dim))
    item_img /= np.linalg.norm(item_img, axis=1, keepdims=True) + 1e-9
    item_img[0] = 0.0
    seq_items = data["seq"]["hist_item"]
    cand = data["sparse"][:, 0]
    hist_image = item_img[seq_items]                       # (N, L, img)
    image = item_img[cand]                                 # (N, img)
    m = (seq_items != 0)
    cnt = np.maximum(m.sum(1, keepdims=True), 1)
    mean_hist = hist_image.sum(1) / cnt
    vis = np.einsum("nd,nd->n", mean_hist, image)
    vis = (vis - vis.mean()) / (vis.std() + 1e-9) * 2.0
    data["label"] = (rng.uniform(size=n_rows) < _sigmoid(vis)).astype(
        np.float32)
    data["image"] = image.astype(np.float32)
    data["hist_image"] = hist_image.astype(np.float32)
    return fs, data


def make_cvr_data(
    n_rows: int = 20000,
    n_dense: int = 4,
    n_sparse: int = 8,
    vocab_size: int = 30,
    embed_dim: int = 8,
    seed: int = 0,
) -> Tuple[FeatureSet, Dict[str, np.ndarray]]:
    """Impression-space CVR data for ESMM, MMoE and PLE: ``click`` from
    ``make_criteo_like``'s planted signal, ``label`` (conversion) observed
    only on clicks, from an independent planted signal."""
    rng = np.random.default_rng(seed)
    fs, batch = make_criteo_like(n_rows, n_dense, n_sparse, vocab_size,
                                 embed_dim, seed)
    click = batch.pop("label")
    sparse = batch["sparse"]
    true_cvr = rng.normal(0, 0.8, (n_sparse, vocab_size))
    cvr_logit = np.stack([true_cvr[f, sparse[:, f]]
                          for f in range(n_sparse)], axis=1).sum(axis=1)
    cvr_logit = (cvr_logit - cvr_logit.mean()) / (cvr_logit.std() + 1e-9) * 2.0
    conv_given_click = (rng.uniform(size=n_rows)
                        < _sigmoid(cvr_logit - 1.0)).astype(np.float32)
    batch["click"] = click
    batch["label"] = click * conv_given_click
    return fs, batch
