"""Embedding evaluation: t-SNE projection plots + quantitative scores.

A copy in the port of ``ml_function_tpu/embedding_pretrain/evaluate.py``
(numpy, with sklearn and matplotlib imported where used: host-side).

Counterpart of the reference's t-SNE scatter eval
(``kon/model/embedding/evaluate.py:8-34``) plus quantitative metrics the
reference eyeballs: silhouette over labels and intra/inter-class cosine gap.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np


def _stack(embs: Mapping[str, np.ndarray], labels: Mapping[str, int]):
    names = [n for n in embs if n in labels]
    x = np.stack([embs[n] for n in names])
    y = np.asarray([labels[n] for n in names])
    return names, x, y


def cosine_class_gap(embs: Mapping[str, np.ndarray],
                     labels: Mapping[str, int]) -> float:
    """Mean intra-class − inter-class cosine similarity (higher = better)."""
    _, x, y = _stack(embs, labels)
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    sim = x @ x.T
    same = (y[:, None] == y[None, :]) & ~np.eye(len(y), dtype=bool)
    diff = (y[:, None] != y[None, :])
    return float(sim[same].mean() - sim[diff].mean())


def silhouette(embs: Mapping[str, np.ndarray],
               labels: Mapping[str, int]) -> float:
    from sklearn.metrics import silhouette_score
    _, x, y = _stack(embs, labels)
    return float(silhouette_score(x, y))


def tsne_plot(embs: Mapping[str, np.ndarray], labels: Mapping[str, int],
              out_path: str, perplexity: float = 20.0,
              seed: int = 0) -> str:
    """t-SNE scatter colored by label (reference plot_embeddings,
    evaluate.py:15-34). Saves a PNG; headless-safe."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    _, x, y = _stack(embs, labels)
    p = min(perplexity, max(2.0, (len(x) - 1) / 3))
    z = TSNE(n_components=2, perplexity=p, random_state=seed).fit_transform(x)
    fig, ax = plt.subplots(figsize=(6, 5))
    for c in np.unique(y):
        sel = y == c
        ax.scatter(z[sel, 0], z[sel, 1], s=8, label=str(c))
    ax.legend(markerscale=2, fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def read_labels(path: str) -> Dict[str, int]:
    """'node label' lines (reference wiki ``Wiki_labels.txt`` format)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out
