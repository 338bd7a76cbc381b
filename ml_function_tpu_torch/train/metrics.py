"""Streaming metrics: fixed-bin AUC and logloss on the model's device.

Counterpart of ``ml_function_tpu/train/metrics.py``. The accumulator is a
pair of score histograms (4096 bins over sigmoid(logit)) plus the weighted
loss sum and count, updated with one ``index_add`` per histogram per batch;
the AUC is the exact rank statistic of the binned scores (ties get 1/2).
``gauc``, ``calibration`` and ``retrieval_metrics`` are host numpy, copied.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

N_BINS = 4096

MetricState = Dict[str, torch.Tensor]


def init_metrics(n_bins: int = N_BINS, device=None) -> MetricState:
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"pos_hist": z(n_bins), "neg_hist": z(n_bins),
            "loss_sum": z(), "count": z()}


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy on logits (stable). At a logit of
    exactly 0 its gradient is the reference's −y: ``jnp.maximum`` splits a
    tie (1/2) and ``jnp.abs`` takes the positive side (1), where
    ``clamp_min`` and ``abs`` would give 1 and 0, hence 1 − y (``ROADMAP.md``
    R7). A tower of dead ReLUs with a zero head bias scores such logits."""
    pos = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-pos)))


def _batch_terms(state: MetricState, logits: torch.Tensor, labels: torch.Tensor,
                 weights: Optional[torch.Tensor]):
    """One batch's (bins, positive weights, negative weights, loss sum,
    count) for ``state``'s histograms."""
    logits = logits.detach()
    labels = torch.as_tensor(labels, device=logits.device)
    n_bins = state["pos_hist"].shape[0]
    bins = torch.clamp((torch.sigmoid(logits) * n_bins).long(), 0, n_bins - 1)
    w = (torch.ones_like(labels) if weights is None
         else torch.as_tensor(weights, device=logits.device))
    return (bins, labels * w, (1.0 - labels) * w,
            (bce_with_logits(logits, labels) * w).sum(), w.sum())


def update_metrics_(state: MetricState, logits: torch.Tensor,
                    labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> MetricState:
    """Fold one batch into ``state`` in place and return it: its four
    tensors keep their storage, so a CUDA graph that replays the fold adds
    into the same buffers (the reference's ``update_stacked`` folds a
    chained group's (K, B) outputs the same way, one batch after another)."""
    bins, pos, neg, loss, count = _batch_terms(state, logits, labels, weights)
    state["pos_hist"].index_add_(0, bins, pos)
    state["neg_hist"].index_add_(0, bins, neg)
    state["loss_sum"].add_(loss)
    state["count"].add_(count)
    return state


def update_metrics(state: MetricState, logits: torch.Tensor,
                   labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> MetricState:
    """``update_metrics_``'s fold into new tensors (the same sums)."""
    bins, pos, neg, loss, count = _batch_terms(state, logits, labels, weights)
    return {"pos_hist": state["pos_hist"].index_add(0, bins, pos),
            "neg_hist": state["neg_hist"].index_add(0, bins, neg),
            "loss_sum": state["loss_sum"] + loss, "count": state["count"] + count}


def compute_auc(state: MetricState) -> torch.Tensor:
    pos, neg = state["pos_hist"], state["neg_hist"]
    # P(score_pos > score_neg) + 0.5 P(tie), over binned scores
    neg_below = torch.cumsum(neg, 0) - neg
    correct = (pos * neg_below).sum() + 0.5 * (pos * neg).sum()
    total = pos.sum() * neg.sum()
    return torch.where(total > 0, correct / total, torch.full_like(total, 0.5))


def compute_logloss(state: MetricState) -> torch.Tensor:
    return state["loss_sum"] / torch.clamp_min(state["count"], 1.0)


def merge_metrics(a: MetricState, b: MetricState) -> MetricState:
    return {k: a[k] + b[k] for k in a}


def metrics_summary(state: MetricState) -> Dict[str, float]:
    return {
        "auc": float(compute_auc(state)),
        "logloss": float(compute_logloss(state)),
        "count": float(state["count"]),
    }


# ---------------------------------------------------------------------------
# Eval-side ranking and calibration metrics (host numpy, on gathered
# predictions).

def gauc(labels, probs, groups, min_size: int = 2):
    """Group-averaged AUC: impression-weighted mean of per-group AUCs over
    groups that contain both classes (Zhou et al., DIN §6.2). Returns
    (gauc, n_groups_used)."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    probs = np.asarray(probs, np.float64).reshape(-1)
    groups = np.asarray(groups).reshape(-1)
    order = np.argsort(groups, kind="stable")
    labels, probs, groups = labels[order], probs[order], groups[order]
    bounds = np.flatnonzero(np.r_[True, groups[1:] != groups[:-1], True])
    total_w = 0.0
    acc = 0.0
    used = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        y, p = labels[lo:hi], probs[lo:hi]
        n = hi - lo
        npos = y.sum()
        if n < min_size or npos == 0 or npos == n:
            continue
        r = np.empty(n)
        o = np.argsort(p, kind="stable")
        ps = p[o]
        # average ranks with ties
        rk = np.arange(1, n + 1, dtype=np.float64)
        ties = np.r_[True, ps[1:] != ps[:-1]]
        grp = np.cumsum(ties) - 1
        cnt = np.bincount(grp)
        csum = np.bincount(grp, weights=rk)
        r[o] = (csum / cnt)[grp]
        auc = (r[y > 0].sum() - npos * (npos + 1) / 2) / (npos * (n - npos))
        acc += n * auc
        total_w += n
        used += 1
    return (acc / total_w if total_w else 0.5), used


def calibration(labels, probs, n_bins: int = 20):
    """Predicted-vs-observed CTR: overall ratio (Σp/Σy) and expected
    calibration error over equal-width probability bins."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    probs = np.asarray(probs, np.float64).reshape(-1)
    ratio = probs.sum() / max(labels.sum(), 1e-12)
    bins = np.clip((probs * n_bins).astype(np.int64), 0, n_bins - 1)
    cnt = np.bincount(bins, minlength=n_bins).astype(np.float64)
    psum = np.bincount(bins, weights=probs, minlength=n_bins)
    ysum = np.bincount(bins, weights=labels, minlength=n_bins)
    nz = cnt > 0
    ece = float(np.sum(np.abs(psum[nz] - ysum[nz])) / max(len(labels), 1))
    return {"ratio": float(ratio), "ece": ece}


def retrieval_metrics(user_vecs, item_vecs, true_items, ks=(1, 10, 50)):
    """Hit-rate@K and mean reciprocal rank over a candidate corpus.

    ``user_vecs`` (Q, D) or multi-interest (Q, I, D); ``item_vecs`` (N, D);
    ``true_items`` (Q,) corpus indices. Scores are inner products, the max
    over the interest axis when there is one."""
    u = np.asarray(user_vecs, np.float32)
    v = np.asarray(item_vecs, np.float32)
    t = np.asarray(true_items).reshape(-1)
    scores = u @ v.T if u.ndim == 2 else np.max(
        np.einsum("qid,nd->qin", u, v), axis=1)          # (Q, N)
    # rank of the true item per query (1-based; ties counted against us)
    true_s = scores[np.arange(len(t)), t]
    rank = 1 + np.sum(scores > true_s[:, None], axis=1)
    out = {f"hit@{k}": float(np.mean(rank <= k)) for k in ks}
    out["mrr"] = float(np.mean(1.0 / rank))
    return out
