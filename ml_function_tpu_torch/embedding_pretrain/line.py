"""LINE: first- and second-order proximity embeddings, in PyTorch on the
card.

Counterpart of ``ml_function_tpu/embedding_pretrain/line.py`` (the
reference's Keras LINE, ``kon/model/embedding/line.py:8-173`` and
``walk_core_model.py:118-155``): alias-sampled positive edges
(weight-proportional), degree^0.75 negative nodes, logistic losses:
- order 1: σ(u_i·u_j) on undirected closeness;
- order 2: σ(u_i·c_j) with context vectors.
Plain SGD, ``emb − lr·grad``, as the reference's. The batches come from
numpy's ``default_rng(cfg.seed)``, as the JAX package's do; the initial
tables from ``init`` when given, else from a ``torch.Generator`` on the
tables' device seeded by ``cfg.seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..ops.base import normal_init
from .alias import alias_sample, build_alias
from .graph import CSRGraph


@dataclass
class LineConfig:
    dim: int = 64
    order: str = "second"       # first | second | all
    negatives: int = 5
    learning_rate: float = 0.025
    batch_size: int = 1024
    steps: int = 2000
    seed: int = 0


def _proximity(v: torch.Tensor, table: torch.Tensor, dst: torch.Tensor,
               neg: torch.Tensor) -> torch.Tensor:
    u = table[dst]
    un = table[neg]
    return -(F.logsigmoid((v * u).sum(-1)).mean()
             + F.logsigmoid(-torch.einsum("bd,bkd->bk", v, un)).sum(-1).mean())


def train_line(g: CSRGraph, cfg: LineConfig = LineConfig(),
               init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               device: DeviceLike = None) -> np.ndarray:
    """(num_nodes, dim) embeddings after ``cfg.steps`` SGD steps on
    ``device`` (default: the card)."""
    rng = np.random.default_rng(cfg.seed)
    # positive edge sampler ∝ weight (reference edge alias, line.py:55-70)
    e_accept, e_alias = build_alias(g.weights)
    src_of_edge = np.searchsorted(g.indptr, np.arange(g.num_edges),
                                  side="right") - 1
    # negative node sampler ∝ degree^0.75 (line.py:72-80)
    deg = np.maximum(g.degrees(), 1).astype(np.float64) ** 0.75
    n_accept, n_alias = build_alias(deg)

    dev = resolve_device(device)
    dims = (g.num_nodes, cfg.dim)
    if init is None:
        emb = normal_init(dims, torch.Generator(device=dev).manual_seed(cfg.seed),
                          0.5 / cfg.dim)
        ctx = torch.zeros(dims, device=dev)
    else:
        emb, ctx = (torch.tensor(np.asarray(a, np.float32), device=dev) for a in init)
    emb.requires_grad_()
    ctx.requires_grad_()
    lr = cfg.learning_rate
    use_first = cfg.order in ("first", "all")
    use_second = cfg.order in ("second", "all")

    for _ in range(cfg.steps):
        e = alias_sample(e_accept, e_alias, rng, cfg.batch_size)
        src, dst = (torch.as_tensor(a, device=dev) for a in (src_of_edge[e], g.indices[e]))
        neg = torch.as_tensor(alias_sample(n_accept, n_alias, rng,
                                           (cfg.batch_size, cfg.negatives)), device=dev)
        v = emb[src]
        total = 0.0
        if use_first:
            total = total + _proximity(v, emb, dst, neg)
        if use_second:
            total = total + _proximity(v, ctx, dst, neg)
        g_emb, g_ctx = torch.autograd.grad(total, (emb, ctx), allow_unused=True)
        with torch.no_grad():
            if g_emb is not None:
                emb.sub_(lr * g_emb)
            if g_ctx is not None:
                ctx.sub_(lr * g_ctx)
    return emb.detach().cpu().numpy()
