"""SDNE: structural deep network embedding (an autoencoder), in PyTorch on
the card.

Counterpart of ``ml_function_tpu/embedding_pretrain/sdne.py`` (the
reference's Keras SDNE, ``kon/model/embedding/sdne.py:6-91``; losses,
encoder and decoder ``walk_core_model.py:158-199``):
- 2nd-order loss: reconstruct adjacency rows, nonzero entries up-weighted β;
- 1st-order loss: α·Σ_ij a_ij‖y_i−y_j‖² (Laplacian form);
- L2 regularization on weights.
Dense adjacency rows per batch, built on the host from CSR. The encoder
and decoder (``enc``, ``dec``: ``ops/core.MLP``s, the JAX keys) live on the
card; their initial parameters come from ``init`` when given (the JAX
package's nested dict), else from a ``torch.Generator`` seeded by
``cfg.seed``; the batch order comes from numpy's ``default_rng(cfg.seed)``,
as the JAX package's does. Adam is optax's rule (``train/optimizers.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.base import init_parameters
from ..ops.core import MLP
from .graph import CSRGraph


@dataclass
class SDNEConfig:
    hidden: Tuple[int, ...] = (256, 128)
    alpha: float = 1e-6
    beta: float = 5.0
    l2: float = 1e-4
    learning_rate: float = 1e-3
    batch_size: int = 512
    epochs: int = 40
    seed: int = 0


def _adj_rows(g: CSRGraph, rows: np.ndarray) -> np.ndarray:
    out = np.zeros((len(rows), g.num_nodes), np.float32)
    for i, v in enumerate(rows):
        lo, hi = g.indptr[v], g.indptr[v + 1]
        out[i, g.indices[lo:hi]] = g.weights[lo:hi]
    return out


def sdne_model(n: int, hidden: Tuple[int, ...]) -> nn.ModuleDict:
    """The encoder n → hidden and the decoder back to n, under the JAX
    package's keys."""
    return nn.ModuleDict({
        "enc": MLP(n, hidden, activation="relu"),
        "dec": MLP(hidden[-1], tuple(reversed(hidden[:-1])) + (n,), activation="relu")})


def sdne_loss(model: nn.ModuleDict, a_rows: torch.Tensor, a_pair: torch.Tensor,
              cfg: SDNEConfig) -> torch.Tensor:
    y = model["enc"](a_rows)
    recon = model["dec"](y)
    b = torch.where(a_rows > 0, cfg.beta, 1.0)
    l2nd = ((recon - a_rows) * b).square().sum(-1).mean()
    # 1st order on consecutive pairs within the batch
    d = (y[:-1] - y[1:]).square().sum(-1)
    l1st = cfg.alpha * (a_pair * d).mean()
    reg = cfg.l2 * sum(p.square().sum() for p in model.parameters())
    return l2nd + l1st + reg


def train_sdne(g: CSRGraph, cfg: SDNEConfig = SDNEConfig(),
               init: Optional[Mapping[str, Any]] = None,
               device: DeviceLike = None) -> np.ndarray:
    """(num_nodes, hidden[-1]) embeddings after ``cfg.epochs`` epochs on
    ``device`` (default: the card)."""
    from ..bridge import params_from_numpy
    from ..train.optimizers import make_optimizer

    dev = resolve_device(device)
    n = g.num_nodes
    model = sdne_model(n, tuple(cfg.hidden))
    if init is None:
        init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    else:
        params_from_numpy(model, init)
    model.to(dev)
    opt = make_optimizer("adam", cfg.learning_rate).init(model)

    rng = np.random.default_rng(cfg.seed)
    for _ in range(cfg.epochs):
        order = rng.permutation(n)
        for i in range(0, n - cfg.batch_size + 1, cfg.batch_size):
            rows = order[i:i + cfg.batch_size]
            a_rows = _adj_rows(g, rows)
            a_pair = a_rows[np.arange(len(rows) - 1), rows[1:]]
            opt.zero_grad(set_to_none=True)
            sdne_loss(model, torch.as_tensor(a_rows, device=dev),
                      torch.as_tensor(a_pair, device=dev), cfg).backward()
            opt.step()
    # final embeddings: encode every node's adjacency row
    out = []
    with torch.no_grad():
        for i in range(0, n, cfg.batch_size):
            rows = np.arange(i, min(i + cfg.batch_size, n))
            out.append(model["enc"](torch.as_tensor(_adj_rows(g, rows), device=dev))
                       .cpu().numpy())
    return np.concatenate(out, axis=0)
