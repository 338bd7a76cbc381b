"""Cold-start meta-embedding of the port.

Counterpart of ``ml_function_tpu/models/coldstart.py`` (Pan et al., SIGIR
2019). A generator MLP (``gen``) maps an ad's other fields' embeddings,
detached from the table, to an initial embedding of its target id field,
0.05·tanh of its output, so that new ads start from a learned point.
Meta-training scores batch a with the generated row, takes one SGD step on
that row (``cold_lr``) and scores batch b with the result; the objective
α·loss_a + (1 − α)·loss_b reaches the generator through the inner step,
second-order term included (``torch.autograd.grad(..., create_graph=True)``).

The generated rows enter any base model through the batch entry
``emb_override`` that ``models.base.embed_inputs`` honours. The base
model's forward must be twice differentiable: the port's kernels (CIN, the
field attention, the (AU)GRU, the merge-scatter, flash attention) refuse a
second-order gradient (``kernels/_checks.refuse_double_backward``), so a
meta step over a model that reaches one raises instead of dropping the
second-order term.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..features.schema import FeatureSet
from ..ops.base import init_parameters
from ..ops.core import MLP
from ..ops.embedding import FusedEmbedding
from ..train.metrics import bce_with_logits
from ..train.optimizers import OptimizerSpec
from .base import Model, as_tensors


class MetaEmbedding(nn.Module):
    """Meta-embedding generator for one target sparse field; its ``gen``
    is ``MLP((F − 1)·D, hidden, relu, out_dim=D)``, the JAX tree's
    ``{"gen": ...}``, drawn from ``generator`` (default: a CPU generator
    seeded with 0) on ``device`` (default: the CUDA card; raises without
    one unless ``device='cpu'``), as ``get_model`` draws a model."""

    def __init__(self, feature_set: FeatureSet, target: str,
                 hidden: Tuple[int, ...] = (64,), device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if target not in [s.name for s in feature_set.sparse]:
            raise ValueError(f"target {target!r} is not a sparse field")
        self.feature_set, self.target = feature_set, target
        f, d = len(feature_set.sparse), feature_set.embed_dim
        self.gen = MLP((f - 1) * d, hidden, activation="relu", out_dim=d)
        init_parameters(self, generator if generator is not None
                        else torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def generate(self, embedding: FusedEmbedding, batch) -> torch.Tensor:
        """(B, D) generated target-id rows from each example's other
        fields' rows, which are detached (the table is not trained here)."""
        batch = as_tensors(batch, self.gen.head.w.device)
        t = self.feature_set.sparse_index(self.target)
        emb = embedding.sparse(batch["sparse"]).detach()
        others = torch.cat([emb[:, :t, :], emb[:, t + 1:, :]], dim=1)
        return 0.05 * torch.tanh(self.gen(others.reshape(others.shape[0], -1)))

    def meta_loss(self, model: Model, batch_a, batch_b, cold_lr: float = 0.1,
                  alpha: float = 0.1) -> torch.Tensor:
        """α·loss_a(generated) + (1 − α)·loss_b(one SGD step later) on one
        (batch_a, batch_b) pair of the same ads, row for row;
        differentiable in the generator's parameters through the inner
        step."""
        dev = self.gen.head.w.device

        def scored(batch, emb0):
            b = dict(as_tensors(batch, dev))
            b["emb_override"] = {self.target: emb0}
            logits, _, aux = model(b, train=True)
            loss = bce_with_logits(logits, b["label"]).mean()
            return loss + sum(aux.values()) if aux else loss

        emb0 = self.generate(model.embedding, batch_a)
        loss_a = scored(batch_a, emb0)
        (g,) = torch.autograd.grad(loss_a, emb0, create_graph=True)
        loss_b = scored(batch_b, emb0 - cold_lr * g)
        return alpha * loss_a + (1.0 - alpha) * loss_b

    def warm_rows(self, embedding: FusedEmbedding, batch) -> torch.Tensor:
        """Rows for new target ids in ``batch``, to write into the table
        (``table[global_ids] = rows``) before fine-tuning."""
        with torch.no_grad():
            return self.generate(embedding, batch)


def make_meta_batch_pairs(data: Dict[str, Any], fs: FeatureSet, target: str,
                          batch_size: int, seed: int = 0
                          ) -> Iterator[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(batch_a, batch_b) pairs for ``meta_loss``: row i of each is one of
    two disjoint examples of the same target id; ids with one example are
    skipped; whole batches only. The same seed gives the reference's
    pairs (the same ``default_rng`` draws in the same order)."""
    t = fs.sparse_index(target)
    ids = np.asarray(data["sparse"])[:, t]
    rng = np.random.default_rng(seed)
    pairs = []
    by_ad: dict = {}
    for i in rng.permutation(len(ids)):
        by_ad.setdefault(ids[i], []).append(i)
    for rows in by_ad.values():
        for j in range(0, len(rows) - 1, 2):
            pairs.append((rows[j], rows[j + 1]))
    rng.shuffle(pairs)

    def take(rows):
        sl = np.asarray(rows)
        out = {k: ({n: a[sl] for n, a in v.items()} if k == "seq" else v[sl])
               for k, v in data.items()}
        out["weight"] = np.ones(len(sl), np.float32)
        return out

    for s in range(0, len(pairs) - batch_size + 1, batch_size):
        chunk = pairs[s:s + batch_size]
        yield take([a for a, _ in chunk]), take([b for _, b in chunk])


def make_meta_train_step(meta: MetaEmbedding, model: Model,
                         optimizer: Union[OptimizerSpec, torch.optim.Optimizer],
                         cold_lr: float = 0.1, alpha: float = 0.1):
    """``step(batch_a, batch_b) -> loss``: one update of the generator
    (``optimizer``, an ``OptimizerSpec`` it binds to ``meta`` or an
    optimizer already bound to it) by the meta-loss's gradient; the base
    model's parameters get no gradient and stay as they are."""
    opt = optimizer.init(meta) if isinstance(optimizer, OptimizerSpec) else optimizer
    params = list(meta.parameters())

    def step(batch_a, batch_b) -> torch.Tensor:
        loss = meta.meta_loss(model, batch_a, batch_b, cold_lr=cold_lr, alpha=alpha)
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step
