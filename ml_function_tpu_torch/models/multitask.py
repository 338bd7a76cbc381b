"""Multi-task models of the port: MMoE.

Counterpart of ``ml_function_tpu/models/multitask.py``; ESMM and PLE come
with a later slice. The model returns its primary task's logit, which the
train loop scores against ``label``, and the other tasks' BCE terms in
``aux`` (``<task>_bce``), each only when the batch carries that task's
array, so scoring needs features alone. Those terms are the plain mean
over the batch: the ``weight`` mask of a padded tail batch does not reach
them, as in the reference (``ROADMAP.md`` R5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..features.schema import FeatureSet
from ..ops.base import glorot_uniform
from ..ops.core import MLP, flatten_concat
from ..ops.embedding import FusedEmbedding
from ..train.metrics import bce_with_logits
from .base import Model, embed_inputs, stateless


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unweighted mean BCE with logits (the reference's ``_bce``)."""
    return bce_with_logits(logits, y).mean()


class _Experts(nn.Module):
    """The experts stacked on a leading axis, a layer each: ``w.{i}``
    (E, in, out), glorot, and ``b.{i}`` (E, out), zeros."""

    def __init__(self, n_experts: int, dims: Tuple[int, ...]):
        super().__init__()
        self.w = nn.ParameterList(
            [nn.Parameter(torch.empty(n_experts, dims[i], dims[i + 1]))
             for i in range(len(dims) - 1)])
        self.b = nn.ParameterList(
            [nn.Parameter(torch.empty(n_experts, dims[i + 1]))
             for i in range(len(dims) - 1)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w, b in zip(self.w, self.b):
            w.copy_(glorot_uniform(w.shape, generator))
            b.zero_()


class _Gates(nn.Module):
    """A softmax gate over the experts a task: ``w`` (T, in, E), glorot,
    and ``b`` (T, E), zeros."""

    def __init__(self, n_tasks: int, in_dim: int, n_experts: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_tasks, in_dim, n_experts))
        self.b = nn.Parameter(torch.empty(n_tasks, n_experts))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.w.copy_(glorot_uniform(self.w.shape, generator))
        self.b.zero_()


def MMoE(fs: FeatureSet, n_experts: int = 4,
         expert_hidden: Tuple[int, ...] = (64,),
         tower_hidden: Tuple[int, ...] = (32,),
         tasks: Tuple[str, ...] = ("label", "click"),
         task_weights: Optional[Tuple[float, ...]] = None) -> Model:
    """Multi-gate mixture of experts over [flattened embeddings ∥ dense]:
    every expert layer of all experts is one f32 einsum, each task mixes
    the experts' outputs through its own softmax gate and scores them with
    its ``tower{t}`` MLP. ``tasks[0]`` is the primary target; ``tasks[1:]``
    name batch arrays whose BCE terms, times ``task_weights``, ride in
    ``aux``. The expert and gate products are plain f32, the towers the
    usual ``bf16_matmul`` sites."""
    f, d, nd = len(fs.sparse), fs.embed_dim, len(fs.dense)
    in_dim = f * d + nd
    n_tasks = len(tasks)
    weights = task_weights or (1.0,) * n_tasks
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "gates": _Gates(n_tasks, in_dim, n_experts),
             "experts": _Experts(n_experts, (in_dim,) + tuple(expert_hidden))}
    for t in range(n_tasks):
        parts[f"tower{t}"] = MLP(expert_hidden[-1], tower_hidden,
                                 activation="relu", out_dim=1)

    def fwd(m, batch, train):
        inp = embed_inputs(m.embedding, batch, with_linear=False)
        h = flatten_concat([inp["emb"]] + ([inp["dense"]] if nd else []))
        x = h[:, None, :].expand(h.shape[0], n_experts, in_dim)
        for w, b in zip(m.experts.w, m.experts.b):
            x = torch.relu(torch.einsum("bei,eio->beo", x, w) + b)
        gates = torch.softmax(torch.einsum("bi,tie->bte", h, m.gates.w)
                              + m.gates.b, dim=-1)                # (B, T, E)
        mixed = torch.einsum("bte,beo->bto", gates, x)            # (B, T, out)
        logits = [getattr(m, f"tower{t}")(mixed[:, t], train)[:, 0]
                  for t in range(n_tasks)]
        aux = {"emb_l2": inp["l2"]}
        for t in range(1, n_tasks):
            if tasks[t] in batch:
                aux[f"{tasks[t]}_bce"] = weights[t] * _bce(logits[t], batch[tasks[t]])
        return logits[0], aux

    return stateless("MMoE", fs, parts, fwd)
