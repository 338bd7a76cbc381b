"""Multi-task models of the port: ESMM, MMoE and PLE.

Counterpart of ``ml_function_tpu/models/multitask.py``. A model returns its
primary logit, which the train loop scores against ``label`` (ESMM:
logit(pCTCVR); MMoE and PLE: the first task's), and the other tasks' BCE
terms in ``aux`` (``<task>_bce``), each only when the batch carries that
task's array, so scoring needs features alone. Those terms are the plain
mean over the batch: the ``weight`` mask of a padded tail batch does not
reach them, as in the reference (``ROADMAP.md`` R5).

Under a sharded state MMoE's expert stacks hold this rank's block of
experts (``parallel/train.py``, expert parallelism): the rank runs its
block on its batch shard, and an ``all_gather`` over the model group
assembles the (B, E, ·) stack before the gates mix it; the blocks'
cotangents of their shared input are summed over the group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..features.schema import FeatureSet
from ..ops.base import glorot_uniform
from ..ops.core import MLP, flatten_concat
from ..ops.embedding import FusedEmbedding
from ..parallel import context as pctx
from ..parallel.comm import all_gather_cat, sum_grad
from ..train.metrics import bce_with_logits
from .base import Model, embed_inputs, stateless


def _shared_input(m, batch, nd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[flattened embeddings ∥ dense] (B, F·D + Nd) and the embedding L2."""
    inp = embed_inputs(m.embedding, batch, with_linear=False)
    return flatten_concat([inp["emb"]] + ([inp["dense"]] if nd else [])), inp["l2"]


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unweighted mean BCE with logits (the reference's ``_bce``)."""
    return bce_with_logits(logits, y).mean()


def _task_aux(l2, logits, batch, tasks, weights) -> dict:
    """``emb_l2`` and, for each secondary task the batch carries, its
    weighted BCE."""
    aux = {"emb_l2": l2}
    for t in range(1, len(tasks)):
        if tasks[t] in batch:
            aux[f"{tasks[t]}_bce"] = weights[t] * _bce(logits[t], batch[tasks[t]])
    return aux


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


def ESMM(fs: FeatureSet, hidden: Tuple[int, ...] = (128, 64),
         ctr_weight: float = 1.0) -> Model:
    """Entire-Space Multi-task Model: ``ctr`` and ``cvr`` ReLU towers over
    [flattened embeddings ∥ dense]; the logit is logit(pCTCVR), from
    ls = min(logsig(l_ctr) + logsig(l_cvr), −1e-7) as ls − log(−expm1(ls)).
    ``aux['ctr_bce']`` (times ``ctr_weight``) scores the CTR tower against
    ``batch['click']`` when the batch carries it."""
    f, d, nd = len(fs.sparse), fs.embed_dim, len(fs.dense)
    in_dim = f * d + nd
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "ctr": MLP(in_dim, hidden, activation="relu", out_dim=1),
             "cvr": MLP(in_dim, hidden, activation="relu", out_dim=1)}

    def fwd(m, batch, train):
        h, l2 = _shared_input(m, batch, nd)
        l_ctr = m.ctr(h, train)[:, 0]
        l_cvr = m.cvr(h, train)[:, 0]
        ls = F.logsigmoid(l_ctr) + F.logsigmoid(l_cvr)
        ls = torch.minimum(ls, ls.new_full((), -1e-7))  # pCTCVR < 1 under bf16 towers
        logit = ls - torch.log(-torch.expm1(ls))
        aux = {"emb_l2": l2}
        if "click" in batch:
            aux["ctr_bce"] = ctr_weight * _bce(l_ctr, batch["click"])
        return logit, aux

    return stateless("ESMM", fs, parts, fwd)


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
        h, l2 = _shared_input(m, batch, nd)
        e_local = m.experts.w[0].shape[0]         # this rank's expert block
        group = pctx.active_mesh().model_group if e_local != n_experts else None
        # each rank's block sends back only its part of h's cotangent
        x = sum_grad(h, group)[:, None, :].expand(h.shape[0], e_local, in_dim)
        for w, b in zip(m.experts.w, m.experts.b):
            x = torch.relu(torch.einsum("bei,eio->beo", x, w) + b)
        x = all_gather_cat(x, group, dim=1)
        gates = torch.softmax(torch.einsum("bi,tie->bte", h, m.gates.w)
                              + m.gates.b, dim=-1)                # (B, T, E)
        mixed = torch.einsum("bte,beo->bto", gates, x)            # (B, T, out)
        logits = [getattr(m, f"tower{t}")(mixed[:, t], train)[:, 0]
                  for t in range(n_tasks)]
        return logits[0], _task_aux(l2, logits, batch, tasks, weights)

    return stateless("MMoE", fs, parts, fwd)


class _PLELayer(nn.Module):
    """One extraction layer: the layer's experts ``w`` (E, in, out), glorot,
    and ``b`` (E, out); each task's gate ``gate_w.{t}`` (in, |own experts|)
    and ``gate_b.{t}``; the shared gate ``shared_gate_w`` (in, E) and
    ``shared_gate_b`` (E,). Weights glorot, biases zero."""

    def __init__(self, in_dim: int, out_dim: int, n_exp: int, own_sizes):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_exp, in_dim, out_dim))
        self.b = nn.Parameter(torch.empty(n_exp, out_dim))
        self.gate_w = nn.ParameterList(
            [nn.Parameter(torch.empty(in_dim, n)) for n in own_sizes])
        self.gate_b = nn.ParameterList(
            [nn.Parameter(torch.empty(n)) for n in own_sizes])
        self.shared_gate_w = nn.Parameter(torch.empty(in_dim, n_exp))
        self.shared_gate_b = nn.Parameter(torch.empty(n_exp))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.w, *self.gate_w, self.shared_gate_w):
            w.copy_(glorot_uniform(w.shape, generator))
        for b in (self.b, *self.gate_b, self.shared_gate_b):
            b.zero_()


def PLE(fs: FeatureSet, n_task_experts: int = 2, n_shared_experts: int = 2,
        n_layers: int = 2, expert_dim: int = 64,
        tower_hidden: Tuple[int, ...] = (32,),
        tasks: Tuple[str, ...] = ("label", "click"),
        task_weights: Optional[Tuple[float, ...]] = None) -> Model:
    """Progressive Layered Extraction: ``n_layers`` CGC layers, in each of
    which every task owns ``n_task_experts`` experts and all tasks share
    ``n_shared_experts``. A task's gate mixes its own and the shared
    experts' outputs into its stream; the shared gate mixes all of them
    into the shared stream, which the next layer's shared experts read.
    Expert e reads the stream of task e // n_task_experts (the shared one
    past the tasks'). Experts, gates and selections are plain f32
    products; the ``tower{t}`` MLPs the usual ``bf16_matmul`` sites.

    The reference applies the shared gate at the last layer too and never
    reads its output, so that gate's parameters get a zero gradient there
    (``ROADMAP.md`` R6); the port keeps them for the bridge and skips the
    unread product, so they get none."""
    f, d, nd = len(fs.sparse), fs.embed_dim, len(fs.dense)
    in_dim = f * d + nd
    n_tasks = len(tasks)
    weights = task_weights or (1.0,) * n_tasks
    n_exp = n_tasks * n_task_experts + n_shared_experts
    own = [list(range(t * n_task_experts, (t + 1) * n_task_experts))
           + list(range(n_tasks * n_task_experts, n_exp)) for t in range(n_tasks)]
    reads = [min(e // n_task_experts, n_tasks) for e in range(n_exp)]
    dims = [in_dim] + [expert_dim] * n_layers
    parts = {"embedding": FusedEmbedding(fs, with_linear=False),
             "layers": nn.ModuleList(
                 [_PLELayer(dims[i], dims[i + 1], n_exp, [len(o) for o in own])
                  for i in range(n_layers)])}
    for t in range(n_tasks):
        parts[f"tower{t}"] = MLP(expert_dim, tower_hidden, activation="relu",
                                 out_dim=1)
        parts[f"own{t}"] = torch.tensor(own[t], dtype=torch.long)   # its experts

    def fwd(m, batch, train):
        h, l2 = _shared_input(m, batch, nd)
        streams = [h] * (n_tasks + 1)
        for li, layer in enumerate(m.layers):
            x = torch.stack([streams[r] for r in reads], dim=1)   # (B, E, in)
            out = torch.relu(torch.einsum("bei,eio->beo", x, layer.w) + layer.b)
            new = []
            for t in range(n_tasks):
                g = torch.softmax(streams[t] @ layer.gate_w[t] + layer.gate_b[t], dim=-1)
                new.append(torch.einsum("be,beo->bo", g,
                                        out.index_select(1, getattr(m, f"own{t}"))))
            if li < n_layers - 1:
                gs = torch.softmax(streams[n_tasks] @ layer.shared_gate_w
                                   + layer.shared_gate_b, dim=-1)
                new.append(torch.einsum("be,beo->bo", gs, out))
            streams = new
        logits = [getattr(m, f"tower{t}")(streams[t], train)[:, 0]
                  for t in range(n_tasks)]
        return logits[0], _task_aux(l2, logits, batch, tasks, weights)

    return stateless("PLE", fs, parts, fwd)
