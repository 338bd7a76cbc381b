"""Training over the ``(data, model)`` mesh: the sharded state and steps.

Counterpart of ``ml_function_tpu/parallel/train.py``. Layout:

- the batch: each rank holds its data coordinate's rows (``shard_batch``);
- the embedding tables (``embedding.table*``/``linear*``) and the auxiliary
  vocab-row tables (FFM's ``ffm``, OENN's ``order{k}``): padded with zero
  rows and row-sharded over ``model``; their optimizer moments live beside
  them, because the optimizer is bound to the blocks;
- MMoE's expert stacks (``experts.w.*``/``experts.b.*``): the leading
  expert axis sharded over ``model`` (expert parallelism);
- every other parameter (the ``align{d}`` projections too) replicated.

The step sums the gradients of every parameter over the data group only:
the ranks of one model group compute the same dense forward and backward
from the same batch shard, so their replicated parameters' gradients are
copies, and each table block's gradient is already its rows' own. The loss
is the global batch's: the weighted BCE divides by the global Σw (one
scalar ``all_reduce``), an auxiliary term that sums over the batch rows
(``emb_l2``) enters each rank whole, and one that is a batch mean or a
function of the parameters enters at 1/data, so that the data group's sum
counts it once. BatchNorm takes the global batch's moments under the
context (``ops/core.py``).

The reference builds each shard inside jit, so no process ever holds a full
table. The port builds the model (or takes it) in host memory and moves
only this rank's blocks to its device (``ROADMAP.md`` D5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..bridge import shard_params_from_numpy
from ..models.base import as_tensors
from ..ops.embedding import has_int8_tables
from ..train.loop import TrainState
from ..train.metrics import (bce_with_logits, init_metrics, metrics_summary,
                             update_metrics)
from . import comm
from .context import sharded_embeddings
from .embedding import ShardedLookup, pad_table_for_shards
from .mesh import MODEL_AXIS, Mesh
from .multihost import global_metrics

# auxiliary terms that sum over the batch's rows: each rank's share enters
# whole; every other term is a batch mean or a function of the parameters
BATCH_SUM_AUX = ("emb_l2",)


def _is_table_name(name: str) -> bool:
    keys = name.split(".")
    return "embedding" in keys and any(k.startswith(("table", "linear")) for k in keys)


def _is_expert_name(name: str) -> bool:
    return "experts" in name.split(".")


def aux_table_keys(model: nn.Module) -> Tuple[str, ...]:
    """The model's top-level (total_vocab, ·) parameters outside its
    FusedEmbedding (FFM's ``ffm``, OENN's ``order{k}``)."""
    v = model.feature_set.total_vocab
    return tuple(k for k, p in model.named_parameters(recurse=False)
                 if p.dim() == 2 and p.shape[0] == v)


def param_spec_tree(model: nn.Module, aux_keys: Tuple[str, ...] = ()
                    ) -> Dict[str, tuple]:
    """Each parameter's sharding by its dotted name, as the reference's
    PartitionSpec tree: ``('model', None, …)`` for the tables, the aux
    tables of ``aux_keys`` and the expert stacks (the leading axis over
    ``model``), ``()`` for a replicated one."""
    out = {}
    for name, p in model.named_parameters():
        lead = (_is_table_name(name) or name in aux_keys or _is_expert_name(name))
        out[name] = (MODEL_AXIS,) + (None,) * (p.dim() - 1) if lead and p.dim() >= 2 else ()
    return out


def _pad_tables(tree: Mapping[str, Any], num_shards: int,
                aux_keys: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The tables (and the aux tables of ``aux_keys``) of a flat
    ``{dotted name: tensor}`` dict padded for ``num_shards`` row blocks."""
    return {k: pad_table_for_shards(v, num_shards)
            if (_is_table_name(k) or k in aux_keys) and v.dim() >= 2 else v
            for k, v in tree.items()}


@dataclass
class ShardedTrainState(TrainState):
    """A ``TrainState`` whose model holds this rank's blocks: ``mesh``, and
    ``layout``, each sharded parameter's dotted name → (its rows before the
    padding, its padded rows)."""
    mesh: Optional[Mesh] = None
    layout: Dict[str, Tuple[int, int]] = field(default_factory=dict)


def _param_slot(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    mod = model
    for k in path:
        mod = getattr(mod, k)
    return mod, leaf


@torch.no_grad()
def shard_model_(model: nn.Module, mesh: Mesh) -> Dict[str, Tuple[int, int]]:
    """Replace each sharded parameter (``param_spec_tree``) by this rank's
    row block of its padded value, on ``mesh.device``, move the rest of the
    model there, and return the layout (name → (rows, padded rows))."""
    if has_int8_tables(model):
        raise ValueError("int8 serving tables are not sharded")
    m, j = mesh.model, mesh.model_index
    aux = aux_table_keys(model)
    whole = {name: _param_slot(model, name) for name, spec
             in param_spec_tree(model, aux).items() if spec}
    values = {name: getattr(mod, leaf).detach() for name, (mod, leaf) in whole.items()}
    for name, t in values.items():
        if _is_expert_name(name) and t.shape[0] % m:
            raise ValueError(f"{name}: {t.shape[0]} experts do not divide over "
                             f"a model axis of {m}")
    layout = {}
    for name, t in _pad_tables(values, m, aux).items():
        mod, leaf = whole[name]
        r = t.shape[0] // m
        mod.register_parameter(leaf, nn.Parameter(t[j * r:(j + 1) * r].to(mesh.device,
                                                                             copy=True)))
        layout[name] = (values[name].shape[0], t.shape[0])
    model.to(mesh.device)
    return layout


def create_sharded_state(model: nn.Module, optimizer, mesh: Mesh,
                         init_params=None, seed: int = 0) -> ShardedTrainState:
    """Shard ``model`` in place over ``mesh`` (``shard_model_``), fill it
    from ``init_params`` when given (``(params, model_state)`` or params
    alone: the JAX package's nested dict or flat ``params/...`` keys, full
    or already padded, ``bridge.shard_params_from_numpy``), and bind
    ``optimizer`` (an ``OptimizerSpec``) to the blocks. ``seed`` seeds the
    state's generator."""
    layout = shard_model_(model, mesh)
    if init_params is not None:
        params, state = (init_params if isinstance(init_params, tuple)
                         else (init_params, None))
        shard_params_from_numpy(model, params, mesh, layout, state=state)
    return ShardedTrainState(model, optimizer.init(model), 0,
                             torch.Generator().manual_seed(seed), mesh, layout)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: its data coordinate's block."""
    n = len(batch["label"])
    if n % mesh.data:
        raise ValueError(f"batch {n} % data axis {mesh.data} != 0")
    per = n // mesh.data
    lo = mesh.data_index * per

    def take(v):
        return ({k: take(x) for k, x in v.items()} if isinstance(v, Mapping)
                else v[lo:lo + per])

    return {k: take(v) for k, v in batch.items()}


def global_loss(model_out, batch, mesh: Mesh):
    """(this rank's share of the global loss, its share of the BCE) from
    ``model(batch, train=True)``'s output: the shares sum to the global
    batch's over the data group."""
    logits, _, aux = model_out
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(logits)
    wsum = comm.all_reduce_(w.sum().detach().clone(), mesh.data_group)
    bce = (bce_with_logits(logits, batch["label"]) * w).sum() / torch.clamp_min(wsum, 1.0)
    total = bce
    for k, v in (aux or {}).items():
        total = total + (v if k in BATCH_SUM_AUX else v / mesh.data)
    return total, bce


def sync_grads(params, mesh: Mesh) -> None:
    """Sum the gradients of ``params`` over the data group, in one flat
    all-reduce."""
    if mesh.data_group is None or mesh.data == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    comm.all_reduce_(flat, mesh.data_group)
    pos = 0
    for g in grads:
        g.copy_(flat[pos:pos + g.numel()].view_as(g))
        pos += g.numel()


def overflow_lookups(fs, batch) -> list:
    """The global ids of every primary-width lookup of a batch: the sparse
    fields and each sequence (what the a2a overflow counter covers)."""
    out = []
    if "sparse" in batch and len(fs.sparse):
        offs = torch.as_tensor(fs.sparse_offsets(), device=batch["sparse"].device)
        out.append(batch["sparse"].long() + offs[None, :])
    for name, ids in (batch.get("seq") or {}).items():
        out.append(ids.long() + fs.seq_offset(name))
    return out


def make_sharded_train_step(model: nn.Module, optimizer, mesh: Mesh,
                            exchange: str = "psum", compress=None, capacity=None,
                            seq_shard: bool = False,
                            pp_microbatches: int = 0) -> Callable:
    """``train_step(batch) -> {"loss", "bce", "logits", "label", "weight"}``
    on this rank's rows (``shard_batch``) of a global batch: the forward
    under the sharded context, the global loss, the backward, the gradients
    summed over the data group and one update of ``optimizer`` (bound to the
    sharded model). ``loss`` and ``bce`` are the global batch's;
    ``logits``, ``label`` and ``weight`` this rank's. With a finite a2a
    ``capacity`` on a one-width schema the output carries ``a2a_overflow``,
    the global count of unique ids dropped this step. ``seq_shard=True``
    shards the long streams' key axes over ``model`` (SIM's soft search);
    ``pp_microbatches`` > 0 pipelines AutoInt's block stack over ``model``.
    The parameters stay replicated over the model group: a pipelined rank
    reads only its stage's blocks, and ``parallel/pipeline.py`` sums the
    stage gradients over the group inside the backward, so each rank holds
    them all before ``sync_grads``."""
    if has_int8_tables(model):
        raise ValueError("a model with int8 serving tables cannot train")
    fs = model.feature_set
    observe = exchange == "a2a" and capacity is not None and not fs.mixed_width
    obs = ShardedLookup(mesh, fs, mode="a2a", capacity=capacity) if observe else None
    dev = mesh.device
    params = list(model.parameters())

    def train_step(batch):
        batch = as_tensors(batch, dev)
        optimizer.zero_grad(set_to_none=True)
        with sharded_embeddings(mesh, mode=exchange, compress=compress,
                                capacity=capacity, seq_shard=seq_shard,
                                pp_microbatches=pp_microbatches):
            out = model(batch, train=True)
            total, bce = global_loss(out, batch, mesh)
            total.backward()
        sync_grads(params, mesh)
        optimizer.step()
        pair = comm.all_reduce_(torch.stack([total.detach(), bce.detach()]),
                                mesh.data_group)
        res = {"loss": pair[0], "bce": pair[1], "logits": out[0].detach(),
               "label": batch["label"], "weight": batch.get("weight")}
        if observe:
            res["a2a_overflow"] = sum(obs.overflow_count(g)
                                      for g in overflow_lookups(fs, batch))
        return res

    return train_step


def make_sharded_eval_step(model: nn.Module, mesh: Mesh, exchange: str = "psum",
                           compress=None, seq_shard: bool = False) -> Callable:
    """``eval_step(metrics, batch) -> (metrics, logits)`` on this rank's
    rows; the metrics stay this rank's until ``multihost.global_metrics``
    sums them over the data group."""
    dev = mesh.device

    @torch.no_grad()
    def eval_step(metrics, batch):
        batch = as_tensors(batch, dev)
        with sharded_embeddings(mesh, mode=exchange, compress=compress,
                                seq_shard=seq_shard):
            logits, _, _ = model(batch, train=False)
        return update_metrics(metrics, logits, batch["label"],
                              batch.get("weight")), logits

    return eval_step


def evaluate_sharded(model: nn.Module, mesh: Mesh, data: Dict[str, Any],
                     batch_size: int, exchange: str = "psum",
                     compress=None, seq_shard: bool = False) -> Dict[str, float]:
    """Streaming AUC, logloss and count over ``data`` (every rank passes the
    whole dataset and scores its rows of each batch), merged over the data
    group."""
    from ..train.loop import iter_batches
    step = make_sharded_eval_step(model, mesh, exchange, compress, seq_shard)
    em = init_metrics(device=mesh.device)
    for b in iter_batches(data, batch_size):
        em, _ = step(em, shard_batch(b, mesh))
    return metrics_summary(global_metrics(em, mesh))
