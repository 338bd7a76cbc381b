"""The sparse-row path: embedding tables updated row by row.

Counterpart of ``ml_function_tpu/train/sparse.py``. The dense path
(``loop.make_train_step``) forms a (V, W) gradient for every table and
streams each table and its optimizer moments every step; here no table
gradient forms:

1. **record**: the forward runs under a ``RowTape`` in record mode and
   ``torch.no_grad()``: every lookup logs its (column group, global ids) and
   returns zeros. Eager PyTorch runs the whole forward for that (XLA keeps
   only the id expressions), which is this path's price;
2. **gather**: the rows of the recorded ids are read outside the loss;
3. **inject + backward**: the forward runs again with the tape in inject
   mode, its lookups return those rows, which are differentiated as inputs,
   so each table's cotangent stays (N, W) occurrence rows;
4. **dense update**: the dense optimizer, built over every parameter but
   the row tables (``sparse_dense_tree``), so it holds no (V, ·) state;
5. **row update**: per group, duplicate ids are summed (``dedup_sum``) and a
   row optimizer (Adagrad, lazy Adam) reads, updates and writes back only
   the touched rows. Its scatters add exact zeros at every slot but the
   last of an id's run, so no row is written twice with different values.

Every lookup of the path returns the tape's rows before ``_gather`` is
reached, so the merge-scatter kernel never runs here.

- ``RowAdagrad`` is optax's adagrad (an untouched row's gradient is zero,
  and zero-gradient Adagrad moves nothing), so it equals the dense path with
  the port's ``Adagrad``; ``rowwise=True`` keeps one accumulator a row.
- ``RowAdam`` is lazy Adam: a row's moments and bias-correction clock
  advance only when it is touched. It equals dense Adam while every row is
  touched each step.
- Tables: the model's ``embedding`` column groups (``table``, ``linear``,
  ``table{d}``, ``linear{d}``; ``align{d}`` is dense) and the auxiliary
  tables outside it, top-level (total_vocab, ·) parameters looked up by
  ``gather_rows(..., tape_key=<their name>)`` (FFM's ``ffm``, OENN's
  ``order{k}``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..models.base import Model, as_tensors
from ..ops.embedding import RowTape, has_int8_tables, row_tape
from .loop import loss_fn
from .optimizers import OptaxRule, OptimizerSpec

State = Dict[str, torch.Tensor]


def dedup_sum(gids: torch.Tensor, grads: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum the gradient rows of duplicate ids: ``(sorted_ids, summed,
    is_end)``, the rows sorted by id (stably), the LAST slot of each run of
    equal ids holding the run's sum and every other slot zero."""
    n = gids.shape[0]
    order = torch.argsort(gids, stable=True)
    sid, sg = gids[order], grads[order]
    start = torch.ones(n, dtype=torch.bool, device=gids.device)
    start[1:] = sid[1:] != sid[:-1]
    is_end = torch.ones_like(start)
    is_end[:-1] = start[1:]
    run = torch.cumsum(start.long(), 0) - 1
    sums = sg.new_zeros(sg.shape).index_add_(0, run, sg)[run]
    return sid, torch.where(is_end[:, None], sums, 0.0), is_end


@dataclass(frozen=True)
class RowAdagrad:
    """Adagrad on the touched rows, optax's rule (accumulator from 0.1,
    eps 1e-7 inside the rsqrt, zero where the accumulator is 0);
    ``rowwise=True`` keeps one accumulator a row, the mean of g² over the
    width."""

    learning_rate: float = 1e-2
    initial_accumulator: float = 0.1
    eps: float = 1e-7
    rowwise: bool = False

    def init(self, table: torch.Tensor) -> State:
        w = 1 if self.rowwise else table.shape[1]
        return {"acc": torch.full((table.shape[0], w), self.initial_accumulator,
                                  dtype=table.dtype, device=table.device)}

    def update(self, table, state, gids, grads) -> None:
        self.apply_rows(table, state, *dedup_sum(gids, grads))

    @torch.no_grad()
    def apply_rows(self, table, state, sid, g, upd_mask) -> None:
        """In place on ``table`` and ``state``: ``sid`` row ids (sorted, with
        duplicates), ``g`` their summed gradients, ``upd_mask`` the one live
        slot of each row; the other slots add exact zeros."""
        g = torch.where(upd_mask[:, None], g, 0.0)
        g2 = (g * g).mean(dim=-1, keepdim=True) if self.rowwise else g * g
        acc_rows = state["acc"].index_select(0, sid) + g2
        inv = torch.where(acc_rows > 0, torch.rsqrt(acc_rows + self.eps), 0.0)
        table.index_add_(0, sid, -self.learning_rate * g * inv)
        state["acc"].index_add_(0, sid, g2)


@dataclass(frozen=True)
class RowAdam:
    """Lazy Adam on the touched rows (``torch.optim.SparseAdam``'s
    semantics): a row's moments decay and its clock ``t`` ticks only when
    it is touched. State: ``m``, ``v`` (V, W) and ``t`` (V,) int32."""

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, table: torch.Tensor) -> State:
        return {"m": torch.zeros_like(table), "v": torch.zeros_like(table),
                "t": torch.zeros(table.shape[0], dtype=torch.int32,
                                 device=table.device)}

    def update(self, table, state, gids, grads) -> None:
        self.apply_rows(table, state, *dedup_sum(gids, grads))

    @torch.no_grad()
    def apply_rows(self, table, state, sid, g, upd_mask) -> None:
        """In place (see ``RowAdagrad.apply_rows``)."""
        m_rows = state["m"].index_select(0, sid)
        v_rows = state["v"].index_select(0, sid)
        t_new = (state["t"].index_select(0, sid) + 1).float()
        m_new = self.b1 * m_rows + (1 - self.b1) * g
        v_new = self.b2 * v_rows + (1 - self.b2) * g * g
        mhat = m_new / (1 - torch.pow(self.b1, t_new))[:, None]
        vhat = v_new / (1 - torch.pow(self.b2, t_new))[:, None]
        delta = -self.learning_rate * mhat / (torch.sqrt(vhat) + self.eps)
        live = upd_mask[:, None]
        table.index_add_(0, sid, torch.where(live, delta, 0.0))
        state["m"].index_add_(0, sid, torch.where(live, m_new - m_rows, 0.0))
        state["v"].index_add_(0, sid, torch.where(live, v_new - v_rows, 0.0))
        state["t"].index_add_(0, sid, upd_mask.int())


def make_row_optimizer(name: str = "adagrad", learning_rate: float = 1e-2, **kw):
    name = name.lower()
    if name == "adagrad":
        return RowAdagrad(learning_rate, **kw)
    if name == "adam":
        return RowAdam(learning_rate, **kw)
    raise ValueError(f"unknown row optimizer {name!r}")


# ---------------------------------------------------------------------------
# the tables and the dense rest


def aux_row_tables(model: Model) -> Dict[str, nn.Parameter]:
    """The model's top-level (total_vocab, ·) parameters: vocab-row tables
    outside its FusedEmbedding (FFM's ``ffm``, OENN's ``order{k}``)."""
    v = model.feature_set.total_vocab
    return {k: p for k, p in model.named_parameters(recurse=False)
            if p.dim() == 2 and p.shape[0] == v}


def emb_row_keys(emb: nn.Module) -> Tuple[str, ...]:
    """A FusedEmbedding's row tables: its ``table*``/``linear*`` column
    groups (the narrow sub-tables included); ``align{d}`` is dense."""
    return tuple(k for k, _ in emb.named_parameters(recurse=False)
                 if k.startswith(("table", "linear")))


def row_table_groups(model: Model, aux_keys=None) -> Dict[str, nn.Parameter]:
    """Every row-updated table by its tape group: the ``embedding``'s
    column groups and the auxiliary tables' keys (``aux_keys``, by default
    ``aux_row_tables``; a sharded model names them, as its blocks no longer
    have total_vocab rows)."""
    emb = getattr(model, "embedding", None)
    out = {k: getattr(emb, k) for k in emb_row_keys(emb)} if emb is not None else {}
    aux = (aux_row_tables(model) if aux_keys is None
           else {k: getattr(model, k) for k in aux_keys})
    clash = set(out) & set(aux)
    assert not clash, (f"aux row tables {clash} collide with FusedEmbedding "
                       "column-group names — rename the params")
    out.update(aux)
    return out


def sparse_dense_tree(model: Model, groups=None) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of everything the dense optimizer owns: every
    parameter but the row tables (``groups``, default ``row_table_groups``)."""
    groups = row_table_groups(model) if groups is None else groups
    rows = {id(p) for p in groups.values()}
    return [(n, p) for n, p in model.named_parameters() if id(p) not in rows]


@dataclass
class SparseTrainState:
    """The model (its parameters, updated in place), the dense optimizer
    bound to ``sparse_dense_tree``, the row optimizer, its state by group
    and the number of steps taken."""
    model: Model
    dense: OptaxRule
    row_opt: object
    rows: Dict[str, State]
    step: int = 0


def create_sparse_train_state(model: Model, dense_opt: OptimizerSpec,
                              row_opt) -> SparseTrainState:
    """The dense optimizer over ``sparse_dense_tree`` and a row state for
    every group of ``row_table_groups``."""
    if has_int8_tables(model):
        raise ValueError("a model with int8 serving tables cannot train")
    return SparseTrainState(
        model=model, dense=dense_opt.init(sparse_dense_tree(model)), row_opt=row_opt,
        rows={g: row_opt.init(t.detach()) for g, t in row_table_groups(model).items()})


def local_gather(group: str, table: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """The single-process gather: ``index_select`` of the recorded ids."""
    return table.index_select(0, gids.reshape(-1)).reshape(*gids.shape, table.shape[1])


def sparse_step_core(model: Model, dense: OptaxRule, batch, gather=None, *,
                     groups=None, loss=None, sync=None):
    """Record, gather, inject, backward and the dense update. Returns (out,
    per-group (ids (N,), gradients (N, W))).

    ``gather(group, table, global_ids) -> (*ids.shape, W)`` reads the
    recorded rows outside the loss, as the reference passes it in:
    ``local_gather`` by default, the collective lookup on the sharded path
    (``parallel/sparse.py``), which also passes its row ``groups``, its
    ``loss`` (``loss_fn``'s signature: the global batch's share) and a
    ``sync()`` that sums the dense gradients over the data group before the
    dense update."""
    gather = gather or local_gather
    groups = row_table_groups(model) if groups is None else groups
    rec = RowTape("record")
    with torch.no_grad(), row_tape(rec):
        model(batch, train=True)
    for g, _ in rec.records:
        if g not in groups:
            raise ValueError(
                f"RowTape recorded unknown group {g!r} — gather_rows tape_key "
                f"must name a top-level (total_vocab, ·) parameter (have: "
                f"{sorted(groups)})")
    with torch.no_grad():
        rows_in = [gather(g, groups[g].detach(), gid).requires_grad_()
                   for g, gid in rec.records]
    dense.zero_grad(set_to_none=True)
    with row_tape(RowTape("inject", rows_in)):
        total, (logits, _, _, bce) = (loss or loss_fn)(model, batch)
    total.backward()
    if sync is not None:
        sync()
    dense.step()
    per_group = {}
    for g, table in groups.items():
        taken = [(gid.reshape(-1), r.grad if r.grad is not None else torch.zeros_like(r))
                 for (grp, gid), r in zip(rec.records, rows_in) if grp == g]
        if taken:
            per_group[g] = (torch.cat([i for i, _ in taken]),
                            torch.cat([gr.reshape(-1, table.shape[1]) for _, gr in taken]))
    out = {"loss": total.detach(), "bce": bce.detach(), "logits": logits.detach(),
           "label": batch["label"]}
    return out, per_group


def make_sparse_train_step(ts: SparseTrainState):
    """``train_step(batch) -> {"loss", "bce", "logits", "label"}``: one
    sparse-row step of ``ts`` (its model, dense optimizer and row states,
    in place)."""
    model = ts.model
    dev = next(model.parameters()).device

    def train_step(batch):
        batch = as_tensors(batch, dev)
        out, per_group = sparse_step_core(model, ts.dense, batch)
        groups = row_table_groups(model)
        for g, (gids, grads) in per_group.items():
            ts.row_opt.update(groups[g].data, ts.rows[g], gids, grads)
        ts.step += 1
        return out

    return train_step
