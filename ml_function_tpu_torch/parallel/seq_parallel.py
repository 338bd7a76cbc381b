"""Attention over a key sequence sharded across the model group.

Counterpart of ``ml_function_tpu/parallel/seq_parallel.py``. The keys and
values of a long stream (and their mask) are split over the ranks of the
model group in contiguous blocks; the queries are replicated. Two routes,
both exact softmax attention:

- ``dist``: each rank computes its block's partial attention (the
  unnormalised P·V, the row max and the row sum), and one max and two sums
  over the group merge them (out = Σ acc_i·e^(m_i − m) / Σ l_i·e^(m_i − m));
- ``ring``: the key, value and bias blocks rotate around the group with
  ``ppermute`` for n steps while each rank keeps the online-softmax state.

Each block's statistics are plain einsums: the reference computes them
outside any Pallas kernel, so there is no kernel to port here.

Gradients follow ``shard_map``'s transposes in the reference. The query is
replicated, so its gradient is summed over the group (``comm.sum_grad``);
the dist route's sums are replicated, and take the identity as their
backward (``comm.replicated_sum``); the ring route's output, which each
rank computes whole and the reference returns unchecked as replicated,
splits its cotangent over the group (``comm.mean_grad``), as that transpose
does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import comm
from .mesh import MODEL_AXIS, Mesh

NEG_INF = -1e9


def _local_attention_stats(q, k, v, bias, scale):
    """q (B, H, Lq, Dh) against the local keys k, v (B, H, Lkl, Dh) with
    bias (B, Lkl): (acc = unnormalised P·V, m the row max, l the row sum)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    m = torch.maximum(m, torch.full_like(m, NEG_INF))   # all-masked blocks stay finite
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return acc, m, l


def dist_attention_local(q, k_local, v_local, bias_local, group, scale=None):
    """Exact attention over keys split across ``group``, merged with one max
    and two sums. ``q`` enters as this rank holds it: the caller sums its
    gradient over the group (``make_seq_parallel_attention``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    acc, m, l = _local_attention_stats(q, k_local, v_local, bias_local, scale)
    # the max is only an exponent shift: no gradient through it
    m_glob = comm.all_max(m, group)
    alpha = torch.exp(m - m_glob)
    l_glob = comm.replicated_sum(l * alpha, group)
    return comm.replicated_sum(acc * alpha, group) / l_glob.clamp_min(1e-30)


def ring_attention_local(q, k_local, v_local, bias_local, group, scale=None):
    """Exact attention over keys split across ``group``: the blocks rotate
    with ``ppermute`` (rank i hands its block to rank i + 1) while the rank
    keeps the online-softmax state; no closing collective."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n = comm.group_size(group)
    b, h, lq, dh = q.shape
    k, v, bias = k_local, v_local, bias_local
    m = q.new_full((b, h, lq, 1), NEG_INF)
    l = q.new_zeros((b, h, lq, 1))
    acc = q.new_zeros((b, h, lq, dh))
    for step in range(n):
        a_i, m_i, l_i = _local_attention_stats(q, k, v, bias, scale)
        m_new = torch.maximum(m, m_i)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_i - m_new)
        l = l * alpha + l_i * beta
        acc = acc * alpha + a_i * beta
        m = m_new
        if step < n - 1:        # the reference's last rotation feeds nothing
            k = comm.ppermute(k, group, 1)
            v = comm.ppermute(v, group, 1)
            bias = comm.ppermute(bias, group, 1)
    return acc / l.clamp_min(1e-30)


def make_seq_parallel_attention(mesh: Mesh, axis_name: str = MODEL_AXIS,
                                mode: str = "dist"):
    """``call(q, k, v, mask=None)``: q (B, H, Lq, Dh) replicated over the
    group; k, v (B, H, Lk, Dh) and mask (B, Lk) whole on every rank, each
    rank taking its block of Lk (which must divide by the axis size). The
    result is replicated; the gradient of k and v lands in the rank's own
    block, as a sharded array's would."""
    if axis_name != MODEL_AXIS:
        raise ValueError(f"the port's mesh shards sequences over {MODEL_AXIS!r}, "
                         f"not {axis_name!r}")
    if mode not in ("dist", "ring"):
        raise ValueError(f"unknown sequence-parallel mode {mode!r}")
    group, n, j = mesh.model_group, mesh.model, mesh.model_index
    inner = dist_attention_local if mode == "dist" else ring_attention_local

    def call(q, k, v, mask: Optional[torch.Tensor] = None):
        b, lk = k.shape[0], k.shape[2]
        if lk % n:
            raise ValueError(f"key length {lk} must divide the {axis_name} axis {n}")
        if mask is None:
            mask = torch.ones((b, lk), dtype=torch.bool, device=k.device)
        bias = torch.where(mask, 0.0, NEG_INF).float()
        lb = lk // n
        blk = slice(j * lb, (j + 1) * lb)
        out = inner(comm.sum_grad(q.float(), group), k.float()[:, :, blk],
                    v.float()[:, :, blk], bias[:, blk], group)
        return out if mode == "dist" else comm.mean_grad(out, group)

    return call
