"""The embedding gradient by merge-scatter: a CUDA kernel for Hopper and its
plain version.

Counterpart of the merge-scatter part of
``ml_function_tpu/ops/kernels/embedding_grad.py``. ``fused_gather(table,
flat_ids)`` is an autograd Function whose forward is ``index_select`` and
whose backward builds the (V, D) dense gradient

    grad[v] = Σ ct[i] over the i with ids[i] == v

with duplicates combined in sorted-id order (deterministic), as
``dense_grad_from_updates`` does in the reference. On CUDA the ids are
sorted as int32 keys with ``torch.sort`` (stable), as the reference sorts
with XLA outside its Pallas kernel; then one hand-written kernel
(``csrc/merge_scatter.cu``) reads each cotangent row through the sort's
permutation, with no permuted copy, and writes every output row once, zeros
where no id falls, with no atomics. The reference's one-hot MXU tiles, DMA
windows and sentinel padding exist for the TPU and are not carried over.

For tensors on the CPU the backward runs the plain version; for CUDA tensors
it launches the kernel. It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._checks import check_cuda_inputs, on_cpu, refuse_double_backward

CHUNK = 256   # sorted entries a block of the kernel's first pass takes
MAX_ROWS = 2 ** 31 - 1   # the ids are sorted as int32, as the reference's are

# Launches of the CUDA kernel since its count was last set to 0.
merge_scatter_launches = 0


def _sort(ids: torch.Tensor):
    """Stable sort of the flattened ids as int32 keys: (s_ids int32, order
    int64) with ``s_ids[i] == ids[order[i]]``."""
    return torch.sort(ids.reshape(-1).to(torch.int32), stable=True)


def merge_scatter_reference(s_ids: torch.Tensor, order: torch.Tensor,
                            ct: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: ids sorted ascending
    (N,), the sort's permutation (N,) and the cotangents (N, D) in the ids'
    order → (num_rows, D), ``zeros.index_add(0, s_ids, ct[order])`` (on the
    CPU ``index_add`` sums in that order)."""
    ct = ct.reshape(s_ids.shape[0], ct.shape[-1])
    out = ct.new_zeros((num_rows, ct.shape[1]))
    return out.index_add_(0, s_ids.long(), ct[order])


def dense_grad_reference(ids: torch.Tensor, ct: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: (N,) ids, (N, D) cotangents → (num_rows, D),
    summed over the ids in sorted order."""
    return merge_scatter_reference(*_sort(ids), ct, num_rows)


def dense_grad_from_updates(ids: torch.Tensor, ct: torch.Tensor,
                            num_rows: int) -> torch.Tensor:
    """The same on CUDA tensors: stable sort, then the merge-scatter
    kernel. Raises on anything the kernel does not take."""
    if ids.device.type != "cuda":
        raise ValueError(f"dense_grad_from_updates: ids are on {ids.device}; "
                         "the kernel takes CUDA tensors (the plain version is "
                         "dense_grad_reference)")
    s_ids, order = _sort(ids)
    return merge_scatter(s_ids, order, ct.reshape(s_ids.shape[0], ct.shape[-1]), num_rows)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge_scatter")
    lib.merge_scatter.argtypes = ([ctypes.c_void_p] * 6
                                  + [ctypes.c_longlong] * 2
                                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.merge_scatter.restype = ctypes.c_int
    return lib


def _check_index(what: str, name: str, t: torch.Tensor, dtype, n: int, dev) -> None:
    if (t.device != dev or t.dtype != dtype or t.dim() != 1
            or not t.is_contiguous() or t.shape[0] != n):
        raise ValueError(f"{what}: {name} must be a contiguous 1-d {dtype} tensor "
                         f"of ct's length {n} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def merge_scatter(s_ids: torch.Tensor, order: torch.Tensor, ct: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """The kernel on CUDA tensors: ids (N,) int32 sorted ascending, the
    stable sort's permutation order (N,) int64 and ct (N, D) f32 in the ids'
    own order (read as ``ct[order[i]]``) → the (num_rows, D) dense
    gradient."""
    global merge_scatter_launches
    what = "merge_scatter"
    check_cuda_inputs(what, {"ct": 2}, ct=ct)
    n, d = ct.shape
    _check_index(what, "s_ids", s_ids, torch.int32, n, ct.device)
    _check_index(what, "order", order, torch.int64, n, ct.device)
    if not 0 <= num_rows <= MAX_ROWS:
        raise ValueError(f"{what}: {num_rows} rows do not fit the int32 ids the "
                         "kernel sorts")
    out = ct.new_empty((num_rows, d))
    chunks = -(-n // CHUNK)
    head, tail = ct.new_empty((chunks, d)), ct.new_empty((chunks, d))
    vec = int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (ct, head, tail, out)))
    with torch.cuda.device(ct.device):
        err = _lib().merge_scatter(
            s_ids.data_ptr(), order.data_ptr(), ct.data_ptr(), head.data_ptr(),
            tail.data_ptr(), out.data_ptr(), n, num_rows, d, vec,
            torch.cuda.current_stream(ct.device).cuda_stream)
    if err:
        raise RuntimeError(f"merge_scatter launch failed with CUDA error {err}")
    merge_scatter_launches += 1
    return out


class FusedGather(torch.autograd.Function):
    """(V, D) table, (N,) ids → (N, D) rows; the backward is the dense
    gradient by merge-scatter."""

    @staticmethod
    def forward(ctx, table, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, flat_ids)

    @staticmethod
    def backward(ctx, ct):
        refuse_double_backward("fused_gather")
        (ids,) = ctx.saved_tensors
        if on_cpu(ids, ct):
            return dense_grad_reference(ids, ct, ctx.num_rows), None
        return dense_grad_from_updates(ids, ct.contiguous(), ctx.num_rows), None


def fused_gather(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (N,) ids → (N, D) rows, with the merge-scatter backward."""
    return FusedGather.apply(table, flat_ids)
