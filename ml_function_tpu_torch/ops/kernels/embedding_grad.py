"""The embedding gradient by merge-scatter: a CUDA kernel for Hopper and its
plain version.

Counterpart of the merge-scatter part of
``ml_function_tpu/ops/kernels/embedding_grad.py``. ``fused_gather(table,
flat_ids)`` is an autograd Function whose forward is ``index_select`` and
whose backward builds the (V, D) dense gradient

    grad[v] = Σ ct[i] over the i with ids[i] == v

with duplicates combined in sorted-id order (deterministic), as
``dense_grad_from_updates`` does in the reference. On CUDA the ids are
sorted with ``torch.sort`` (stable) and the cotangents permuted, as the
reference sorts with XLA outside its Pallas kernel; then one hand-written
kernel (``csrc/merge_scatter.cu``) writes every output row once, zeros where
no id falls, with no atomics. The reference's one-hot MXU tiles, DMA windows
and sentinel padding exist for the TPU and are not carried over.

For tensors on the CPU the backward runs the plain version; for CUDA tensors
it launches the kernel. It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._checks import check_cuda_inputs, on_cpu

CHUNK = 256   # sorted entries a block of the kernel's first pass takes

# Launches of the CUDA kernel since its count was last set to 0.
merge_scatter_launches = 0


def _sorted(ids: torch.Tensor, ct: torch.Tensor):
    s_ids, order = torch.sort(ids.reshape(-1).long(), stable=True)
    return s_ids, ct.reshape(s_ids.shape[0], ct.shape[-1])[order]


def dense_grad_reference(ids: torch.Tensor, ct: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: (N,) ids, (N, D) cotangents → (num_rows, D),
    ``zeros.index_add(0, ids, ct)`` over the ids in sorted order (on the
    CPU ``index_add`` sums in that order)."""
    s_ids, s_ct = _sorted(ids, ct)
    out = s_ct.new_zeros((num_rows, s_ct.shape[1]))
    return out.index_add_(0, s_ids, s_ct)


def dense_grad_from_updates(ids: torch.Tensor, ct: torch.Tensor,
                            num_rows: int) -> torch.Tensor:
    """The same on CUDA tensors: stable sort, then the merge-scatter
    kernel. Raises on anything the kernel does not take."""
    if ids.device.type != "cuda":
        raise ValueError(f"dense_grad_from_updates: ids are on {ids.device}; "
                         "the kernel takes CUDA tensors (the plain version is "
                         "dense_grad_reference)")
    s_ids, s_ct = _sorted(ids, ct)
    return merge_scatter(s_ids, s_ct, num_rows)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge_scatter")
    lib.merge_scatter.argtypes = ([ctypes.c_void_p] * 5
                                  + [ctypes.c_longlong] * 2
                                  + [ctypes.c_int, ctypes.c_void_p])
    lib.merge_scatter.restype = ctypes.c_int
    return lib


def merge_scatter(s_ids: torch.Tensor, s_ct: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """The kernel on CUDA tensors: ids (N,) int64 sorted ascending and ct
    (N, D) f32 in their order → the (num_rows, D) dense gradient."""
    global merge_scatter_launches
    check_cuda_inputs("merge_scatter", {"ct": 2}, ct=s_ct)
    if (s_ids.device != s_ct.device or s_ids.dtype != torch.int64
            or s_ids.dim() != 1 or not s_ids.is_contiguous()
            or s_ids.shape[0] != s_ct.shape[0]):
        raise ValueError(f"merge_scatter: ids must be a contiguous 1-d int64 "
                         f"tensor of ct's length on {s_ct.device}, got "
                         f"{s_ids.dtype} {tuple(s_ids.shape)} on {s_ids.device}")
    n, d = s_ct.shape
    out = s_ct.new_empty((num_rows, d))
    chunks = -(-n // CHUNK)
    head, tail = s_ct.new_empty((chunks, d)), s_ct.new_empty((chunks, d))
    with torch.cuda.device(s_ct.device):
        err = _lib().merge_scatter(
            s_ids.data_ptr(), s_ct.data_ptr(), head.data_ptr(), tail.data_ptr(),
            out.data_ptr(), n, num_rows, d,
            torch.cuda.current_stream(s_ct.device).cuda_stream)
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
        (ids,) = ctx.saved_tensors
        if on_cpu(ids, ct):
            return dense_grad_reference(ids, ct, ctx.num_rows), None
        return dense_grad_from_updates(ids, ct.contiguous(), ctx.num_rows), None


def fused_gather(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """(V, D) table, (N,) ids → (N, D) rows, with the merge-scatter backward."""
    return FusedGather.apply(table, flat_ids)
