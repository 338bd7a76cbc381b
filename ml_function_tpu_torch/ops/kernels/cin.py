"""Fused CIN layer forward: a CUDA kernel for Hopper and its plain version.

Counterpart of ``ml_function_tpu/ops/kernels/cin.py``. The kernel
(``csrc/cin_fwd.cu``) replaces the Pallas ``_fwd_kernel``; its source note
says what bounds it on the H100 and how the design answers that. Like the TPU
kernel it never writes the interaction tensor Z (B, H·F, D) or the product
U (B, F·O) to device memory.

    y[d,b,o] = Σ_f x0[d,b,f] · Σ_h bf16(xk[d,b,h]) · bf16(w1[h, f·O+o])

Products and sums are f32; only ``xk`` and ``w1`` are rounded to bf16.

``cin_layer_t`` runs the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; it never falls back from one to the other. The
backward (the Pallas ``_bwd_kernel``) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

BLOCK_B = 256
# Shared memory a block may use on the H100 (232,448 bytes).
MAX_SMEM_BYTES = 232_448

# Launches of the CUDA kernel since the count was last set to 0.
cin_fwd_launches = 0


def supports(b: int, f: int, o: int, d: int) -> bool:
    """The reference's gate (``ml_function_tpu/ops/kernels/cin.py``): with
    the same gate the port and the reference take the same numeric route."""
    return b % BLOCK_B == 0 and o % 128 == 0 and f >= 1 and d >= 1


def cin_layer_t_reference(xk_t: torch.Tensor, x0_t: torch.Tensor,
                          w1: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding sites:
    xk_t (D, B, H), x0_t (D, B, F), w1 (H, F·O) → (D, B, O)."""
    d, b, _ = xk_t.shape
    f = x0_t.shape[2]
    u = torch.matmul(xk_t.bfloat16().float(), w1.bfloat16().float())
    return (u.view(d, b, f, -1) * x0_t.unsqueeze(-1)).sum(dim=2)


def cin_layer_t(xk_t: torch.Tensor, x0_t: torch.Tensor,
                w1: torch.Tensor) -> torch.Tensor:
    """One CIN layer on TRANSPOSED activations: xk_t (D, B, H),
    x0_t (D, B, F), w1 (H, F·O) → (D, B, O). ``w1`` is the (H·F, O) layer
    weight viewed as ``W.reshape(H, F, O).reshape(H, F·O)``."""
    if all(t.device.type == "cpu" for t in (xk_t, x0_t, w1)):
        return cin_layer_t_reference(xk_t, x0_t, w1)
    return _launch(xk_t, x0_t, w1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cin_fwd")
    lib.cin_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.cin_fwd.restype = ctypes.c_int
    lib.cin_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cin_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.cin_fwd_scratch_cols.argtypes = [ctypes.c_int]
    lib.cin_fwd_scratch_cols.restype = ctypes.c_int
    return lib


def _launch(xk_t: torch.Tensor, x0_t: torch.Tensor,
            w1: torch.Tensor) -> torch.Tensor:
    global cin_fwd_launches
    tensors = (xk_t, x0_t, w1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("CIN backward kernel: training slice")
    dev = xk_t.device
    for name, t, ndim in (("xk_t", xk_t, 3), ("x0_t", x0_t, 3), ("w1", w1, 2)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"cin_layer_t: {name} is on {t.device}; all inputs "
                             "must be on one CUDA device (or all on the CPU)")
        if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"cin_layer_t: {name} must be a contiguous "
                             f"{ndim}-d float32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    d, b, h = xk_t.shape
    f = x0_t.shape[2]
    if x0_t.shape[:2] != (d, b) or w1.shape[0] != h or f == 0 or w1.shape[1] % f:
        raise ValueError(f"cin_layer_t: shapes xk_t {tuple(xk_t.shape)}, x0_t "
                         f"{tuple(x0_t.shape)}, w1 {tuple(w1.shape)} do not "
                         "form (D,B,H), (D,B,F), (H,F·O)")
    o = w1.shape[1] // f
    if d > 65535 or max(d * b * h, d * b * f, d * b * o, h * f * o) >= 2 ** 31:
        raise ValueError(f"cin_layer_t: shape (D={d}, B={b}, H={h}, F={f}, "
                         f"O={o}) is beyond the kernel's int32 indexing")
    y = torch.empty((d, b, o), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    lib = _lib()
    smem = lib.cin_fwd_smem_bytes(h, f)
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"CIN kernel: H={h}, F={f} need {smem} bytes of shared memory "
            f"per block, more than the {MAX_SMEM_BYTES} a block may use")
    wt = torch.empty((f * o, lib.cin_fwd_scratch_cols(h)), dtype=torch.bfloat16,
                     device=dev)
    with torch.cuda.device(dev):
        err = lib.cin_fwd(xk_t.data_ptr(), x0_t.data_ptr(), w1.data_ptr(),
                          y.data_ptr(), wt.data_ptr(), d, b, h, f, o,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cin_fwd launch failed with CUDA error {err}")
    cin_fwd_launches += 1
    return y
