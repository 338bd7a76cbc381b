"""Flash attention: CUDA kernels for Hopper, forward, dQ and dK/dV, and
their plain versions.

Counterpart of ``ml_function_tpu/ops/kernels/flash_attention.py``. The
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``,
``csrc/flash_bwd_dkv.cu``, sharing ``csrc/flash.cuh``) replace the Pallas
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; the source notes
say what bounds them on the H100 and how the design answers that.
Attention over long behavior streams (SIM's exact search unit over up to
16,384 keys) with small heads:

    s = (q·kᵀ)·scale + bias,   o = softmax(s)·v,   lse = logsumexp(s)

with q (B, H, Lq, Dh), k and v (B, H, Lk, Dh), an additive key bias (B, Lk)
of 0 for a valid key and ``NEG_INF`` for a masked one, and ``NEG_INF`` in
place of s where ``causal`` and the key comes after the query, all f32, for
Dh ≤ 64. The (Lq, Lk) matrix is never formed: the forward keeps a running
(max, sum, acc) per query row, the backward recomputes the probabilities
from lse, with δ = rowsum(dO ⊙ O) formed here with torch, as the reference
forms it outside Pallas.

The reference pads Lk to a multiple of 512 and gives the padded keys the
masked bias, so a query whose keys are all masked gets (Lk/Lk_pad)·mean(V);
the port pads nothing and gives mean(V), the dense route's value
(``ROADMAP.md`` R1).

``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function``: for tensors on the CPU both directions run the
plain versions, for CUDA tensors they launch the kernels; it never falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from ._checks import check_cuda_inputs, on_cpu, refuse_double_backward

NEG_INF = -1e9
MAX_HEAD_DIM = 64
# The kernels' inputs: (B, H, L, Dh) activations, the (B, Lk) key bias and
# the (B, H, Lq) row statistics lse and δ.
NDIMS = {"q": 4, "k": 4, "v": 4, "bias": 2, "lse": 3, "do": 4, "delta": 3}
# Elements of one (B, H, rows, Lk) block of logits in the plain versions:
# 2^26 floats (256 MB) a chunk of query rows, so the 16,384 × 16,384 scores
# of SIM's flash-ESU shape (17 GB whole) never exist at once.
PLAIN_CHUNK = 1 << 26

# Launches of each CUDA kernel since its count was last set to 0.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0


def _row_chunks(bh: int, lq: int, lk: int):
    step = max(1, PLAIN_CHUNK // max(1, bh * lk))
    return [(r0, min(lq, r0 + step)) for r0 in range(0, lq, step)]


def _logits(q, k, bias, scale: float, causal: bool, r0: int) -> torch.Tensor:
    """(B, H, n, Lk) logits of the query rows r0.. r0 + n: the product, then
    the scale, then the bias, as the reference rounds them; ``NEG_INF`` in
    place of a key after its query when causal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias[:, None, None, :]
    if causal:
        rows = torch.arange(r0, r0 + q.shape[2], device=q.device)
        cols = torch.arange(k.shape[2], device=q.device)
        s = torch.where(cols[None, :] <= rows[:, None], s, NEG_INF)
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, scale: float,
                              causal: bool = False):
    """Plain PyTorch version of the forward kernel: (o (B, H, Lq, Dh),
    lse (B, H, Lq)), a full softmax over Lk for each chunk of query rows,
    with the kernel's m = max(max s, NEG_INF) and l clamped at 1e-30."""
    b, h, lq, _ = q.shape
    outs, lses = [], []
    for r0, r1 in _row_chunks(b * h, lq, k.shape[2]):
        s = _logits(q[:, :, r0:r1], k, bias, scale, causal, r0)
        m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v) / l)
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def flash_attention_backward_reference(q, k, v, bias, lse, do, delta,
                                       scale: float, causal: bool = False):
    """Plain PyTorch version of the two backward kernels, their formulas
    written out (not autograd of the forward), a chunk of query rows at a
    time: P = exp(S − lse), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − δ),
    dQ = scale·dS·K and dK = scale·dSᵀ·Q. Returns (dq, dk, dv) in the
    layouts of q, k, v."""
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    b, h, lq, _ = q.shape
    for r0, r1 in _row_chunks(b * h, lq, k.shape[2]):
        qc, doc = q[:, :, r0:r1], do[:, :, r0:r1]
        p = torch.exp(_logits(qc, k, bias, scale, causal, r0)
                      - lse[:, :, r0:r1, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, v)
        ds = p * (dp - delta[:, :, r0:r1, None])
        dq[:, :, r0:r1] = scale * torch.einsum("bhqk,bhkd->bhqd", ds, k)
        dk += scale * torch.einsum("bhqk,bhqd->bhkd", ds, qc)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's custom vjp: the forward saves (q, k, v, bias, o,
    lse), the backward forms δ and runs the dQ and the dK/dV kernels. The
    bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        if on_cpu(q, k, v, bias):
            o, lse = flash_attention_reference(q, k, v, bias, scale, causal)
        else:
            o, lse = flash_attention_forward(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        refuse_double_backward("flash_attention")
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do * o).sum(dim=-1)
        args = (q, k, v, bias, lse, do, delta, ctx.scale, ctx.causal)
        if on_cpu(q, k, v, bias, do):
            dq, dk, dv = flash_attention_backward_reference(*args)
        else:
            dq = flash_attention_backward_dq(*args)
            dk, dv = flash_attention_backward_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale + maskbias)·v with O(L) memory: q (B, H, Lq, Dh),
    k and v (B, H, Lk, Dh), mask (B, Lk) bool for the valid keys (None: all
    valid), scale 1/√Dh by default → (B, H, Lq, Dh) f32."""
    b, lk, dh = q.shape[0], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    if mask is None:
        bias = torch.zeros((b, lk), dtype=torch.float32, device=q.device)
    else:
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    return FlashAttention.apply(q, k, v, bias, scale, bool(causal))


def _shape(what: str, kind: str, **t: torch.Tensor):
    """(B, H, Lq, Lk, Dh); raises ``ValueError`` on what the ``kind``
    kernel ("fwd", "dq" or "dkv") does not take."""
    check_cuda_inputs(what, NDIMS, **t)
    b, h, lq, dh = t["q"].shape
    lk = t["k"].shape[2]
    want = {"k": (b, h, lk, dh), "v": (b, h, lk, dh), "bias": (b, lk),
            "lse": (b, h, lq), "do": (b, h, lq, dh), "delta": (b, h, lq)}
    bad = {n: tuple(x.shape) for n, x in t.items() if n != "q" and tuple(x.shape) != want[n]}
    if bad:
        raise ValueError(f"{what}: shapes {bad} do not fit q {tuple(t['q'].shape)} "
                         "(B, H, Lq, Dh): k and v (B, H, Lk, Dh), bias (B, Lk), "
                         "lse and delta (B, H, Lq), do (B, H, Lq, Dh)")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim Dh = {dh} is beyond the kernels' "
                         f"1..{MAX_HEAD_DIM}")
    if min(b, h, lq, lk) < 1:
        raise ValueError(f"{what}: shape (B={b}, H={h}, Lq={lq}, Lk={lk}) has no "
                         "(query, key) pair")
    # grid rows: 128 queries a block (forward, dQ); 128 keys a block in
    # dK/dV, 64 at a padded Dh of 64
    rows, per_block = (lk, 64 if dh > 32 else 128) if kind == "dkv" else (lq, 128)
    if -(-rows // per_block) > 65535 or b * h * max(lq, lk) * dh >= 2 ** 31:
        raise ValueError(f"{what}: shape (B={b}, H={h}, Lq={lq}, Lk={lk}, "
                         f"Dh={dh}) is beyond the kernels' grid and indexing")
    return b, h, lq, lk, dh


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    n_ptr = {"flash_fwd": 6, "flash_bwd_dq": 8, "flash_bwd_dkv": 9}[name]
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _call(name: str, ptrs, scale: float, causal: bool, shape, device) -> None:
    b, h, lq, lk, dh = shape
    with torch.cuda.device(device):
        err = getattr(_lib(name), name)(
            *(t.data_ptr() for t in ptrs), scale, int(causal), b, h, lq, lk, dh,
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def flash_attention_forward(q, k, v, bias, scale: float, causal: bool = False):
    """The forward kernel (``csrc/flash_fwd.cu``) on CUDA tensors: (o, lse)
    of ``flash_attention_reference``. Raises on anything the kernel does not
    take; never runs the plain version."""
    global flash_fwd_launches
    shape = _shape("flash_attention", "fwd", q=q, k=k, v=v, bias=bias)
    b, h, lq, _, _ = shape
    o, lse = torch.empty_like(q), q.new_empty((b, h, lq))
    _call("flash_fwd", (q, k, v, bias, o, lse), scale, causal, shape, q.device)
    flash_fwd_launches += 1
    return o, lse


def flash_attention_backward_dq(q, k, v, bias, lse, do, delta, scale: float,
                                causal: bool = False) -> torch.Tensor:
    """The dQ kernel (``csrc/flash_bwd_dq.cu``) on CUDA tensors: dq of
    ``flash_attention_backward_reference``. Raises on anything the kernel
    does not take; never runs the plain version."""
    global flash_bwd_dq_launches
    shape = _shape("flash_attention backward (dq)", "dq", q=q, k=k, v=v,
                   bias=bias, lse=lse, do=do, delta=delta)
    dq = torch.empty_like(q)
    _call("flash_bwd_dq", (q, k, v, bias, lse, do, delta, dq), scale, causal,
          shape, q.device)
    flash_bwd_dq_launches += 1
    return dq


def flash_attention_backward_dkv(q, k, v, bias, lse, do, delta, scale: float,
                                 causal: bool = False):
    """The dK/dV kernel (``csrc/flash_bwd_dkv.cu``) on CUDA tensors: (dk, dv)
    of ``flash_attention_backward_reference``, each key row written once
    (no atomics). Raises on anything the kernel does not take; never runs
    the plain version."""
    global flash_bwd_dkv_launches
    shape = _shape("flash_attention backward (dk, dv)", "dkv", q=q, k=k, v=v,
                   bias=bias, lse=lse, do=do, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd_dkv", (q, k, v, bias, lse, do, delta, dk, dv), scale, causal,
          shape, q.device)
    flash_bwd_dkv_launches += 1
    return dk, dv
