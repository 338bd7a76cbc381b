"""Field attention: CUDA kernels for Hopper, forward and backward, and their
plain versions.

Counterpart of ``ml_function_tpu/ops/kernels/field_attention.py``. The
kernels (``csrc/field_attn_fwd.cu``, ``csrc/field_attn_bwd.cu``) replace the
Pallas ``_fwd_kernel`` and ``_bwd_kernel``; the source notes say what bounds
them on the H100 and how the design answers that. Each direction has four
instances of one contract (``forward_instance``, ``backward_instance``):

- warp: a warp a (batch row, head) for up to 32 queries and keys at Dh ≤ 16
  and H ≤ 8 (AutoInt's fields at its default head width, SIM's top-k);
- l64: a warp a (batch row, head) with a query's logits in registers for up
  to 64 at the same Dh and H (DMIN's refiner);
- wide: a warp a (batch row, head) and 32 queries (or keys), for up to 64
  at any Dh of the gate and any H, the rows of one (batch row, head)
  staged apart and a lane's registers holding its logits and 16 columns
  of a row at a time (AutoInt at the AutoInt paper's 2 heads of 32, the
  gate's Dh-64 edge). At AutoInt's (B 4096, L 27, H 2, Dh 32) memory
  bounds it (113 MB, 0.034 ms at 3.35 TB/s, forward; 199 MB, 0.059 ms,
  backward), and it takes 0.0668–0.0675 ms forward and 0.2169–0.2211 ms
  backward on the device on an NVIDIA H100 80GB HBM3 at 700 W
  (``chip_smoke.py``, ``tools/field_attn_instances.py``), against the
  block instances' 0.21 and 0.55;
- block: a block a (batch row, head) for the rest of the gate (Lq or Lk
  past 64, with Lq·Lk ≤ 4096).

Attention over a few positions (AutoInt's feature fields) at a large batch:

    o = softmax(q·kᵀ·scale + bias) · v

with q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), an additive key bias (B, Lk)
and o (B, Lq, H, Dh), all f32, for lq·lk ≤ 4096 and Dh ≤ 64 (the gate of
``MultiHeadAttention``). The backward recomputes the probabilities from the
saved inputs, as the reference's custom vjp does; the bias gets no gradient.

``field_attention`` is a ``torch.autograd.Function``: for tensors on the CPU
both directions run the plain versions, for CUDA tensors they launch the
kernels; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._checks import check_cuda_inputs, on_cpu, refuse_double_backward

# The reference's gate (``ml_function_tpu/ops/attention.py``): the kernels
# hold the (Lq, Lk) score matrix of one (batch row, head) on chip.
MAX_SCORES = 4096
MAX_HEAD_DIM = 64
# The kernels' inputs: (B, L, H, Dh) activations, the (B, Lk) bias.
NDIMS = {"q": 4, "k": 4, "v": 4, "bias": 2, "do": 4}

# The warp instances take Lq, Lk ≤ 32 (a lane a query, or a key), Dh ≤ 16
# (a row of q, k or v in a lane's registers) and H ≤ 8 (a block's warps);
# the L-64 instances the rest up to Lq, Lk ≤ 64 (a lane on a query, then on
# a second 32 further, its 64 logits in registers) at the same Dh and H;
# the wide instances every other shape up to Lq, Lk ≤ 64 (any Dh of the
# gate, any H); the block ones the rest of the gate. ``_instance`` takes the
# first of ``INSTANCES`` that fits.
WARP_MAX_L, WARP_MAX_HEAD_DIM, WARP_MAX_HEADS = 32, 16, 8
L64_MAX_L = 64
INSTANCES = ("warp", "l64", "wide", "block")

# Launches of each CUDA kernel since its count was last set to 0, and of
# each instance (C function) by name.
field_attn_fwd_launches = 0
field_attn_bwd_launches = 0
instance_launches: dict = {}


def _probs(q, k, bias, scale):
    """(B, H, Lq, Lk) softmax weights: scale, then add the bias, as the
    reference forms the logits."""
    lg = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.softmax(lg + bias[:, None, None, :], dim=-1)


def field_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the forward: (B, Lq, H, Dh)."""
    return torch.einsum("bhqk,bkhd->bqhd", _probs(q, k, bias, scale), v)


def field_attention_backward_reference(q, k, v, bias, do, scale: float):
    """Plain PyTorch version of the backward, the TPU kernel's formulas
    written out (not autograd of the forward): with a recomputed,
    dV = aᵀ·dO, dA = dO·Vᵀ, dS = a ⊙ (dA − Σₖ a·dA), dQ = scale·dS·K and
    dK = scale·dSᵀ·Q. Returns (dq, dk, dv) in the layouts of q, k, v."""
    a = _probs(q, k, bias, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", a, do)
    da = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dq, dk, dv


class FieldAttention(torch.autograd.Function):
    """The reference's custom vjp: the backward recomputes the softmax
    weights from the saved q, k, v and bias rather than saving them."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if on_cpu(q, k, v, bias):
            return field_attention_reference(q, k, v, bias, scale)
        return field_attention_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        refuse_double_backward("field_attention")
        q, k, v, bias = ctx.saved_tensors
        if on_cpu(q, k, v, bias, do):
            grads = field_attention_backward_reference(q, k, v, bias, do, ctx.scale)
        else:
            grads = field_attention_backward(q, k, v, bias, do.contiguous(), ctx.scale)
        return (*grads, None, None)


def field_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v: q (B, Lq, H, Dh), k/v (B, Lk, H, Dh),
    bias (B, Lk) additive → (B, Lq, H, Dh), f32."""
    return FieldAttention.apply(q, k, v, bias, scale)


def _shape(what: str, q, k, v, bias):
    """(B, Lq, Lk, H, Dh); raises on shapes the kernels do not take."""
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    if (k.shape != (b, lk, h, dh) or v.shape != k.shape
            or bias.shape != (b, lk)):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, bias {tuple(bias.shape)} do not "
                         "form (B,Lq,H,Dh), (B,Lk,H,Dh) twice, (B,Lk)")
    if lq * lk > MAX_SCORES or dh > MAX_HEAD_DIM:
        raise ValueError(f"{what}: Lq·Lk = {lq * lk} and Dh = {dh} are beyond "
                         f"the kernel's gate (Lq·Lk ≤ {MAX_SCORES}, "
                         f"Dh ≤ {MAX_HEAD_DIM})")
    if b > 2 ** 31 - 1 or h > 65535 or b * max(lq, lk) * h * dh >= 2 ** 31:
        raise ValueError(f"{what}: shape (B={b}, Lq={lq}, Lk={lk}, H={h}, "
                         f"Dh={dh}) is beyond the kernel's int32 indexing")
    return b, lq, lk, h, dh


def instance_fits(kind: str, lq: int, lk: int, h: int, dh: int) -> bool:
    """Whether the instance ``kind`` takes the shape: the limits its C entry
    checks (``fa::warp_fits``, ``fa::l64_fits``, ``fa::wide_fits`` in
    ``csrc/field_attn.cuh``; the block instance takes every shape of the
    gate)."""
    if kind == "block":
        return True
    if kind == "wide":
        return lq <= L64_MAX_L and lk <= L64_MAX_L
    small = dh <= WARP_MAX_HEAD_DIM and h <= WARP_MAX_HEADS
    top = WARP_MAX_L if kind == "warp" else L64_MAX_L
    return small and lq <= top and lk <= top


def _instance(lq: int, lk: int, h: int, dh: int) -> str:
    """Which instance takes the shape: the first of ``INSTANCES`` that fits
    it (each C entry refuses the shapes past its own limits)."""
    return next(kind for kind in INSTANCES if instance_fits(kind, lq, lk, h, dh))


def _c_name(direction: str, kind: str) -> str:
    """The C function of ``csrc/field_attn_<direction>.cu`` of an instance."""
    return f"field_attn_{direction}" + ("" if kind == "block" else f"_{kind}")


def forward_instance(q, k, v, bias) -> str:
    """The C function of ``csrc/field_attn_fwd.cu`` that takes these inputs'
    shape: ``field_attn_fwd_warp`` within the warp instance's limits,
    ``field_attn_fwd_l64`` past them up to 64 positions at the same Dh and
    H, ``field_attn_fwd_wide`` for the rest up to 64 positions, else
    ``field_attn_fwd``. Raises where ``_shape`` does."""
    _, lq, lk, h, dh = _shape("field_attention", q, k, v, bias)
    return _c_name("fwd", _instance(lq, lk, h, dh))


def backward_instance(q, k, v, bias) -> str:
    """The C function of ``csrc/field_attn_bwd.cu`` that takes these inputs'
    shape: ``field_attn_bwd_warp``, ``field_attn_bwd_l64``,
    ``field_attn_bwd_wide`` or ``field_attn_bwd``, by the forward's limits.
    Raises where ``_shape`` does."""
    _, lq, lk, h, dh = _shape("field_attention backward", q, k, v, bias)
    return _c_name("bwd", _instance(lq, lk, h, dh))


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its four C functions bound."""
    lib = _build.load(name)
    n_ptr = 5 if name == "field_attn_fwd" else 8
    for fname in (_c_name(name[-3:], kind) for kind in INSTANCES):
        fn = getattr(lib, fname)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def field_attention_forward(q, k, v, bias, scale: float,
                            instance: str | None = None) -> torch.Tensor:
    """The forward kernel (``csrc/field_attn_fwd.cu``) on CUDA tensors: the
    contract of ``field_attention_reference``, through ``instance``
    (default: the one ``forward_instance`` picks; the block instance takes
    every shape of the gate, the others raise outside their limits).
    Raises on anything the kernel does not take; never runs the plain
    version."""
    global field_attn_fwd_launches
    check_cuda_inputs("field_attention", NDIMS, q=q, k=k, v=v, bias=bias)
    b, lq, lk, h, dh = _shape("field_attention", q, k, v, bias)
    fname = instance or forward_instance(q, k, v, bias)
    if fname not in [_c_name("fwd", kind) for kind in INSTANCES]:
        raise ValueError(f"field_attention: no forward instance {fname!r}")
    o = torch.empty_like(q)
    if b * h == 0:   # no (b, h) pair: o is empty
        return o
    with torch.cuda.device(q.device):
        err = getattr(_lib("field_attn_fwd"), fname)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), scale, b, lq, lk, h, dh,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fname} launch failed with CUDA error {err}")
    field_attn_fwd_launches += 1
    instance_launches[fname] = instance_launches.get(fname, 0) + 1
    return o


def field_attention_backward(q, k, v, bias, do, scale: float,
                             instance: str | None = None):
    """The backward kernel (``csrc/field_attn_bwd.cu``) on CUDA tensors: the
    contract of ``field_attention_backward_reference``, through
    ``instance`` (default: the one ``backward_instance`` picks; as the
    forward's). Raises on anything the kernel does not take; never runs
    the plain version."""
    global field_attn_bwd_launches
    name = "field_attention backward"
    check_cuda_inputs(name, NDIMS, q=q, k=k, v=v, bias=bias, do=do)
    b, lq, lk, h, dh = _shape(name, q, k, v, bias)
    fname = instance or backward_instance(q, k, v, bias)
    if fname not in [_c_name("bwd", kind) for kind in INSTANCES]:
        raise ValueError(f"{name}: no backward instance {fname!r}")
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} is not the shape of "
                         f"q {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h == 0:   # no (b, h) pair: the gradients are empty
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = getattr(_lib("field_attn_bwd"), fname)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scale,
            b, lq, lk, h, dh, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fname} launch failed with CUDA error {err}")
    field_attn_bwd_launches += 1
    instance_launches[fname] = instance_launches.get(fname, 0) + 1
    return dq, dk, dv
