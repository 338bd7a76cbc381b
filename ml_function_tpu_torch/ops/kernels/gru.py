"""The (AU)GRU recurrence: CUDA kernels for Hopper, forward and backward, and
their plain versions.

Counterpart of ``ml_function_tpu/ops/kernels/gru.py``. The kernels
(``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``) replace the Pallas ``_fwd_kernel``
and ``_bwd_kernel``; the source notes say what bounds them on the H100 and
how the design answers that. One call runs the whole recurrence over L steps:

    hh = bf16(h)·bf16(wh)                      (f32 products and sums)
    u0 = σ(xu + hh_u),  r = σ(xr + hh_r),  n = tanh(xn + r·hh_n)
    u  = a·u0                                   (AUGRU's gate; a ≡ 1 for a GRU)
    h' = m·((1−u)·h + u·n) + (1−m)·h            (padded steps carry h)

with xw (B, L, 3H) the hoisted projections ``x @ wx + b`` in their own
layout (columns [u | r | n]), wh (H, 3H), mask and att (B, L), h0 (B, H) and
the output seq (B, L, H), all f32, for any H ≥ 1 within int32 indexing
(past H 64 the backward also needs scratch for its dwh partials: one
(H, 3H) f32 partial a block, at most as many blocks as the card holds at
once, 1.9 GB at H 1100 on an H100's 132 SMs). The backward
replays the recurrence in reverse from the saved seq, recomputing the gates,
as the reference's custom vjp does; it rounds h_prev, wh and the recurrent
cotangent dhh to bf16 at each of its two products. The mask gets no
gradient (the reference returns zeros for it).

Each kernel has three instances of one C contract, chosen by H alone
(``forward_instance``, ``backward_instance``): ``gru_fwd_warp`` and
``gru_bwd_warp`` for H ≤ 16 (DIEN's and SIM's recurrences at dim 8: a warp
two batch rows, nothing in the step loop waiting on another warp),
``gru_fwd`` and ``gru_bwd`` for 17 ≤ H ≤ 64 (a block 256 / H rows), and
``gru_fwd_wide`` and ``gru_bwd_wide`` for H > 64 (DIEN's kd at dim 64 and
up: a thread owns several hidden units, the bf16 wh in shared memory where
it fits, and the backward's dwh partials in device memory). The wide
instances take no rows argument: their library plans a block's rows from H
(``csrc/gru.cuh``) and states the backward's partials
(``gru_bwd_wide_partials``).

``gru_sequence`` is a ``torch.autograd.Function``: for tensors on the CPU
both directions run the plain versions, for CUDA tensors they launch the
kernels; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._checks import check_cuda_inputs, on_cpu, refuse_double_backward

# The block instances hold wh, and in the backward its (H, 3H) gradient
# partials, in shared memory: 2 · 64 · 192 floats at H 64. Past it the wide
# instances take every H.
BLOCK_MAX_HIDDEN = 64
THREADS = 256   # a block instance's block is rows_per_block(H) rows of H threads
# The warp instances (``gru_fwd_warp``, ``gru_bwd_warp``): H ≤ 16, a thread
# per (batch row, hidden unit), two rows a warp, 8 rows a block.
WARP_MAX_HIDDEN = 16
WARP_ROWS = 8
NDIMS = {"xw": 3, "wh": 2, "mask": 2, "att": 2, "h0": 2, "seq": 3, "dseq": 3}

# Launches of each CUDA kernel since its count was last set to 0, and of
# each instance (C function) by name since the dict was last cleared.
gru_fwd_launches = 0
gru_bwd_launches = 0
instance_launches: dict = {}


def rows_per_block(h: int) -> int:
    """Batch rows a block of a block instance takes: H threads a row."""
    return max(1, THREADS // h)


def _instance(kernel: str, what: str, h: int) -> str:
    if h < 1:
        raise ValueError(f"{what}: hidden size H = {h} is below 1")
    if h <= WARP_MAX_HIDDEN:
        return f"{kernel}_warp"
    return kernel if h <= BLOCK_MAX_HIDDEN else f"{kernel}_wide"


def forward_instance(h: int) -> str:
    """The C function of ``csrc/gru_fwd.cu`` that takes hidden size H:
    ``gru_fwd_warp`` for H ≤ 16 (DIEN's and SIM's recurrences),
    ``gru_fwd`` for 17 ≤ H ≤ 64, ``gru_fwd_wide`` past that."""
    return _instance("gru_fwd", "gru_sequence", h)


def backward_instance(h: int) -> str:
    """The C function of ``csrc/gru_bwd.cu`` that takes hidden size H:
    ``gru_bwd_warp`` for H ≤ 16 (DIEN's and SIM's recurrences),
    ``gru_bwd`` for 17 ≤ H ≤ 64, ``gru_bwd_wide`` past that."""
    return _instance("gru_bwd", "gru_sequence backward", h)


def instance_rows(name: str, h: int) -> int | None:
    """Batch rows a block of the named instance takes at hidden size H, as
    the wrapper passes them; None for a wide instance, whose library plans
    its own."""
    if name.endswith("_warp"):
        return WARP_ROWS
    return None if name.endswith("_wide") else rows_per_block(h)


def backward_rows(h: int) -> int | None:
    """Batch rows a block of the backward instance for H takes (None past
    H 64: the wide instance plans its own)."""
    return instance_rows(backward_instance(h), h)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _mm(a: torch.Tensor, b: torch.Tensor, cast_bf16: bool) -> torch.Tensor:
    """a·b with f32 sums; both operands rounded to bf16 with ``cast_bf16``
    (the reference's ``_mm``)."""
    if cast_bf16:
        a, b = _bf16(a), _bf16(b)
    return torch.matmul(a, b)


def _mm_in_order(a: torch.Tensor, b: torch.Tensor, cast_bf16: bool) -> torch.Tensor:
    """The same product for the recurrence's own chain, summed over k in
    order, as the kernels sum it. A product of two bf16 values is exact in
    f32, so with the cast this gives the kernels' bits: a sum taken in
    another order could round an h of the recurrence to the neighbouring
    bf16 value, and that step's difference would carry through every later
    step."""
    if cast_bf16:
        a, b = _bf16(a), _bf16(b)
    acc = a[:, :1] * b[0]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k]
    return acc


def _gates(x: torch.Tensor, hh: torch.Tensor, h: int):
    u0 = torch.sigmoid(x[:, :h] + hh[:, :h])
    r = torch.sigmoid(x[:, h:2 * h] + hh[:, h:2 * h])
    n = torch.tanh(x[:, 2 * h:] + r * hh[:, 2 * h:])
    return u0, r, n


def gru_sequence_reference(xw: torch.Tensor, wh: torch.Tensor,
                           mask: torch.Tensor, att: torch.Tensor,
                           h0: torch.Tensor, cast_bf16: bool = True
                           ) -> torch.Tensor:
    """Plain PyTorch version of the forward, step by step: (B, L, H)."""
    b, l, _ = xw.shape
    h = wh.shape[0]
    carry, out = h0, []
    for t in range(l):
        hh = _mm_in_order(carry, wh, cast_bf16)
        u0, _, n = _gates(xw[:, t], hh, h)
        u = att[:, t, None] * u0
        h_new = (1.0 - u) * carry + u * n
        m = mask[:, t, None]
        carry = m * h_new + (1.0 - m) * carry
        out.append(carry)
    if not out:
        return xw.new_zeros((b, 0, h))
    return torch.stack(out, dim=1)


def gru_sequence_backward_reference(xw, wh, mask, att, h0, seq, dseq,
                                    cast_bf16: bool = True):
    """Plain PyTorch version of the backward, the TPU kernel's formulas
    written out (not autograd of the forward): a reverse replay that
    recomputes u0, r and n from the saved seq. Returns (dxw (B, L, 3H),
    dwh (H, 3H), da (B, L), dh0 (B, H))."""
    b, l, _ = xw.shape
    h = wh.shape[0]
    dxw = torch.empty_like(xw)
    da = torch.empty_like(att)
    dwh = torch.zeros_like(wh)
    dh = torch.zeros_like(h0)
    for t in reversed(range(l)):
        h_prev = h0 if t == 0 else seq[:, t - 1]
        hh = _mm_in_order(h_prev, wh, cast_bf16)
        u0, r, n = _gates(xw[:, t], hh, h)
        a_t, m = att[:, t, None], mask[:, t, None]
        u = a_t * u0
        dh_t = dh + dseq[:, t]
        dh_new = dh_t * m
        dh_prev = dh_t * (1.0 - m)
        du = dh_new * (n - h_prev)
        dn = dh_new * u
        dh_prev = dh_prev + dh_new * (1.0 - u)
        da[:, t] = (du * u0).sum(dim=1)
        du0 = du * a_t
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hh[:, 2 * h:]
        dhn = dn_pre * r
        du_pre = du0 * u0 * (1.0 - u0)
        dr_pre = dr * r * (1.0 - r)
        dxw[:, t] = torch.cat([du_pre, dr_pre, dn_pre], dim=1)
        dhh = torch.cat([du_pre, dr_pre, dhn], dim=1)          # (B, 3H)
        dh_prev = dh_prev + _mm_in_order(dhh, wh.t(), cast_bf16)   # wh · dhh
        dwh = dwh + _mm(h_prev.t(), dhh, cast_bf16)            # h_prev · dhhᵀ
        dh = dh_prev
    return dxw, dwh, da, dh


class GRUSequence(torch.autograd.Function):
    """The reference's custom vjp: the backward replays the recurrence from
    the saved inputs and seq."""

    @staticmethod
    def forward(ctx, xw, wh, mask, att, h0):
        if on_cpu(xw, wh, mask, att, h0):
            seq = gru_sequence_reference(xw, wh, mask, att, h0)
        else:
            seq = gru_sequence_forward(xw, wh, mask, att, h0)
        ctx.save_for_backward(xw, wh, mask, att, h0, seq)
        return seq

    @staticmethod
    def backward(ctx, dseq):
        refuse_double_backward("gru_sequence")
        xw, wh, mask, att, h0, seq = ctx.saved_tensors
        if on_cpu(xw, wh, mask, att, h0, seq, dseq):
            dxw, dwh, da, dh0 = gru_sequence_backward_reference(
                xw, wh, mask, att, h0, seq, dseq)
        else:
            dxw, dwh, da, dh0 = gru_sequence_backward(
                xw, wh, mask, att, h0, seq, dseq.contiguous())
        return dxw, dwh, None, da, dh0


def gru_sequence(xw: torch.Tensor, wh: torch.Tensor, mask: torch.Tensor,
                 att: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """xw (B, L, 3H), wh (H, 3H), mask (B, L) of 0/1, att (B, L) (ones for a
    plain GRU), h0 (B, H) → seq (B, L, H), f32."""
    return GRUSequence.apply(xw, wh, mask, att, h0)


def _check(what: str, **t: torch.Tensor):
    """(B, L, H); raises ``ValueError`` on anything the kernels do not take."""
    check_cuda_inputs(what, NDIMS, **t)
    b, l, h3 = t["xw"].shape
    h = h3 // 3
    want = {"wh": (h, h3), "mask": (b, l), "att": (b, l), "h0": (b, h),
            "seq": (b, l, h), "dseq": (b, l, h)}
    bad = {k: tuple(v.shape) for k, v in t.items()
           if k != "xw" and tuple(v.shape) != want[k]}
    if h3 % 3 or bad:
        raise ValueError(f"{what}: shapes {bad} do not fit xw {tuple(t['xw'].shape)} "
                         "(B, L, 3H): wh (H, 3H), mask and att (B, L), h0 (B, H), "
                         "seq and dseq (B, L, H)")
    if h < 1:
        raise ValueError(f"{what}: hidden size H = {h} is below 1")
    if max(b * l * h3, h * h3) >= 2 ** 31:
        raise ValueError(f"{what}: shape (B={b}, L={l}, H={h}) is beyond the "
                         "kernels' int32 indexing")
    return b, l, h


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its three C functions bound."""
    lib = _build.load(name)
    n_ptr = 6 if name == "gru_fwd" else 12
    for fname in (name, f"{name}_warp", f"{name}_wide"):
        fn = getattr(lib, fname)
        n_int = 3 if fname.endswith("_wide") else 4   # (B, L, H[, rows])
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if name == "gru_bwd":
        lib.gru_bwd_wide_partials.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gru_bwd_wide_partials.restype = ctypes.c_int
    return lib


def gru_sequence_forward(xw, wh, mask, att, h0, instance: str | None = None
                         ) -> torch.Tensor:
    """The forward kernel (``csrc/gru_fwd.cu``) on CUDA tensors: the
    contract of ``gru_sequence_reference``, through ``instance`` (default:
    the one ``forward_instance`` names; the warp instance takes H ≤ 16, the
    block instance H ≤ 64, the wide one H > 64). Raises on anything the
    kernel does not take; never runs the plain version."""
    global gru_fwd_launches
    b, l, h = _check("gru_sequence", xw=xw, wh=wh, mask=mask, att=att, h0=h0)
    name = instance or forward_instance(h)
    if name not in ("gru_fwd", "gru_fwd_warp", "gru_fwd_wide"):
        raise ValueError(f"gru_sequence: no forward instance {name!r}")
    seq = xw.new_empty((b, l, h))
    if b * l == 0:   # nothing to run: seq is empty
        return seq
    rows = instance_rows(name, h)
    with torch.cuda.device(xw.device):
        err = getattr(_lib("gru_fwd"), name)(
            xw.data_ptr(), wh.data_ptr(), mask.data_ptr(), att.data_ptr(),
            h0.data_ptr(), seq.data_ptr(), b, l, h, *([] if rows is None else [rows]),
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    gru_fwd_launches += 1
    instance_launches[name] = instance_launches.get(name, 0) + 1
    return seq


def gru_sequence_backward(xw, wh, mask, att, h0, seq, dseq):
    """The backward kernel (``csrc/gru_bwd.cu``, the instance
    ``backward_instance`` names) on CUDA tensors: the contract of
    ``gru_sequence_backward_reference``, with dwh summed from fixed
    per-block partials in a fixed order (the same inputs give the same
    bits). Raises on anything the kernel does not take; never runs the plain
    version."""
    global gru_bwd_launches
    b, l, h = _check("gru_sequence backward", xw=xw, wh=wh, mask=mask, att=att,
                     h0=h0, seq=seq, dseq=dseq)
    dxw, da, dh0 = torch.empty_like(xw), torch.empty_like(att), torch.empty_like(h0)
    dwh = torch.empty_like(wh)   # the kernel writes every entry
    if b * l == 0:   # no step: the gradients of wh and h0 are zero
        return dxw, dwh.zero_(), da, dh0.zero_()
    name, rows, lib = backward_instance(h), backward_rows(h), _lib("gru_bwd")
    with torch.cuda.device(xw.device):
        # one (H, 3H) dwh partial a block; the wide instance's library states
        # its count on this card
        blocks = -(-b // rows) if rows else lib.gru_bwd_wide_partials(b, h)
        if blocks < 0:
            raise RuntimeError(f"{name} could not plan its grid: CUDA error {-blocks}")
        part = xw.new_empty((blocks, h, 3 * h))
        err = getattr(lib, name)(
            xw.data_ptr(), wh.data_ptr(), mask.data_ptr(), att.data_ptr(),
            h0.data_ptr(), seq.data_ptr(), dseq.data_ptr(), dxw.data_ptr(),
            dwh.data_ptr(), da.data_ptr(), dh0.data_ptr(), part.data_ptr(),
            b, l, h, *([] if rows is None else [rows]),
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    gru_bwd_launches += 1
    instance_launches[name] = instance_launches.get(name, 0) + 1
    return dxw, dwh, da, dh0
