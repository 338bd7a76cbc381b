"""Fused CIN layer: CUDA kernels for Hopper, forward and backward, and their
plain versions.

Counterpart of ``ml_function_tpu/ops/kernels/cin.py``. The kernels
(``csrc/cin_fwd.cu``, ``csrc/cin_bwd.cu``) replace the Pallas ``_fwd_kernel``
and ``_bwd_kernel``; each source note says what bounds it on the H100 and how
the design answers that. Like the TPU kernels they never write the
interaction tensor Z (B, H·F, D), the product U (B, F·O) or its cotangent to
device memory.

    y[d,b,o] = Σ_f x0[d,b,f] · Σ_h bf16(xk[d,b,h]) · bf16(w1[h, f·O+o])

Products and sums are f32; the forward rounds only ``xk`` and ``w1`` to bf16,
and the backward rounds ``xk``, ``w1`` and ``du = x0·dy`` as the TPU kernel
does (``cin_layer_t_backward_reference``).

Each kernel has two instances of one C contract, chosen by (H, F)
(``forward_instance``, ``backward_instance``, which ask the libraries for
each instance's shared memory): ``cin_fwd`` and ``cin_bwd`` hold a block's
whole (128, pad16(H)) tiles in shared memory, with at least two weight
stages in the forward, which at F 26 takes H up to 272 forward and 176
backward; ``cin_fwd_wide`` and ``cin_bwd_wide`` stream H in k-chunks for
the wider shapes (forward to pad64(H) = 1472 at F ≤ 39, backward any H at
F ≤ 429). Each block instance stops where the wide one becomes the faster
(``tools/cin_instances.py``).

``cin_layer_t`` is a ``torch.autograd.Function``: for tensors on the CPU both
directions run the plain versions, for CUDA tensors they launch the kernels;
it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._checks import check_cuda_inputs, on_cpu, refuse_double_backward

BLOCK_B = 256
# The kernels' inputs: 3-d activations, the 2-d weight.
NDIMS = {"xk_t": 3, "x0_t": 3, "w1": 2, "dy_t": 3}
# Shared memory a block may use on the H100 (232,448 bytes).
MAX_SMEM_BYTES = 232_448

# Launches of each CUDA kernel since its count was last set to 0, and of
# each instance (C function) by name since the dict was last cleared.
cin_fwd_launches = 0
cin_bwd_launches = 0
instance_launches: dict = {}


def supports(b: int, f: int, o: int, d: int) -> bool:
    """The reference's gate (``ml_function_tpu/ops/kernels/cin.py``): with
    the same gate the port and the reference take the same numeric route."""
    return b % BLOCK_B == 0 and o % 128 == 0 and f >= 1 and d >= 1


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def cin_layer_t_reference(xk_t: torch.Tensor, x0_t: torch.Tensor,
                          w1: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding sites:
    xk_t (D, B, H), x0_t (D, B, F), w1 (H, F·O) → (D, B, O)."""
    d, b, _ = xk_t.shape
    f = x0_t.shape[2]
    u = torch.matmul(_bf16(xk_t), _bf16(w1))
    return (u.view(d, b, f, -1) * x0_t.unsqueeze(-1)).sum(dim=2)


def cin_layer_t_backward_reference(xk_t: torch.Tensor, x0_t: torch.Tensor,
                                   w1: torch.Tensor, dy_t: torch.Tensor):
    """Plain PyTorch version of the backward, with the TPU kernel's rounding
    sites written out (not autograd of the forward, which rounds elsewhere):
    U = bf16(xk) @ bf16(w1) recomputed, dx0 = Σ_o U·dy, du = x0·dy in f32,
    dxk = bf16(du) @ bf16(w1)ᵀ and dW = Σ_{d,b} bf16(xk)ᵀ·bf16(du).
    Returns (dxk_t (D, B, H), dx0_t (D, B, F), dw1 (H, F·O)), all f32."""
    d, b, h = xk_t.shape
    f = x0_t.shape[2]
    xb, wb = _bf16(xk_t), _bf16(w1)
    u = torch.matmul(xb, wb).view(d, b, f, -1)
    dx0 = (u * dy_t.unsqueeze(2)).sum(dim=-1)
    du = _bf16((x0_t.unsqueeze(-1) * dy_t.unsqueeze(2)).reshape(d, b, -1))
    dxk = torch.matmul(du, wb.t())
    dw = torch.matmul(xb.reshape(-1, h).t(), du.reshape(d * b, -1))
    return dxk, dx0, dw


class CINLayer(torch.autograd.Function):
    """One CIN layer with the TPU kernel's custom vjp: the backward recomputes
    U from the saved inputs rather than saving it. ``xk_t`` may be ``x0_t``
    itself (the first layer); autograd then adds the two gradients."""

    @staticmethod
    def forward(ctx, xk_t, x0_t, w1):
        ctx.save_for_backward(xk_t, x0_t, w1)
        if on_cpu(xk_t, x0_t, w1):
            return cin_layer_t_reference(xk_t, x0_t, w1)
        return _launch_fwd(xk_t, x0_t, w1)

    @staticmethod
    def backward(ctx, dy_t):
        refuse_double_backward("cin_layer_t")
        xk_t, x0_t, w1 = ctx.saved_tensors
        if on_cpu(xk_t, x0_t, w1, dy_t):
            return cin_layer_t_backward_reference(xk_t, x0_t, w1, dy_t)
        return cin_layer_t_backward(xk_t, x0_t, w1, dy_t.contiguous())


def cin_layer_t(xk_t: torch.Tensor, x0_t: torch.Tensor,
                w1: torch.Tensor) -> torch.Tensor:
    """One CIN layer on TRANSPOSED activations: xk_t (D, B, H),
    x0_t (D, B, F), w1 (H, F·O) → (D, B, O). ``w1`` is the (H·F, O) layer
    weight viewed as ``W.reshape(H, F, O).reshape(H, F·O)``."""
    return CINLayer.apply(xk_t, x0_t, w1)


def _shape(name: str, xk_t, x0_t, w1):
    """(D, B, H, F, O) of a layer; raises on shapes the kernels do not take."""
    d, b, h = xk_t.shape
    f = x0_t.shape[2]
    if x0_t.shape[:2] != (d, b) or w1.shape[0] != h or f == 0 or w1.shape[1] % f:
        raise ValueError(f"{name}: shapes xk_t {tuple(xk_t.shape)}, x0_t "
                         f"{tuple(x0_t.shape)}, w1 {tuple(w1.shape)} do not "
                         "form (D,B,H), (D,B,F), (H,F·O)")
    o = w1.shape[1] // f
    if d > 65535 or max(d * b * h, d * b * f, d * b * o, h * f * o) >= 2 ** 31:
        raise ValueError(f"{name}: shape (D={d}, B={b}, H={h}, F={f}, "
                         f"O={o}) is beyond the kernel's int32 indexing")
    return d, b, h, f, o


def _pad(h: int, m: int) -> int:
    return -(-h // m) * m


def _smem_fits(lib, name: str, h: int, f: int) -> bool:
    return getattr(lib, f"{name}_smem_bytes")(h, f) <= MAX_SMEM_BYTES


def _refuse_smem(name: str, lib, h: int, f: int) -> None:
    if not _smem_fits(lib, name, h, f):
        raise NotImplementedError(
            f"{name}: H={h}, F={f} need {getattr(lib, f'{name}_smem_bytes')(h, f)} bytes "
            f"of shared memory per block, more than the {MAX_SMEM_BYTES} a block may use")


def _first_fit(lib, names: tuple, h: int, f: int) -> str:
    """The first of ``names`` whose block fits in shared memory at (H, F),
    as its library states it; raises ``NotImplementedError`` if none does."""
    for name in names:
        if _smem_fits(lib, name, h, f):
            return name
    _refuse_smem(names[-1], lib, h, f)


def forward_instance(h: int, f: int) -> str:
    """The C function of ``csrc/cin_fwd.cu`` that takes (H, F): ``cin_fwd``
    where a block's whole (128, pad16(H)) xk tile and one weight stage fit
    beside x0, else ``cin_fwd_wide``. Raises ``NotImplementedError`` past
    the wide instance's reach. Asks the library, so it needs the card's
    toolchain."""
    return _first_fit(_lib_fwd(), ("cin_fwd", "cin_fwd_wide"), h, f)


def backward_instance(h: int, f: int) -> str:
    """The C function of ``csrc/cin_bwd.cu`` that takes (H, F): ``cin_bwd``
    where its rows pass holds a block's whole (TB, pad16(H)) tiles, else
    ``cin_bwd_wide``. Raises ``NotImplementedError`` past the wide rows
    pass's reach. Asks the library, so it needs the card's toolchain."""
    return _first_fit(_lib_bwd(), ("cin_bwd", "cin_bwd_wide"), h, f)


@functools.lru_cache(maxsize=None)
def _lib_fwd() -> ctypes.CDLL:
    lib = _build.load("cin_fwd")
    for fname in ("cin_fwd", "cin_fwd_wide"):
        getattr(lib, fname).argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        getattr(lib, fname).restype = ctypes.c_int
        getattr(lib, f"{fname}_smem_bytes").argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, f"{fname}_smem_bytes").restype = ctypes.c_size_t
    lib.cin_fwd_scratch_cols.argtypes = [ctypes.c_int]
    lib.cin_fwd_scratch_cols.restype = ctypes.c_int
    lib.cin_fwd_scratch_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cin_fwd_scratch_rows.restype = ctypes.c_int
    lib.cin_fwd_wide_scratch_elems.argtypes = [ctypes.c_int] * 3
    lib.cin_fwd_wide_scratch_elems.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("cin_bwd")
    for fname in ("cin_bwd", "cin_bwd_wide"):
        getattr(lib, fname).argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        getattr(lib, fname).restype = ctypes.c_int
        getattr(lib, f"{fname}_smem_bytes").argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, f"{fname}_smem_bytes").restype = ctypes.c_size_t
    lib.cin_bwd_scratch_cols.argtypes = [ctypes.c_int]
    lib.cin_bwd_scratch_cols.restype = ctypes.c_int
    lib.cin_bwd_splits.argtypes = [ctypes.c_int] * 4
    lib.cin_bwd_splits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_scratch(name: str, h: int, f: int, o: int) -> int:
    """bf16 elements of the named forward instance's weight scratch at
    (H, F, O), as its library states them."""
    lib = _lib_fwd()
    if name == "cin_fwd_wide":
        return lib.cin_fwd_wide_scratch_elems(h, f, o)
    return lib.cin_fwd_scratch_rows(f, o) * lib.cin_fwd_scratch_cols(h)


def _check_instance(name: str, known) -> None:
    if name not in known:
        raise ValueError(f"CIN: no instance {name!r}; have {known}")


def _launch_fwd(xk_t: torch.Tensor, x0_t: torch.Tensor,
                w1: torch.Tensor, instance: str | None = None) -> torch.Tensor:
    """The forward kernel on CUDA tensors through ``instance`` (default: the
    one ``forward_instance`` names; either instance takes a shape whose
    plan fits)."""
    global cin_fwd_launches
    check_cuda_inputs("cin_layer_t", NDIMS, xk_t=xk_t, x0_t=x0_t, w1=w1)
    d, b, h, f, o = _shape("cin_layer_t", xk_t, x0_t, w1)
    name = instance or forward_instance(h, f)
    _check_instance(name, ("cin_fwd", "cin_fwd_wide"))
    dev = xk_t.device
    y = torch.empty((d, b, o), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    _refuse_smem(name, _lib_fwd(), h, f)
    elems = _fwd_scratch(name, h, f, o)
    # bf16 scratch: each field's 128-wide O tiles of w1 in the kernel's layout
    wt = torch.empty(elems, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_lib_fwd(), name)(
            xk_t.data_ptr(), x0_t.data_ptr(), w1.data_ptr(), y.data_ptr(),
            wt.data_ptr(), d, b, h, f, o, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    cin_fwd_launches += 1
    instance_launches[name] = instance_launches.get(name, 0) + 1
    return y


def cin_layer_t_backward(xk_t: torch.Tensor, x0_t: torch.Tensor,
                         w1: torch.Tensor, dy_t: torch.Tensor,
                         instance: str | None = None):
    """The backward kernel (``csrc/cin_bwd.cu``) on CUDA tensors through
    ``instance`` (default: the one ``backward_instance`` names): the
    contract of ``cin_layer_t_backward_reference``. Raises on anything the
    kernel does not take; never runs the plain version."""
    global cin_bwd_launches
    what = "cin_layer_t backward"
    check_cuda_inputs(what, NDIMS, xk_t=xk_t, x0_t=x0_t, w1=w1, dy_t=dy_t)
    d, b, h, f, o = _shape(what, xk_t, x0_t, w1)
    if tuple(dy_t.shape) != (d, b, o):
        raise ValueError(f"{what}: dy_t {tuple(dy_t.shape)} is not (D, B, O) "
                         f"= {(d, b, o)}")
    name = instance or backward_instance(h, f)
    _check_instance(name, ("cin_bwd", "cin_bwd_wide"))
    dev = xk_t.device
    dxk = torch.empty((d, b, h), dtype=torch.float32, device=dev)
    dx0 = torch.empty((d, b, f), dtype=torch.float32, device=dev)
    dw = torch.empty((h, f * o), dtype=torch.float32, device=dev)
    if d * b == 0 or h * o == 0:   # empty sums
        return dxk.zero_(), dx0.zero_(), dw.zero_()
    lib = _lib_bwd()
    _refuse_smem(name, lib, h, f)
    # bf16 scratch: w1 transposed to (F·O, Hp) and xk as (D·B, Hp), Hp = pad16(H)
    hp = lib.cin_bwd_scratch_cols(h)
    wt = torch.empty((f * o, hp), dtype=torch.bfloat16, device=dev)
    xb = torch.empty((d * b, hp), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        splits = lib.cin_bwd_splits(d * b, h, f, o)
        if splits < 0:
            raise RuntimeError(f"cin_bwd could not plan its dW splits: CUDA error {-splits}")
        part = torch.empty((splits if splits > 1 else 0, h, f * o),
                           dtype=torch.float32, device=dev)
        err = getattr(lib, name)(xk_t.data_ptr(), x0_t.data_ptr(), w1.data_ptr(),
                                 dy_t.data_ptr(), dxk.data_ptr(), dx0.data_ptr(),
                                 dw.data_ptr(), wt.data_ptr(), xb.data_ptr(),
                                 part.data_ptr(), d, b, h, f, o,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    cin_bwd_launches += 1
    instance_launches[name] = instance_launches.get(name, 0) + 1
    return dxk, dx0, dw
