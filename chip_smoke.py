#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi gives them; no CUDA
   device means an immediate non-zero exit;
2. build: every CUDA kernel of the port from ``ops/kernels/csrc`` (one
   ``nvcc`` per source, all started together; timed);
3. kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them, with kernel, plain, library and bound times:
   the CIN forward, the CIN backward (whose dW must also be the same bits on
   a second run), and the field-attention forward and backward, also at the
   two edges of their gate with a random key mask and one batch row whose
   keys are all masked (uniform weights over all keys);
4. serving: full-width xDeepFM on the Criteo schema (26 fields of 100k ids,
   dim 8, CIN (128, 128), MLP (256, 128)) with seeded random weights,
   exported and scored through ``load_scorer`` → ``Scorer.predict_proba`` on
   the card by default. The scores must be finite probabilities, the CIN
   forward kernel must have launched twice a batch, and the scores must agree
   with the same model whose CIN runs the plain version;
5. training: the same model built by ``get_model`` on the card by default.
   (a) 5 Adam steps at B 4096 with the CIN on its kernels, then from the
   same weights with both directions forced onto the plain versions: the
   loss traces agree to 1e-3 and the step-1 gradients of every parameter
   to 1e-3·max|g|, with two launches of each kernel a step; (b) training
   examples/s at B 4096 (median of 20 steps, host clock), device time per
   step (CUDA events) and peak memory; (c) ``fit`` on 262,144 rows (100 ids
   a field, otherwise full width), 3 epochs with an eval each epoch and the
   best restored: held-out AUC above 0.65 and two launches of each kernel a
   train step;
6. AutoInt serving, with ``ML_FUNCTION_TPU_FIELD_ATTN=1`` (set by this
   script): full-width AutoInt (the same schema, dim 8, 2 layers of 2 heads
   of 16) exported, loaded and scored as in 4, with two launches of the
   field-attention forward a batch and scores within 1e-4 of the plain
   version; examples/s and one forward's device time, with the flag and
   without it (the plain small-L route);
7. AutoInt training, as 5 with the field-attention kernels: 5 Adam steps
   against the plain versions, the rates, and a ``fit`` on the learning
   cell to held-out AUC above 0.6;
8. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Numerics: TF32 is off for matmuls and cuDNN, so every f32 product outside
the kernels is a full f32 product. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 4096
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
KERNELS = ("cin_fwd", "cin_bwd", "field_attn_fwd", "field_attn_bwd")
# AutoInt's attention at Criteo width: 26 fields + the dense pseudo-field,
# 2 heads of 16; then the gate's two edges (lq·lk = 4096, Dh 64; Lk 4096)
FA_MAIN = (BATCH, 27, 27, 2, 16)
FA_EDGES = ((512, 64, 64, 2, 64), (300, 1, 4096, 2, 8))
RTOL = 1e-3                # same rounding sites; only the f32 summation order differs
# Ids per field of the learning phase. At 1,000 the 262,144 rows overfit
# from the first epoch on, DeepFM (which runs no kernel) as much as xDeepFM:
# each of the 26,000 embedding rows is seen about 210 times an epoch
# (``python3 -m ml_function_tpu_torch.tools.learning_curve``).
LEARN_VOCAB = 100


T_START = time.perf_counter()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cin_bound(d: int, b: int, h: int, f: int, o: int, backward: bool = False):
    """Least time of one CIN layer on the card: bf16 products over the
    tensor-core rate against each input read and each output written once.
    Forward: 2·D·B·H·F·O flops; f32 xk, x0, w1 in and y out. Backward: three
    products of that size (U, dxk, dW); xk, x0, w1, dy in and dxk, dx0, dW
    out."""
    if backward:
        flops = 6 * d * b * h * f * o
        nbytes = 4 * (2 * d * b * h + 2 * d * b * f + d * b * o + 2 * h * f * o)
    else:
        flops = 2 * d * b * h * f * o
        nbytes = 4 * (d * b * h + d * b * f + h * f * o + d * b * o)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _layer_inputs(gen, d, b, h, f, o):
    xk = torch.randn(d, b, h, device="cuda", generator=gen)
    x0 = torch.randn(d, b, f, device="cuda", generator=gen) * 0.05
    w1 = torch.randn(h, f * o, device="cuda", generator=gen) * (2.0 / (h * f + o)) ** 0.5
    return xk, x0, w1


def _check_close(what: str, got, ref) -> tuple:
    """rtol 1e-3 with atol 1e-3·max|ref|; returns (max |err|, atol)."""
    err = (got - ref).abs()
    atol = RTOL * ref.abs().max().item()
    if not bool((err <= atol + RTOL * ref.abs()).all()):
        fail(f"{what} disagrees with its plain version: max |err| "
             f"{err.max().item()} (atol {atol})")
    return err.max().item(), atol


def _entry(name: str, source: str, replaces: str, shapes: list, calls: str) -> dict:
    """One kernels-line entry: per-shape numbers summed over the main path's
    two layer shapes (one call each per batch), the per-shape ones beside."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum(s["ms"] for s in shapes),
        "kernel_ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": sum(s["bound_ms"] for s in shapes),
        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": sum(s["library_ms"] for s in shapes),
        "library_calls": calls,
        "per_shape": shapes,
    }


def check_cin_kernel(cin_mod) -> dict:
    """cin_layer_t against cin_layer_t_reference at the two layer shapes of
    the main path (D 8, B 4096, F 26, O 128; H 26 then 128)."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for h in (26, 128):
        d, b, f, o = 8, BATCH, 26, 128
        xk, x0, w1 = _layer_inputs(gen, d, b, h, f, o)
        got = cin_mod.cin_layer_t(xk, x0, w1)
        torch.cuda.synchronize()
        err, atol = _check_close(f"cin_fwd at H={h}", got,
                                 cin_mod.cin_layer_t_reference(xk, x0, w1))
        xk_b, w1_b, x0_b = xk.bfloat16(), w1.bfloat16(), x0.bfloat16()
        bound_ms, bound_by = cin_bound(d, b, h, f, o)
        shapes.append({
            "shape": {"D": d, "B": b, "H": h, "F": f, "O": o},
            "max_abs_err": err, "atol": atol,
            "ms": event_ms(lambda: cin_mod.cin_layer_t(xk, x0, w1)),
            "plain_ms": event_ms(lambda: cin_mod.cin_layer_t_reference(xk, x0, w1)),
            # two calls: a bf16 GEMM and the F-reduce; no one call computes a CIN layer
            "library_ms": event_ms(lambda: torch.einsum(
                "dbfo,dbf->dbo", torch.matmul(xk_b, w1_b).view(d, b, f, o), x0_b)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    for s in shapes:
        print(f"cin_fwd {s['shape']}: max_abs_err {s['max_abs_err']:.3e} "
              f"(atol {s['atol']:.3e}), kernel {s['ms']:.4f} ms, plain "
              f"{s['plain_ms']:.4f} ms, library (2 calls) {s['library_ms']:.4f} ms, "
              f"bound {s['bound_ms']:.4f} ms ({s['bound_by']})")
    return _entry("cin_fwd", "ml_function_tpu_torch/ops/kernels/csrc/cin_fwd.cu",
                  "ml_function_tpu/ops/kernels/cin.py:49", shapes,
                  "torch.matmul (bf16) + torch.einsum F-reduce, per shape")


def check_cin_bwd_kernel(cin_mod) -> dict:
    """cin_layer_t_backward against cin_layer_t_backward_reference at the
    main path's two layer shapes, all three outputs; dW once more, which must
    give the same bits (fixed split-K partials, no atomics)."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = []
    for h in (26, 128):
        d, b, f, o = 8, BATCH, 26, 128
        xk, x0, w1 = _layer_inputs(gen, d, b, h, f, o)
        dy = torch.randn(d, b, o, device="cuda", generator=gen)
        got = cin_mod.cin_layer_t_backward(xk, x0, w1, dy)
        again = cin_mod.cin_layer_t_backward(xk, x0, w1, dy)
        torch.cuda.synchronize()
        ref = cin_mod.cin_layer_t_backward_reference(xk, x0, w1, dy)
        errs = [_check_close(f"cin_bwd {name} at H={h}", g, r)
                for name, g, r in zip(("dxk", "dx0", "dW"), got, ref)]
        if not torch.equal(got[2], again[2]):
            fail(f"cin_bwd dW differs between two runs at H={h}")
        # three calls: bf16 GEMMs for dxk and dW on a du already in memory,
        # and an einsum for dx0; no one call computes this backward
        xk_b, w1_b, dy_b = xk.bfloat16(), w1.bfloat16(), dy.bfloat16()
        du_b = (x0.unsqueeze(-1) * dy.unsqueeze(2)).reshape(d * b, f * o).bfloat16()
        w3_b = w1_b.view(h, f, o)

        def library():
            torch.matmul(du_b, w1_b.t())
            torch.matmul(xk_b.view(d * b, h).t(), du_b)
            torch.einsum("dbh,hfo,dbo->dbf", xk_b, w3_b, dy_b)

        bound_ms, bound_by = cin_bound(d, b, h, f, o, backward=True)
        shapes.append({
            "shape": {"D": d, "B": b, "H": h, "F": f, "O": o},
            "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_dxk_dx0_dw": [e for e, _ in errs],
            "atol_dxk_dx0_dw": [a for _, a in errs],
            "ms": event_ms(lambda: cin_mod.cin_layer_t_backward(xk, x0, w1, dy)),
            "plain_ms": event_ms(
                lambda: cin_mod.cin_layer_t_backward_reference(xk, x0, w1, dy)),
            "library_ms": event_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    for s in shapes:
        print(f"cin_bwd {s['shape']}: max_abs_err dxk/dx0/dW "
              + "/".join(f"{e:.3e}" for e in s["max_abs_err_dxk_dx0_dw"])
              + " (atol " + "/".join(f"{a:.3e}" for a in s["atol_dxk_dx0_dw"])
              + f"), dW bit-identical on a second run, kernel {s['ms']:.4f} ms, "
              f"plain {s['plain_ms']:.4f} ms, library (3 calls) "
              f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']})")
    return _entry("cin_bwd", "ml_function_tpu_torch/ops/kernels/csrc/cin_bwd.cu",
                  "ml_function_tpu/ops/kernels/cin.py:62", shapes,
                  "torch.matmul (bf16) for dxk and for dW + torch.einsum for "
                  "dx0, per shape")


def fa_bound(b: int, lq: int, lk: int, h: int, dh: int, backward: bool = False):
    """Least time of one field-attention call on the card: f32 products over
    the f32 CUDA-core rate against each input read and each output written
    once. Forward: 4·B·H·Lq·Lk·Dh flops; q, k, v, bias in, o out. Backward:
    10·B·H·Lq·Lk·Dh (the weights recomputed, dA, dV, dQ, dK); q, k, v, bias,
    dO in, dQ, dK, dV out."""
    n_q, n_k = b * lq * h * dh, b * lk * h * dh
    if backward:
        flops = 10 * b * h * lq * lk * dh
        nbytes = 4 * (2 * n_q + 2 * n_k + b * lk + n_q + 2 * n_k)
    else:
        flops = 4 * b * h * lq * lk * dh
        nbytes = 4 * (n_q + 2 * n_k + b * lk + n_q)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _fa_inputs(gen, b, lq, lk, h, dh, masked):
    """q, k, v, dO from the generator; with ``masked``, a random key mask
    that keeps key 0, and batch row 1 with every key masked."""
    q, do = (torch.randn(b, lq, h, dh, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(b, lk, h, dh, device="cuda", generator=gen) for _ in range(2))
    bias = torch.zeros(b, lk, device="cuda")
    if masked:
        mask = torch.rand(b, lk, device="cuda", generator=gen) > 0.3
        mask[:, 0] = True
        mask[1] = False
        bias = torch.where(mask, 0.0, -1e9)
    return q, k, v, bias, do, 1.0 / dh ** 0.5


def check_field_attn_kernels(fa_mod) -> list:
    """field_attention and field_attention_backward against their plain
    versions at AutoInt's shape and the gate's two edges, with times. The
    library yardstick is ``scaled_dot_product_attention`` in f32 with the
    bias as its mask: its forward, and its forward plus backward through
    ``torch.autograd.grad`` less the forward."""
    import torch.nn.functional as F

    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(4)
    fwd_shapes, bwd_shapes = [], []
    for shape in (FA_MAIN,) + FA_EDGES:
        b, lq, lk, h, dh = shape
        masked = shape != FA_MAIN
        q, k, v, bias, do, scale = _fa_inputs(gen, b, lq, lk, h, dh, masked)
        got = fa_mod.field_attention(q, k, v, bias, scale)
        grads = fa_mod.field_attention_backward(q, k, v, bias, do, scale)
        torch.cuda.synchronize()
        where = f"(B={b}, Lq={lq}, Lk={lk}, H={h}, Dh={dh})"
        err, atol = _check_close(f"field_attn_fwd at {where}", got,
                                 fa_mod.field_attention_reference(q, k, v, bias, scale))
        if masked:
            _check_close(f"field_attn_fwd's all-masked row at {where}", got[1],
                         v[1].mean(dim=0, keepdim=True).expand(lq, -1, -1))
        errs = [_check_close(f"field_attn_bwd {name} at {where}", g, r)
                for name, g, r in zip(("dq", "dk", "dv"), grads,
                                      fa_mod.field_attention_backward_reference(
                                          q, k, v, bias, do, scale))]

        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        mask4 = bias[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask4, scale=scale)
        with torch.no_grad():
            sdpa_err = (sdpa().transpose(1, 2) - got).abs().max().item()
            sdpa_fwd_ms = event_ms(sdpa)
        do_t = do.transpose(1, 2)
        sdpa_both_ms = event_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do_t))
        common = {"shape": {"B": b, "Lq": lq, "Lk": lk, "H": h, "Dh": dh},
                  "masked": masked}
        fb, fby = fa_bound(b, lq, lk, h, dh)
        fwd_shapes.append({
            **common, "max_abs_err": err, "atol": atol,
            "ms": event_ms(lambda: fa_mod.field_attention(q, k, v, bias, scale)),
            "plain_ms": event_ms(
                lambda: fa_mod.field_attention_reference(q, k, v, bias, scale)),
            "library_ms": sdpa_fwd_ms, "library_max_abs_diff": sdpa_err,
            "bound_ms": fb, "bound_by": fby})
        bb, bby = fa_bound(b, lq, lk, h, dh, backward=True)
        bwd_shapes.append({
            **common, "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_dq_dk_dv": [e for e, _ in errs],
            "atol_dq_dk_dv": [a for _, a in errs],
            "ms": event_ms(lambda: fa_mod.field_attention_backward(
                q, k, v, bias, do, scale)),
            "plain_ms": event_ms(lambda: fa_mod.field_attention_backward_reference(
                q, k, v, bias, do, scale)),
            "library_ms": sdpa_both_ms - sdpa_fwd_ms,
            "bound_ms": bb, "bound_by": bby})
    for s in fwd_shapes:
        print(f"field_attn_fwd {s['shape']} masked={s['masked']}: max_abs_err "
              f"{s['max_abs_err']:.3e} (atol {s['atol']:.3e}), kernel {s['ms']:.4f} ms, "
              f"plain {s['plain_ms']:.4f} ms, library (SDPA f32) {s['library_ms']:.4f} ms "
              f"(max |diff| {s['library_max_abs_diff']:.3e}), bound "
              f"{s['bound_ms']:.4f} ms ({s['bound_by']})")
    for s in bwd_shapes:
        print(f"field_attn_bwd {s['shape']} masked={s['masked']}: max_abs_err dq/dk/dv "
              + "/".join(f"{e:.3e}" for e in s["max_abs_err_dq_dk_dv"])
              + " (atol " + "/".join(f"{a:.3e}" for a in s["atol_dq_dk_dv"])
              + f"), kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, library "
              f"(SDPA f32 forward+backward less forward) {s['library_ms']:.4f} ms, "
              f"bound {s['bound_ms']:.4f} ms ({s['bound_by']})")
    replaces = "ml_function_tpu/ops/kernels/field_attention.py"
    return [_fa_entry("field_attn_fwd", f"{replaces}:77", fwd_shapes,
                      "torch.nn.functional.scaled_dot_product_attention (f32, "
                      "attn_mask = bias), forward"),
            _fa_entry("field_attn_bwd", f"{replaces}:82", bwd_shapes,
                      "scaled_dot_product_attention (f32, attn_mask = bias): "
                      "torch.autograd.grad of its forward, less the forward")]


def _fa_entry(name: str, replaces: str, shapes: list, calls: str) -> dict:
    """One kernels-line entry: the numbers of one call at AutoInt's shape
    (two calls, one a layer, per forward or backward); every shape's beside."""
    main = shapes[0]
    return {
        "name": name, "route": "cuda",
        "source": f"ml_function_tpu_torch/ops/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "kernel_ms": main["ms"], "per": "one call at the main shape (2 a pass)",
        "library_calls": calls, "per_shape": shapes,
    }


def plain_field_attention(fa_mod):
    """Field attention on its plain versions in both directions, on the
    card: a hook of this script, not an option of the package."""

    class PlainFieldAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias, scale):
            ctx.save_for_backward(q, k, v, bias)
            ctx.scale = scale
            return fa_mod.field_attention_reference(q, k, v, bias, scale)

        @staticmethod
        def backward(ctx, do):
            return (*fa_mod.field_attention_backward_reference(
                *ctx.saved_tensors, do, ctx.scale), None, None)

    return PlainFieldAttention.apply


@contextlib.contextmanager
def swapped(module, attr: str, plain):
    """``module.attr`` is ``plain`` inside the block."""
    real = getattr(module, attr)
    setattr(module, attr, plain)
    try:
        yield
    finally:
        setattr(module, attr, real)


def expect(**counts) -> dict:
    """Launch counts of every kernel, 0 where not given."""
    return {name: counts.get(name, 0) for name in KERNELS}


def plain_cin_layer(cin_mod):
    """The CIN layer on its plain versions in both directions, on the card:
    a hook of this script, not an option of the package."""

    class PlainCIN(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xk_t, x0_t, w1):
            ctx.save_for_backward(xk_t, x0_t, w1)
            return cin_mod.cin_layer_t_reference(xk_t, x0_t, w1)

        @staticmethod
        def backward(ctx, dy_t):
            return cin_mod.cin_layer_t_backward_reference(*ctx.saved_tensors, dy_t)

    return PlainCIN.apply


def train_phase(model_name: str, plain_route, kernels: tuple, paths: tuple,
                auc_bar: float, drive, launches_by_path) -> None:
    """(a) 5 Adam steps on the kernels against the same steps on the plain
    versions (``plain_route()`` forces both directions there), (b) rates,
    (c) ``fit`` on the learning cell. ``kernels`` are the model's forward and
    backward kernels, each launched twice a step; ``paths`` name the parity
    and fit runs in ``launches_by_path``."""
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.tools.timing import event_ms
    from ml_function_tpu_torch.train.loop import (fit, iter_batches,
                                                  make_train_step, to_device,
                                                  train_test_split)
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    fwd, bwd = kernels
    parity_path, fit_path = paths
    # (a) parity: the kernels against the plain versions over 5 Adam steps
    fs, data = make_criteo_like(n_rows=5 * BATCH, vocab_size=100_000, seed=0)
    model = get_model(model_name, fs, generator=torch.Generator().manual_seed(0))
    if next(model.parameters()).device.type != "cuda":
        fail("get_model did not place the model on the card by default")
    batches = list(iter_batches(data, BATCH))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def five_steps():
        model.load_state_dict(init)
        step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
        losses, grads = [], None
        for b in batches:
            losses.append(step(b)["loss"].item())
            if grads is None:   # AutoInt's unread linear table has no gradient
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters() if p.grad is not None}
        return losses, grads

    losses, grads = drive(parity_path, five_steps)
    with plain_route():
        ref_losses, ref_grads = five_steps()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"{model_name} training parity, 5 Adam steps at B={BATCH}: losses {losses}, "
          f"plain versions {ref_losses}, max rel diff {max(rel):.3e}; launches "
          f"{launches_by_path[parity_path]}")
    if not all(np.isfinite(losses)) or max(rel) > 1e-3:
        fail(f"{model_name} training losses differ from the plain run by more than 1e-3")
    if grads.keys() != ref_grads.keys():
        fail(f"{model_name}: the kernels' run and the plain run give gradients to "
             "different parameters")
    worst = 0.0
    for n, g in grads.items():
        r = ref_grads[n]
        atol = RTOL * r.abs().max().item()
        err = (g - r).abs()
        if not bool((err <= atol + RTOL * r.abs()).all()):
            fail(f"step-1 gradient of {n} differs from the plain run: "
                 f"max |err| {err.max().item()} (atol {atol})")
        worst = max(worst, err.max().item() / max(r.abs().max().item(), 1e-30))
    print(f"step-1 gradients of {len(grads)} parameters agree with the plain "
          f"run: max |err|/max|g| {worst:.3e}")
    if launches_by_path[parity_path] != expect(**{fwd: 10, bwd: 10}):
        fail(f"expected 2 launches of {fwd} and of {bwd} per train step")

    # (b) rates at B 4096, on this model at Criteo width
    step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(20):
        t = time.perf_counter()
        step(batches[i % len(batches)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2**20
    on_card = to_device(batches[0], torch.device("cuda"))
    step_ms = event_ms(lambda: step(on_card), reps=10, inner=5)
    wall = statistics.median(walls)
    print(f"{model_name} training at B={BATCH} (Criteo width, vocab 100k): "
          f"{wall * 1e3:.3f} ms a step, {BATCH / wall:.1f} examples/s (median of "
          f"20, host clock, batch from host); device time per step {step_ms:.4f} ms "
          f"(CUDA events, batch on the card, {BATCH / step_ms * 1e3:.1f} "
          f"examples/s); peak memory {peak:.1f} MiB")
    del model, step, init, grads, ref_grads

    # (c) learning through fit, with the reference's early-stopping recipe:
    # an eval each epoch, patience 2, the best epoch's weights restored
    fs, data = make_criteo_like(n_rows=262_144, vocab_size=LEARN_VOCAB, seed=0)
    tr, te = train_test_split(data, 0.2, seed=1)
    model = get_model(model_name, fs, generator=torch.Generator().manual_seed(0))
    steps_per_epoch = -(-len(tr["label"]) // BATCH)
    t = time.perf_counter()
    ts, res = drive(fit_path, lambda: fit(
        model, tr, epochs=3, batch_size=BATCH, learning_rate=5e-3,
        eval_data=te, seed=0, eval_every=steps_per_epoch, patience=2))
    fit_s = time.perf_counter() - t
    auc = res.eval_metrics["auc"]
    evals = len(res.history.records) + 1       # each epoch's, and the last
    eval_batches = evals * -(-len(te["label"]) // BATCH)
    got = launches_by_path[fit_path]
    print(f"{model_name} fit: {res.steps} steps of B={BATCH} in {fit_s:.1f} s, "
          f"{res.examples_per_sec:.1f} examples/s (fit's timer); held-out AUC by "
          f"epoch {res.history.series('auc')}, best at step {res.best_step}; "
          f"train {res.train_metrics}; launches {got}")
    print(f"{model_name} held-out AUC {auc:.4f}")
    if not auc > auc_bar:
        fail(f"{model_name} held-out AUC {auc} is not above {auc_bar}")
    if got != expect(**{fwd: 2 * (res.steps + eval_batches), bwd: 2 * res.steps}):
        fail(f"fit launched {got}; expected 2 of each kernel per train step "
             f"and 2 {fwd} per eval batch ({res.steps} steps, {eval_batches} "
             f"eval batches)")


def score_phase(name: str, scorer, data, drive, launches_by_path, plain_route,
                fwd: str) -> dict:
    """Score ``data`` through ``predict_proba`` on the card: finite
    probabilities, 2 launches of ``fwd`` a batch and none of any other
    kernel, and scores within 1e-4 of the same scorer on the plain route;
    then examples/s over full batches and one forward's device time.
    Returns the batch that forward was timed on, already on the card."""
    from ml_function_tpu_torch.tools.timing import event_ms

    if next(scorer.model.parameters()).device.type != "cuda":
        fail("load_scorer did not place the model on the card by default")
    n_rows = len(data["label"])
    scores = drive(name, lambda: scorer.predict_proba(data))
    launches = launches_by_path[name]
    n_batches = -(-n_rows // BATCH)
    print(f"{name}: {n_rows} rows in {n_batches} batches of {BATCH}, "
          f"launches {launches}")
    if scores.shape != (n_rows,) or not np.isfinite(scores).all():
        fail(f"scores not finite or of shape {scores.shape}")
    if not ((scores > 0) & (scores < 1)).all():
        fail("scores outside (0, 1)")
    if launches != expect(**{fwd: 2 * n_batches}):
        fail(f"{name} launched {launches}, expected {fwd} {2 * n_batches}")

    # the same model with its kernel forced through the plain version
    with plain_route():
        ref_scores = scorer.predict_proba(data)
    diff = float(np.abs(scores - ref_scores).max())
    print(f"{name} vs the plain version: max |score diff| {diff:.3e}")
    if diff > 1e-4:
        fail(f"scores differ from the plain version's by {diff}")

    # scoring rate at B = 4096 over full batches: host batching, copies and
    # the forward, as a caller of predict_proba sees it
    full = {k: v[:3 * BATCH] for k, v in data.items()}
    scorer.predict_proba(full)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        scorer.predict_proba(full)
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    # the device's share: one forward on a batch already on the card
    batch = {k: torch.as_tensor(v[:BATCH], device="cuda")
             for k, v in data.items() if k in ("dense", "sparse")}
    with torch.inference_mode():
        fwd_ms = event_ms(lambda: scorer.model(batch))
    print(f"{name} at B={BATCH}: predict_proba {wall * 1e3:.3f} ms for "
          f"{3 * BATCH} rows, {3 * BATCH / wall:.1f} examples/s; one forward on "
          f"the card {fwd_ms:.4f} ms ({BATCH / fwd_ms * 1e3:.1f} examples/s); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return batch


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops import attention, interactions
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.ops.kernels import cin as cin_mod
    from ml_function_tpu_torch.ops.kernels import field_attention as fa_mod
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.tools.timing import event_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # AutoInt's attention takes the field-attention kernel only with the
    # reference's opt-in switch, read at call time
    os.environ["ML_FUNCTION_TPU_FIELD_ATTN"] = "1"

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    kernels = [check_cin_kernel(cin_mod), check_cin_bwd_kernel(cin_mod),
               *check_field_attn_kernels(fa_mod)]
    counters = {name: (mod, f"{name}_launches")
                for mod, name in ((cin_mod, "cin_fwd"), (cin_mod, "cin_bwd"),
                                  (fa_mod, "field_attn_fwd"),
                                  (fa_mod, "field_attn_bwd"))}
    launches_by_path = {}

    def drive(path, fn):
        """Run one main path with every count at 0; returns its launches."""
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        out = fn()
        launches_by_path[path] = {name: getattr(mod, attr)
                                  for name, (mod, attr) in counters.items()}
        return out

    # the plain versions, forced in both directions (hooks of this script,
    # not options of the package)
    def plain_cin():
        return swapped(interactions, "cin_layer_t", plain_cin_layer(cin_mod))

    def plain_fa():
        return swapped(attention, "field_attention", plain_field_attention(fa_mod))

    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    n_rows = 3 * BATCH + 1000
    _, data = make_criteo_like(n_rows=n_rows, vocab_size=100_000, seed=0)

    # 4. serving xDeepFM
    hp = {"cin_hidden": [128, 128], "hidden": [256, 128]}
    model = get_model("xdeepfm", fs, device="cuda",
                      generator=torch.Generator().manual_seed(0),
                      **{k: tuple(v) for k, v in hp.items()})
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "xdeepfm", fs, model, hyperparams=hp)
        del model
        scorer = load_scorer(tmp, batch_size=BATCH)
    score_phase("serving", scorer, data, drive, launches_by_path, plain_cin, "cin_fwd")

    # 5. training xDeepFM
    del scorer
    train_phase("xdeepfm", plain_cin, ("cin_fwd", "cin_bwd"),
                ("training_parity", "training_fit"), 0.65, drive, launches_by_path)

    # 6. serving AutoInt, through the field-attention kernel
    hp = {"n_layers": 2, "num_heads": 2, "head_dim": 16}
    model = get_model("autoint", fs, generator=torch.Generator().manual_seed(0), **hp)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "autoint", fs, model, hyperparams=hp)
        del model
        scorer = load_scorer(tmp, batch_size=BATCH)
    batch = score_phase("autoint_serving", scorer, data, drive, launches_by_path,
                        plain_fa, "field_attn_fwd")
    os.environ.pop("ML_FUNCTION_TPU_FIELD_ATTN")
    with torch.inference_mode():
        small_ms = event_ms(lambda: scorer.model(batch))
    os.environ["ML_FUNCTION_TPU_FIELD_ATTN"] = "1"
    print(f"autoint one forward on the card without the flag (the plain small-L "
          f"route): {small_ms:.4f} ms ({BATCH / small_ms * 1e3:.1f} examples/s)")

    # 7. training AutoInt
    del scorer, batch
    train_phase("autoint", plain_fa, ("field_attn_fwd", "field_attn_bwd"),
                ("autoint_training_parity", "autoint_fit"), 0.6, drive,
                launches_by_path)

    # 8. result lines: each kernel's launches are those of the newest path
    # that runs it (a fit); every path's own counts ride along
    for k in kernels:
        runs = [p for p, c in launches_by_path.items() if c[k["name"]]]
        k["launches"] = launches_by_path[runs[-1]][k["name"]]
        k["launches_path"] = runs[-1]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in launches_by_path.items()}
    print(f"wall time of the run: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
