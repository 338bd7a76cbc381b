#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi gives them; no CUDA
   device means an immediate non-zero exit;
2. build: every CUDA kernel of the port from ``ops/kernels/csrc`` (one
   ``nvcc`` per source, all started together; timed);
3. kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them, with kernel, plain, library and bound times:
   the CIN forward, and the CIN backward (whose dW must also be the same
   bits on a second run);
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
   to 1e-3·max|g|, with two launches of each kernel a step; (b) ``fit`` on
   262,144 rows (100 ids a field, otherwise full width), 3 epochs with an
   eval each epoch and the best restored: held-out AUC above 0.65 and two
   launches of each kernel a train step; (c) training
   examples/s at B 4096 (median of 20 steps, host clock), device time per
   step (CUDA events) and peak memory;
6. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Numerics: TF32 is off for matmuls and cuDNN, so every f32 product outside
the kernels is a full f32 product. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 4096
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
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


def train_phase(cin_mod, interactions, drive, launches_by_path) -> None:
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.tools.timing import event_ms
    from ml_function_tpu_torch.train.loop import (fit, iter_batches,
                                                  make_train_step, to_device,
                                                  train_test_split)
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    # (a) parity: the kernels against the plain versions over 5 Adam steps
    fs, data = make_criteo_like(n_rows=5 * BATCH, vocab_size=100_000, seed=0)
    model = get_model("xdeepfm", fs, generator=torch.Generator().manual_seed(0))
    if model.cin.w0.device.type != "cuda":
        fail("get_model did not place the model on the card by default")
    batches = list(iter_batches(data, BATCH))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def five_steps():
        model.load_state_dict(init)
        step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
        losses, grads = [], None
        for b in batches:
            losses.append(step(b)["loss"].item())
            if grads is None:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        return losses, grads

    losses, grads = drive("training_parity", five_steps)
    interactions.cin_layer_t = plain_cin_layer(cin_mod)
    try:
        ref_losses, ref_grads = five_steps()
    finally:
        interactions.cin_layer_t = cin_mod.cin_layer_t
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"training parity, 5 Adam steps at B={BATCH}: losses {losses}, plain CIN "
          f"{ref_losses}, max rel diff {max(rel):.3e}; launches "
          f"{launches_by_path['training_parity']}")
    if not all(np.isfinite(losses)) or max(rel) > 1e-3:
        fail("training losses differ from the plain-CIN run by more than 1e-3")
    worst = 0.0
    for n, g in grads.items():
        r = ref_grads[n]
        atol = RTOL * r.abs().max().item()
        err = (g - r).abs()
        if not bool((err <= atol + RTOL * r.abs()).all()):
            fail(f"step-1 gradient of {n} differs from the plain-CIN run: "
                 f"max |err| {err.max().item()} (atol {atol})")
        worst = max(worst, err.max().item() / max(r.abs().max().item(), 1e-30))
    print(f"step-1 gradients of {len(grads)} parameters agree with the plain-CIN "
          f"run: max |err|/max|g| {worst:.3e}")
    if launches_by_path["training_parity"] != {"cin_fwd": 10, "cin_bwd": 10}:
        fail("expected 2 launches of each CIN kernel per train step")

    # (c) rates at B 4096, on this model at Criteo width
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
    print(f"training at B={BATCH} (Criteo width, vocab 100k): {wall * 1e3:.3f} ms a "
          f"step, {BATCH / wall:.1f} examples/s (median of 20, host clock, batch "
          f"from host); device time per step {step_ms:.4f} ms (CUDA events, batch "
          f"on the card, {BATCH / step_ms * 1e3:.1f} examples/s); peak memory "
          f"{peak:.1f} MiB")
    del model, step, init, grads, ref_grads

    # (b) learning through fit, with the reference's early-stopping recipe:
    # an eval each epoch, patience 2, the best epoch's weights restored
    fs, data = make_criteo_like(n_rows=262_144, vocab_size=LEARN_VOCAB, seed=0)
    tr, te = train_test_split(data, 0.2, seed=1)
    model = get_model("xdeepfm", fs, generator=torch.Generator().manual_seed(0))
    steps_per_epoch = -(-len(tr["label"]) // BATCH)
    t = time.perf_counter()
    ts, res = drive("training_fit", lambda: fit(
        model, tr, epochs=3, batch_size=BATCH, learning_rate=5e-3,
        eval_data=te, seed=0, eval_every=steps_per_epoch, patience=2))
    fit_s = time.perf_counter() - t
    auc = res.eval_metrics["auc"]
    evals = len(res.history.records) + 1       # each epoch's, and the last
    eval_batches = evals * -(-len(te["label"]) // BATCH)
    got = launches_by_path["training_fit"]
    print(f"fit: {res.steps} steps of B={BATCH} in {fit_s:.1f} s, "
          f"{res.examples_per_sec:.1f} examples/s (fit's timer); held-out AUC by "
          f"epoch {res.history.series('auc')}, best at step {res.best_step}; "
          f"train {res.train_metrics}; launches {got}")
    print(f"held-out AUC {auc:.4f}")
    if not auc > 0.65:
        fail(f"held-out AUC {auc} is not above 0.65")
    if got != {"cin_fwd": 2 * (res.steps + eval_batches), "cin_bwd": 2 * res.steps}:
        fail(f"fit launched {got}; expected 2 of each kernel per train step "
             f"and 2 cin_fwd per eval batch ({res.steps} steps, {eval_batches} "
             f"eval batches)")


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.ops import interactions
    from ml_function_tpu_torch.ops.kernels import _build
    from ml_function_tpu_torch.ops.kernels import cin as cin_mod
    from ml_function_tpu_torch.serving import export_model, load_scorer
    from ml_function_tpu_torch.tools.timing import event_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    kernels = [check_cin_kernel(cin_mod), check_cin_bwd_kernel(cin_mod)]
    counters = [(cin_mod, "cin_fwd_launches", "cin_fwd"),
                (cin_mod, "cin_bwd_launches", "cin_bwd")]
    launches_by_path = {}

    def drive(path, fn):
        """Run one main path with every count at 0; returns its launches."""
        for mod, attr, _ in counters:
            setattr(mod, attr, 0)
        out = fn()
        launches_by_path[path] = {name: getattr(mod, attr)
                                  for mod, attr, name in counters}
        return out

    # 4. serving
    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    hp = {"cin_hidden": [128, 128], "hidden": [256, 128]}
    model = get_model("xdeepfm", fs, device="cuda",
                      generator=torch.Generator().manual_seed(0),
                      **{k: tuple(v) for k, v in hp.items()})
    n_rows = 3 * BATCH + 1000
    _, data = make_criteo_like(n_rows=n_rows, vocab_size=100_000, seed=0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        export_model(tmp, "xdeepfm", fs, model, hyperparams=hp)
        del model
        scorer = load_scorer(tmp, batch_size=BATCH)
    if next(scorer.model.parameters()).device.type != "cuda":
        fail("load_scorer did not place the model on the card by default")

    scores = drive("serving", lambda: scorer.predict_proba(data))
    launches = launches_by_path["serving"]
    n_batches = -(-n_rows // BATCH)
    print(f"serving: {n_rows} rows in {n_batches} batches of {BATCH}, "
          f"launches {launches}")
    if scores.shape != (n_rows,) or not np.isfinite(scores).all():
        fail(f"scores not finite or of shape {scores.shape}")
    if not ((scores > 0) & (scores < 1)).all():
        fail("scores outside (0, 1)")
    if launches != {"cin_fwd": 2 * n_batches, "cin_bwd": 0}:
        fail(f"serving launched {launches}, expected cin_fwd {2 * n_batches}")

    # the same model with its CIN forced through the plain version (a hook
    # of this script, not an option of the package)
    interactions.cin_layer_t = cin_mod.cin_layer_t_reference
    try:
        ref_scores = scorer.predict_proba(data)
    finally:
        interactions.cin_layer_t = cin_mod.cin_layer_t
    diff = float(np.abs(scores - ref_scores).max())
    print(f"serving vs plain CIN: max |score diff| {diff:.3e}")
    if diff > 1e-4:
        fail(f"scores differ from the plain-CIN model by {diff}")

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
    print(f"scoring at B={BATCH}: predict_proba {wall * 1e3:.3f} ms for "
          f"{3 * BATCH} rows, {3 * BATCH / wall:.1f} examples/s; one forward on "
          f"the card {fwd_ms:.4f} ms ({BATCH / fwd_ms * 1e3:.1f} examples/s); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # 5. training
    del scorer, batch
    train_phase(cin_mod, interactions, drive, launches_by_path)

    # 6. result lines: launches are those of the training fit, the newest
    # path; every path's own counts ride along
    for k in kernels:
        k["launches"] = launches_by_path["training_fit"][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in launches_by_path.items()}
    print(f"wall time of the run: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
