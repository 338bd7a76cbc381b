#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi gives them; no CUDA
   device means an immediate non-zero exit;
2. build: every CUDA kernel of the port from ``ops/kernels/csrc`` (timed);
3. kernels against their plain PyTorch versions on the card, at the shapes
   the main path gives them, with kernel, plain, library and bound times;
4. the main path: full-width xDeepFM on the Criteo schema (26 fields of
   100k ids, dim 8, CIN (128, 128), MLP (256, 128)) with seeded random
   weights, exported and scored through ``load_scorer`` →
   ``Scorer.predict_proba`` on the card by default. The scores must be
   finite probabilities, every kernel of the path must have launched, and
   they must agree with the same model whose CIN runs the plain version;
5. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cin_bound(d: int, b: int, h: int, f: int, o: int):
    """Least time of one CIN layer on the card: bf16 products over the
    tensor-core rate against each input read and the output written once."""
    flops = 2 * d * b * h * f * o
    nbytes = 4 * (d * b * h + d * b * f + h * f * o + d * b * o)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def check_cin_kernel(cin_mod) -> dict:
    """cin_layer_t against cin_layer_t_reference at the two layer shapes of
    the main path (D 8, B 4096, F 26, O 128; H 26 then 128)."""
    from ml_function_tpu_torch.tools.timing import event_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for h in (26, 128):
        d, b, f, o = 8, BATCH, 26, 128
        xk = torch.randn(d, b, h, device="cuda", generator=gen)
        x0 = torch.randn(d, b, f, device="cuda", generator=gen) * 0.05
        w1 = torch.randn(h, f * o, device="cuda", generator=gen) * (2.0 / (h * f + o)) ** 0.5
        got = cin_mod.cin_layer_t(xk, x0, w1)
        torch.cuda.synchronize()
        ref = cin_mod.cin_layer_t_reference(xk, x0, w1)
        err = (got - ref).abs()
        atol = RTOL * ref.abs().max().item()
        if not bool((err <= atol + RTOL * ref.abs()).all()):
            fail(f"cin_fwd disagrees with its plain version at H={h}: "
                 f"max |err| {err.max().item()} (atol {atol})")
        xk_b, w1_b, x0_b = xk.bfloat16(), w1.bfloat16(), x0.bfloat16()
        bound_ms, bound_by = cin_bound(d, b, h, f, o)
        shapes.append({
            "shape": {"D": d, "B": b, "H": h, "F": f, "O": o},
            "max_abs_err": err.max().item(), "atol": atol,
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
    # One scoring batch calls the kernel once at each shape: the entry
    # reports that pair, the per-shape numbers ride along.
    return {
        "name": "cin_fwd", "route": "cuda",
        "source": "ml_function_tpu_torch/ops/kernels/csrc/cin_fwd.cu",
        "replaces": "ml_function_tpu/ops/kernels/cin.py:49",
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": sum(s["ms"] for s in shapes),
        "kernel_ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": sum(s["bound_ms"] for s in shapes),
        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": sum(s["library_ms"] for s in shapes),
        "library_calls": "torch.matmul (bf16) + torch.einsum F-reduce, per shape",
        "per_shape": shapes,
    }


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

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'cached'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    kernels = [check_cin_kernel(cin_mod)]
    counters = [(cin_mod, "cin_fwd_launches", "cin_fwd")]

    # 4. the main path
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

    for mod, attr, _ in counters:
        setattr(mod, attr, 0)
    scores = scorer.predict_proba(data)
    launches = {name: getattr(mod, attr) for mod, attr, name in counters}
    n_batches = -(-n_rows // BATCH)
    print(f"main path: {n_rows} rows in {n_batches} batches of {BATCH}, "
          f"launches {launches}")
    if scores.shape != (n_rows,) or not np.isfinite(scores).all():
        fail(f"scores not finite or of shape {scores.shape}")
    if not ((scores > 0) & (scores < 1)).all():
        fail("scores outside (0, 1)")
    if launches["cin_fwd"] != 2 * n_batches:
        fail(f"cin_fwd launched {launches['cin_fwd']} times, "
             f"expected {2 * n_batches}")
    kernels[0]["launches"] = launches["cin_fwd"]

    # the same model with its CIN forced through the plain version (a hook
    # of this script, not an option of the package)
    interactions.cin_layer_t = cin_mod.cin_layer_t_reference
    try:
        ref_scores = scorer.predict_proba(data)
    finally:
        interactions.cin_layer_t = cin_mod.cin_layer_t
    diff = float(np.abs(scores - ref_scores).max())
    print(f"main path vs plain CIN: max |score diff| {diff:.3e}")
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

    # 5. result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
