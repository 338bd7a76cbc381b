"""Where the time of one scoring batch, or train step, of xDeepFM, AutoInt,
DIEN or SIM goes on the CUDA card.

    python -m ml_function_tpu_torch.tools.profile_scoring [--model xdeepfm]
        [--batch 4096] [--train] [--shape production|flash]
        [--out profile_scoring.json]

Builds a full-width model with seeded random weights on the card. On the
Criteo schema (26 fields of 100k ids, dim 8): xDeepFM with CIN (128, 128)
and MLP (256, 128), or AutoInt with 2 layers of 2 heads of 16 on its
field-attention kernel (the tool sets ``ML_FUNCTION_TPU_FIELD_ATTN=1``).
On behavior sequences (5,000 items, 100 categories, histories of 64, dim
8): DIEN with MLP (200, 80) on its kernel route, ``kernel = 'pallas'`` on
``gru1`` and ``gru2`` and the merge-scatter embedding gradient on (the
tool sets the module attribute the flag ``ML_FUNCTION_TPU_MERGE_SCATTER``
is read into at import). SIM on the JAX bench's behavior batch
(``sim_batch``: the same items and histories, a 16,384-id ``hist_long``)
with MLP (200, 80), its DIEN core on the same kernel route, at one of the
JAX board's two shapes (``--shape``): 'production', soft search keeping
the top 256 keys at B 512, or 'flash', hard search handing the whole
raw stream (all 16,384 ids valid, as the bench draws it) to the
flash-attention ESU at B 8; ``--batch`` is then that shape's unless given.
It measures at one batch size:

- one forward on a batch already on the card: device time by CUDA events,
  and the wall time of ``Scorer.predict_proba`` over full batches;
- a ``torch.profiler`` trace of 20 forwards: device time by kernel name and
  the device's busy share of the window;
- the model's kernel alone at each shape its forward gives it (the CIN at
  each layer, field attention at (B, 27, 27, 2, 16), the (AU)GRU at
  (B, 64, 16) with attention gates and with ones, SIM's flash attention at
  (B, 2, 16,384, 16,384, 8)), three ways: events
  around each call (the wrapper's host time shows when it exceeds the
  device time), 50 calls back to back between two events, and device time
  as the profiler records it.

With ``--train`` the same model takes Adam train steps instead (forward,
``backward()``, update) on a batch already on the card: device time by CUDA
events over steps issued back to back, a trace of 20 steps (device time by
kernel, busy share), and the backward kernel alone at each shape, its
launches by name (for DIEN also the merge-scatter gradient of each
sequence lookup, N = 64·B ids; for SIM the short histories' only, and
the flash-attention dQ and dK/dV kernels), and for SIM the share of the
flash-attention kernels in the step's busy time.

Prints the card's name and power limit first; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from pathlib import Path

import torch

from .timing import event_ms, profile_device as _profile

SIM_LONG = 16384
# SIM at the JAX board's two shapes (bench.py:756-769): (batch,
# hyperparameters)
SIM_SHAPES = {
    "production": (512, {"search": "soft", "top_k": 256, "long_behavior": ("hist_long",)}),
    "flash": (8, {"search": "hard", "long_behavior": ("hist_long",)}),
}


def sim_batch(n_rows: int, seed: int = 1):
    """The JAX bench's behavior batch (``bench.py:146-186``: item and cate
    candidates of 5,000 items and 100 categories, histories of 64 and a
    16,384-id ``hist_long`` of random ids, every one valid, dim 8, labels
    Bernoulli 0.4) drawn with numpy. Returns (FeatureSet, data)."""
    import numpy as np

    from ..features.schema import FeatureSet, SeqSpec, SparseSpec

    iv, cv, seq_len = 5001, 101, 64
    fs = FeatureSet(
        sparse=(SparseSpec("item", iv, vocab_name="item", dim=8),
                SparseSpec("cate", cv, vocab_name="cate", dim=8)),
        seq=(SeqSpec("hist_item", iv, seq_len, vocab_name="item", dim=8),
             SeqSpec("hist_cate", cv, seq_len, vocab_name="cate", dim=8),
             SeqSpec("hist_long", iv, SIM_LONG, vocab_name="item", dim=8)))
    rng = np.random.default_rng(seed)
    long = rng.integers(1, iv, (n_rows, SIM_LONG), dtype=np.int32)
    data = {"dense": np.zeros((n_rows, 0), np.float32),
            "sparse": np.stack([rng.integers(1, iv, n_rows), rng.integers(1, cv, n_rows)],
                               axis=1).astype(np.int32),
            "seq": {"hist_item": rng.integers(1, iv, (n_rows, seq_len), dtype=np.int32),
                    "hist_cate": rng.integers(1, cv, (n_rows, seq_len), dtype=np.int32),
                    "hist_long": long},
            "label": (rng.random(n_rows) < 0.4).astype(np.float32)}
    return fs, data


def _print_kernels(kernels, top: int = 15):
    for name, ms in list(kernels.items())[:top]:
        print(f"  {ms:9.4f} ms  {name[:110]}")


def _score(model, batch, data, result):
    from ..serving import Scorer

    b = result["batch"]
    batch = {k: v for k, v in batch.items() if k in ("dense", "sparse", "seq")}
    with torch.inference_mode():
        fwd = lambda: model(batch)  # noqa: E731
        result["forward_ms_events"] = event_ms(fwd)
        kernels, busy_ms, window_ms = _profile(fwd, 20)
    scorer = Scorer(model, batch_size=b)
    scorer.predict_proba(data)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.predict_proba(data)
        walls.append(time.perf_counter() - t0)
    result["predict_proba_ms_per_batch"] = statistics.median(walls) * 1e3 / 3
    result["forward_profile"] = {"window_ms": window_ms, "busy_ms": busy_ms,
                                 "busy_share": busy_ms / window_ms,
                                 "device_ms_by_kernel": kernels}
    print(f"B={b}: forward {result['forward_ms_events']:.4f} ms (events); "
          f"predict_proba {result['predict_proba_ms_per_batch']:.4f} ms/batch; "
          f"profiled window {window_ms:.4f} ms/forward, device busy "
          f"{busy_ms:.4f} ms ({100 * busy_ms / window_ms:.1f}%)")
    _print_kernels(kernels)

    result["kernel_alone"] = []
    for label, call in _kernel_calls(result, b, train=False, batch=batch,
                                     fs=model.feature_set):
        per_call = event_ms(call, inner=1)
        b2b = event_ms(call, reps=5, inner=50)
        prof_kernels, prof_busy, prof_window = _profile(call, 20)
        result["kernel_alone"].append({
            "call": label, "per_call_ms": per_call, "back_to_back_ms": b2b,
            "profiled_device_ms": prof_busy, "profiled_window_ms": prof_window,
            "device_ms_by_kernel": prof_kernels})
        print(f"{label}: per call {per_call:.4f} ms, back to back "
              f"{b2b:.4f} ms, device (profiler) {prof_busy:.4f} ms of a "
              f"{prof_window:.4f} ms window: "
              + ", ".join(f"{k[:40]} {v:.4f}" for k, v in prof_kernels.items()))


def _kernel_calls(result, b: int, train: bool, batch=None, fs=None):
    """(label, call) of the model's kernel alone at each shape its forward
    gives it: the CIN layer (or its backward) at H 26 and H 128, field
    attention (or its backward) at AutoInt's (B, 27, 27, 2, 16), or DIEN's
    (AU)GRU recurrence (or its backward, and the merge-scatter gradient of
    each sequence lookup of ``batch``); for SIM the DIEN core's on the short
    histories and, at the flash shape, flash attention (or its dQ and dK/dV
    kernels) at (B, 2, 16,384, 16,384, 8) with the batch's key mask."""
    model_name = result["model"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls = []
    if model_name == "sim":
        short = {k: v for k, v in batch["seq"].items() if k != "hist_long"}
        calls = _dien_kernel_calls(gen, b, train, {"seq": short}, fs)
        if result.get("shape") == "flash":
            calls += _flash_kernel_calls(gen, b, train, batch["seq"]["hist_long"] != 0)
        return calls
    if model_name == "dien":
        return _dien_kernel_calls(gen, b, train, batch, fs)
    if model_name == "xdeepfm":
        from ..ops.kernels import cin
        for h in (26, 128):
            d, f, o = 8, 26, 128
            xk = torch.randn(d, b, h, device="cuda", generator=gen)
            x0 = torch.randn(d, b, f, device="cuda", generator=gen) * 0.05
            w1 = torch.randn(h, f * o, device="cuda", generator=gen) * 0.05
            if train:
                dy = torch.randn(d, b, o, device="cuda", generator=gen)
                calls.append((f"cin_bwd H={h}", lambda xk=xk, x0=x0, w1=w1, dy=dy:
                              cin.cin_layer_t_backward(xk, x0, w1, dy)))
            else:
                calls.append((f"cin_fwd H={h}", lambda xk=xk, x0=x0, w1=w1:
                              cin.cin_layer_t(xk, x0, w1)))
        return calls
    from ..ops.kernels import field_attention as fa
    q, k, v, do = (torch.randn(b, 27, 2, 16, device="cuda", generator=gen)
                   for _ in range(4))
    bias = torch.zeros(b, 27, device="cuda")
    if train:
        return [("field_attn_bwd (B, 27, 27, 2, 16)",
                 lambda: fa.field_attention_backward(q, k, v, bias, do, 0.25))]
    return [("field_attn_fwd (B, 27, 27, 2, 16)",
             lambda: fa.field_attention(q, k, v, bias, 0.25))]


def _dien_kernel_calls(gen, b: int, train: bool, batch, fs):
    from ..ops.kernels import embedding_grad as eg
    from ..ops.kernels import gru

    seq = batch["seq"]
    l, h = seq["hist_item"].shape[1], 16
    mask = (seq["hist_item"] != 0).float()
    xw = torch.randn(b, l, 3 * h, device="cuda", generator=gen) * 0.5
    wh = torch.randn(h, 3 * h, device="cuda", generator=gen) / h ** 0.5
    att = torch.rand(b, l, device="cuda", generator=gen)
    h0 = torch.zeros(b, h, device="cuda")
    calls = []
    for gate, a in (("att", att), ("ones", torch.ones_like(att))):
        if not train:
            calls.append((f"gru_fwd (B, {l}, {h}) {gate}",
                          lambda a=a: gru.gru_sequence(xw, wh, mask, a, h0)))
            continue
        out = gru.gru_sequence(xw, wh, mask, a, h0)
        dseq = torch.randn_like(out)
        calls.append((f"gru_bwd (B, {l}, {h}) {gate}",
                      lambda a=a, out=out, dseq=dseq: gru.gru_sequence_backward(
                          xw, wh, mask, a, h0, out, dseq)))
    if train:
        for name, ids in seq.items():   # global row ids, as a lookup flattens them
            flat = ids.reshape(-1).long() + fs.seq_offset(name)
            ct = torch.randn(flat.numel(), 8, device="cuda", generator=gen)
            calls.append((f"merge_scatter {name} (N={flat.numel()}) with its sort",
                          lambda flat=flat, ct=ct: eg.dense_grad_from_updates(
                              flat, ct, fs.total_vocab)))
    return calls


def _flash_kernel_calls(gen, b: int, train: bool, mask):
    from ..ops.kernels import flash_attention as fl

    lk, dh = mask.shape[1], 8
    q, k, v, do = (torch.randn(b, 2, lk, dh, device="cuda", generator=gen)
                   for _ in range(4))
    bias = torch.where(mask, 0.0, fl.NEG_INF)
    scale = dh ** -0.5
    where = f"(B={b}, H=2, L={lk}, Dh={dh})"
    if not train:
        return [(f"flash_fwd {where}",
                 lambda: fl.flash_attention_forward(q, k, v, bias, scale))]
    o, lse = fl.flash_attention_forward(q, k, v, bias, scale)
    args = (q, k, v, bias, lse, do, (do * o).sum(dim=-1), scale)
    return [(f"flash_bwd_dq {where}", lambda: fl.flash_attention_backward_dq(*args)),
            (f"flash_bwd_dkv {where}", lambda: fl.flash_attention_backward_dkv(*args))]


def _train(model, batch, result):
    from ..train.loop import make_train_step
    from ..train.optimizers import make_optimizer

    b = result["batch"]
    step = make_train_step(model, make_optimizer("adam", 1e-3).init(model))
    fn = lambda: step(batch)  # noqa: E731
    result["train_step_ms_events"] = event_ms(fn, reps=10, inner=5)
    kernels, busy_ms, window_ms = _profile(fn, 20)
    result["train_profile"] = {"window_ms": window_ms, "busy_ms": busy_ms,
                               "busy_share": busy_ms / window_ms,
                               "device_ms_by_kernel": kernels}
    print(f"B={b}: train step {result['train_step_ms_events']:.4f} ms (events, "
          f"back to back); profiled window {window_ms:.4f} ms/step, device busy "
          f"{busy_ms:.4f} ms ({100 * busy_ms / window_ms:.1f}%)")
    _print_kernels(kernels, 25)
    if result["model"] == "sim":
        flash_ms = sum(ms for name, ms in kernels.items() if "flash_" in name)
        result["train_profile"]["flash_ms"] = flash_ms
        result["train_profile"]["flash_share_of_busy"] = flash_ms / busy_ms
        print(f"flash-attention kernels: {flash_ms:.4f} ms a step, "
              f"{100 * flash_ms / busy_ms:.1f}% of the busy time")

    result["kernel_alone"] = []
    for label, call in _kernel_calls(result, b, train=True, batch=batch,
                                     fs=model.feature_set):
        b2b = event_ms(call, reps=5, inner=50)
        prof_kernels, prof_busy, prof_window = _profile(call, 20)
        result["kernel_alone"].append({
            "call": label, "back_to_back_ms": b2b, "profiled_device_ms": prof_busy,
            "device_ms_by_kernel": prof_kernels})
        print(f"{label}: back to back {b2b:.4f} ms, device (profiler) "
              f"{prof_busy:.4f} ms: "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in prof_kernels.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("xdeepfm", "autoint", "dien", "sim"),
                    default="xdeepfm")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default 4096; SIM: its shape's)")
    ap.add_argument("--train", action="store_true",
                    help="profile Adam train steps instead of scoring")
    ap.add_argument("--shape", choices=tuple(SIM_SHAPES), default="production",
                    help="SIM's board shape")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scoring: needs a CUDA device")

    from ..features.schema import criteo_feature_set
    from ..features.synthetic import make_behavior_data, make_criteo_like
    from ..models import get_model
    from ..models.base import as_tensors
    from ..ops import embedding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    b = args.batch or (SIM_SHAPES[args.shape][0] if args.model == "sim" else 4096)
    result = {"card": card, "torch": torch.__version__, "model": args.model,
              "batch": b}
    hp = {}
    if args.model in ("dien", "sim"):
        if args.model == "sim":
            hp = dict(SIM_SHAPES[args.shape][1], hidden=(200, 80))
            result["shape"] = args.shape
            fs, data = sim_batch(3 * b)
        else:
            fs, data = make_behavior_data(n_rows=3 * b, n_items=5000, n_cates=100,
                                          seq_len=64, embed_dim=8, seed=0)
        # the merge-scatter flag is read at import: set what it was read into
        embedding._USE_MERGE_SCATTER = True
    else:
        fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
        _, data = make_criteo_like(n_rows=3 * b, vocab_size=100_000, seed=0)
    if args.model == "xdeepfm":
        hp = {"cin_hidden": (128, 128), "hidden": (256, 128)}
    elif args.model == "autoint":
        # AutoInt's attention takes the kernel only with the reference's switch
        os.environ["ML_FUNCTION_TPU_FIELD_ATTN"] = "1"
        hp = {"n_layers": 2, "num_heads": 2, "head_dim": 16}
    model = get_model(args.model, fs, device="cuda",
                      generator=torch.Generator().manual_seed(0), **hp)
    core = model.dien if args.model == "sim" else model
    if args.model in ("dien", "sim"):
        core.gru1.kernel = core.gru2.kernel = "pallas"
    batch = as_tensors({k: ({n: a[:b] for n, a in v.items()} if k == "seq" else v[:b])
                        for k, v in data.items()}, torch.device("cuda"))

    if args.train:
        _train(model, batch, result)
    else:
        _score(model, batch, data, result)

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
