"""Where the time of one xDeepFM scoring batch goes on the CUDA card.

    python -m ml_function_tpu_torch.tools.profile_scoring [--batch 4096]
        [--out profile_scoring.json]

Builds full-width xDeepFM (Criteo schema: 26 fields of 100k ids, dim 8,
CIN (128, 128), MLP (256, 128)) with seeded random weights on the card and
measures at one batch size:

- one forward on a batch already on the card: device time by CUDA events,
  and the wall time of ``Scorer.predict_proba`` over full batches;
- a ``torch.profiler`` trace of 20 forwards: device time by kernel name and
  the device's busy share of the window;
- the CIN kernel alone at each layer shape, three ways: events around each
  call (the wrapper's host time shows when it exceeds the device time),
  50 calls back to back between two events, and device time as the profiler
  records it.

Prints the card's name and power limit first; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .timing import event_ms


def _kernel_intervals(prof):
    """(name, start_us, end_us) of every kernel the trace saw on the card."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.start, evt.time_range.end))
    return out


def _profile(fn, n: int):
    """Device ms by kernel name per call, busy share and window per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals = _kernel_intervals(prof)
    by_name = defaultdict(float)
    for name, s, e in intervals:
        by_name[name] += (e - s) / 1e3 / n
    busy, hi = 0.0, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if hi is None or s > hi:
            busy += e - s
            hi = e
        elif e > hi:
            busy += e - hi
            hi = e
    return (dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            busy / 1e3 / n, wall * 1e3 / n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scoring: needs a CUDA device")

    from ..features.schema import criteo_feature_set
    from ..features.synthetic import make_criteo_like
    from ..models import get_model
    from ..ops.kernels import cin as cin_mod
    from ..serving import Scorer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    result = {"card": card, "torch": torch.__version__, "batch": args.batch}

    b = args.batch
    fs = criteo_feature_set([100_000] * 26, n_dense=13, embed_dim=8)
    model = get_model("xdeepfm", fs, device="cuda",
                      generator=torch.Generator().manual_seed(0),
                      cin_hidden=(128, 128), hidden=(256, 128))
    _, data = make_criteo_like(n_rows=3 * b, vocab_size=100_000, seed=0)
    batch = {k: torch.as_tensor(v[:b], device="cuda")
             for k, v in data.items() if k in ("dense", "sparse")}

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
    for name, ms in list(kernels.items())[:15]:
        print(f"  {ms:9.4f} ms  {name[:110]}")

    gen = torch.Generator(device="cuda").manual_seed(1)
    result["cin_layers"] = []
    for h in (26, 128):
        d, f, o = 8, 26, 128
        xk = torch.randn(d, b, h, device="cuda", generator=gen)
        x0 = torch.randn(d, b, f, device="cuda", generator=gen) * 0.05
        w1 = torch.randn(h, f * o, device="cuda", generator=gen) * 0.05
        call = lambda: cin_mod.cin_layer_t(xk, x0, w1)  # noqa: E731
        per_call = event_ms(call, inner=1)
        b2b = event_ms(call, reps=5, inner=50)
        prof_kernels, prof_busy, prof_window = _profile(call, 20)
        row = {"H": h, "per_call_ms": per_call, "back_to_back_ms": b2b,
               "profiled_device_ms": prof_busy, "profiled_window_ms": prof_window,
               "device_ms_by_kernel": prof_kernels}
        result["cin_layers"].append(row)
        print(f"cin_fwd H={h}: per call {per_call:.4f} ms, back to back "
              f"{b2b:.4f} ms, device (profiler) {prof_busy:.4f} ms of a "
              f"{prof_window:.4f} ms window: "
              + ", ".join(f"{k[:40]} {v:.4f}" for k, v in prof_kernels.items()))

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
