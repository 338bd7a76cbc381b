"""The CIN forward kernel against f64 on the CUDA card: its largest error and
its shrink toward zero at xDeepFM's two layers.

    python3 -m ml_function_tpu_torch.tools.cin_numerics
    PYTHONPATH=<another checkout> python3 ml_function_tpu_torch/tools/cin_numerics.py

The second form measures the kernel of the checkout on ``PYTHONPATH`` (it
imports nothing but torch and that checkout's ``ops.kernels.cin``), so two
versions of the kernel can be read on one card in one call. The truth is
y64 = Σ_f x0 · (bf16(xk) @ bf16(w1)) in f64, from the same bf16 operands the
kernel reads; the kernel's tensor cores sum in f32 and truncate where f32
rounds to nearest, so an error with the sign of y would pull every output
toward zero. The shrink is mean((y − y64) · sign(y64)) / mean|y64|; the
plain version (``cin_layer_t_reference``, f32 on the CUDA cores with TF32
off) is read beside it. Prints the card's name and power limit, one line a
shape, and one JSON object last.
"""

from __future__ import annotations

import json
import subprocess

import torch

# xDeepFM's two CIN layers at B 4096: (D, B, H, F, O)
SHAPES = ((8, 4096, 26, 26, 128), (8, 4096, 128, 26, 128))


def shrink(got: torch.Tensor, want: torch.Tensor) -> float:
    return (((got.double() - want) * want.sign()).mean() / want.abs().mean()).item()


def measure(cin, shape, seed: int = 0) -> dict:
    d, b, h, f, o = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xk = torch.randn(d, b, h, device="cuda", generator=gen)
    x0 = torch.randn(d, b, f, device="cuda", generator=gen)
    w1 = torch.randn(h, f * o, device="cuda", generator=gen) * (2.0 / (h * f + o)) ** 0.5
    y = cin.cin_layer_t(xk, x0, w1)
    plain = cin.cin_layer_t_reference(xk, x0, w1)
    u64 = torch.matmul(xk.bfloat16().double(), w1.bfloat16().double()).view(d, b, f, o)
    y64 = (u64 * x0.double().unsqueeze(-1)).sum(dim=2)
    torch.cuda.synchronize()
    scale = y64.abs().max().item()
    return {"shape": dict(zip("DBHFO", shape)),
            "max_err": (y.double() - y64).abs().max().item() / scale,
            "shrink": shrink(y, y64),
            "plain_max_err": (plain.double() - y64).abs().max().item() / scale,
            "plain_shrink": shrink(plain, y64)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("cin_numerics: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ml_function_tpu_torch.ops.kernels import cin

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    print(f"kernel from {cin.__file__}")
    rows = [measure(cin, s) for s in SHAPES]
    for r in rows:
        print(f"{r['shape']}: kernel max err {r['max_err']:.3e} of max|y64|, shrink "
              f"{r['shrink']:.3e}; plain {r['plain_max_err']:.3e}, {r['plain_shrink']:.3e}")
    print(json.dumps({"cin_numerics": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
