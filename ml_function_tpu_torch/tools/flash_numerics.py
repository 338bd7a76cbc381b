"""How close the flash-attention kernels come to exact, and what their fast
exponential costs, on the CUDA card.

    python -m ml_function_tpu_torch.tools.flash_numerics [--out flash_numerics.json]

At SIM's flash-ESU shape (B 8, H 2, Lq = Lk = 16,384, Dh 8, every key
valid; q, k, v and dO standard normal from a seed) it holds the forward,
dQ and dK/dV kernels against their plain versions computed in f64, beside
the plain versions in f32, for two builds of the kernels: the sources as
they are (the card's fast exponential, ``ex2.approx``) and the same sources
built with ``FLASH_ACCURATE_EXP`` defined, whose exponential is ``expf``
(the accurate one), into ``build/accurate_exp``; it fails if the second
build changes no bit of any output. Every backward takes the f64 forward's lse and δ, so each kernel is held
alone. For each it prints the largest error of o, dq, dk and dv over
max|f64| and of lse absolute, their shrink (the mean of the error times
the sign of the f64 value, over the mean |f64|: a rounding toward zero
shows there, where rounding to nearest averages out), and for each build
each kernel's time by CUDA events. Prints the card's name and power limit first; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import _build
from ..ops.kernels import flash_attention as fl
from .timing import event_ms

SHAPE = (8, 2, 16384, 8)   # B, H, Lq = Lk, Dh


@contextlib.contextmanager
def accurate_exp_build():
    """Inside the block the flash wrappers load the sources built with
    ``FLASH_ACCURATE_EXP`` defined, under ``build/accurate_exp``: the one
    macro of ``csrc/flash.cuh`` that turns every flash kernel's exponential
    into ``expf``."""
    saved = (_build.NVCC_FLAGS, _build.BUILD)
    _build.NVCC_FLAGS = saved[0] + ("-DFLASH_ACCURATE_EXP",)
    _build.BUILD = saved[1] / "accurate_exp"
    _build._loaded.clear()
    fl._lib.cache_clear()
    try:
        yield
    finally:
        _build.NVCC_FLAGS, _build.BUILD = saved
        _build._loaded.clear()
        fl._lib.cache_clear()


def _errors(got, exact) -> dict:
    """o, dq, dk, dv: max |err| over max |exact|; lse: max |err|."""
    out = {}
    for name, g, e in zip(("o", "lse", "dq", "dk", "dv"), got, exact):
        err = (g.double() - e).abs().max().item()
        out[name] = err if name == "lse" else err / e.abs().max().item()
    return out


def _shrink(got, exact) -> dict:
    """o, dq, dk, dv: mean(err · sign(exact)) over mean |exact|."""
    return {name: ((g.double() - e) * e.sign()).mean().item() / e.abs().mean().item()
            for name, g, e in zip(("o", "lse", "dq", "dk", "dv"), got, exact)
            if name != "lse"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_numerics: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)

    b, h, l, dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, do = (torch.randn(b, h, l, dh, device="cuda", generator=gen)
                   for _ in range(4))
    bias = torch.zeros(b, l, device="cuda")
    scale = dh ** -0.5
    o64, lse64 = fl.flash_attention_reference(q.double(), k.double(), v.double(),
                                              bias.double(), scale)
    delta64 = (do.double() * o64).sum(dim=-1)
    exact = (o64, lse64, *fl.flash_attention_backward_reference(
        q.double(), k.double(), v.double(), bias.double(), lse64, do.double(),
        delta64, scale))
    fwd_args = (q, k, v, bias, scale)
    bwd_args = (q, k, v, bias, lse64.float(), do, delta64.float(), scale)
    plain = (*fl.flash_attention_reference(*fwd_args),
             *fl.flash_attention_backward_reference(*bwd_args))
    result = {"card": card, "shape": dict(zip(("B", "H", "L", "Dh"), SHAPE)),
              "plain_f32": _errors(plain, exact), "plain_f32_shrink": _shrink(plain, exact)}
    del plain
    print(f"plain versions in f32 against f64: {json.dumps(result['plain_f32'])}; "
          f"shrink {json.dumps(result['plain_f32_shrink'])}")
    del o64
    for label, build in (("fast_exp", contextlib.nullcontext),
                         ("accurate_exp", accurate_exp_build)):
        with build():
            got = (*fl.flash_attention_forward(*fwd_args),
                   fl.flash_attention_backward_dq(*bwd_args),
                   *fl.flash_attention_backward_dkv(*bwd_args))
            ms = {"fwd": event_ms(lambda: fl.flash_attention_forward(*fwd_args),
                                  reps=10, inner=3),
                  "dq": event_ms(lambda: fl.flash_attention_backward_dq(*bwd_args),
                                 reps=10, inner=3),
                  "dkv": event_ms(lambda: fl.flash_attention_backward_dkv(*bwd_args),
                                  reps=10, inner=3)}
        if label == "accurate_exp" and all(
                torch.equal(a, b) for a, b in zip(got, result["fast_exp"]["got"])):
            raise SystemExit("flash_numerics: the FLASH_ACCURATE_EXP build changed "
                             "no bit of any output")
        result[label] = {"errors": _errors(got, exact), "shrink": _shrink(got, exact),
                         "ms": ms, "got": got}
        print(f"kernels, {label}: against f64 {json.dumps(result[label]['errors'])}; "
              f"shrink {json.dumps(result[label]['shrink'])}; ms {json.dumps(ms)}")

    for label in ("fast_exp", "accurate_exp"):
        del result[label]["got"]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
