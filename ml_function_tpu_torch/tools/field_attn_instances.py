"""The field-attention kernels' instances timed against each other, beside
SDPA, the plain versions and the bound.

    python -m ml_function_tpu_torch.tools.field_attn_instances
        [--shapes B,Lq,Lk,H,Dh[:masked] ...] [--out field_attn_instances.json]

At each shape every instance of each direction that takes it
(``field_attention.instance_fits``) runs on the same inputs: its largest
difference from the plain version, its time by CUDA events (the instances
in the order A B … B A, each twice) and its device time by
``torch.profiler``. Beside them: the plain versions' time,
``scaled_dot_product_attention`` in f32 with the bias as its mask (the
forward, and its forward plus backward through ``torch.autograd.grad``
less the forward) and the bound of ``bound_ms``. With ``:masked`` a random
30% of keys is masked (key 0 kept) and batch row 1 has every key masked.
The wrappers' own choice (``forward_instance``, ``backward_instance``) is
printed beside them. Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.kernels import field_attention as fa
from .timing import PEAK_BYTES, PEAK_F32_FLOPS, event_ms, profile_device

DEFAULT_SHAPES = ("4096,27,27,2,32", "512,64,64,2,64:masked", "1001,12,12,10,8:masked")
TIMING = dict(reps=10, inner=5)


def bound_ms(b: int, lq: int, lk: int, h: int, dh: int, backward: bool = False):
    """Least time of one field-attention call on the card: f32 products over
    the f32 CUDA-core rate against each input read and each output written
    once. Forward: 4·B·H·Lq·Lk·Dh flops; q, k, v, bias in, o out. Backward:
    10·B·H·Lq·Lk·Dh (the weights recomputed, dA, dV, dQ, dK); q, k, v, bias,
    dO in, dQ, dK, dV out. Returns (ms, "operations" or "bytes")."""
    n_q, n_k = b * lq * h * dh, b * lk * h * dh
    if backward:
        flops = 10 * b * h * lq * lk * dh
        nbytes = 4 * (2 * n_q + 2 * n_k + b * lk + n_q + 2 * n_k)
    else:
        flops = 4 * b * h * lq * lk * dh
        nbytes = 4 * (n_q + 2 * n_k + b * lk + n_q)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def inputs(gen, b, lq, lk, h, dh, masked):
    """q, k, v, bias, dO and the scale 1/√Dh; with ``masked`` a random key
    mask that keeps key 0, and batch row 1 with every key masked."""
    q, do = (torch.randn(b, lq, h, dh, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(b, lk, h, dh, device="cuda", generator=gen) for _ in range(2))
    bias = torch.zeros(b, lk, device="cuda")
    if masked:
        mask = torch.rand(b, lk, device="cuda", generator=gen) > 0.3
        mask[:, 0] = True
        mask[1] = False
        bias = torch.where(mask, 0.0, -1e9)
    return q, k, v, bias, do, 1.0 / dh ** 0.5


def device_ms(fn, n: int = 20) -> float:
    """Device ms a call of ``fn`` by ``torch.profiler``: the kernels it
    launches, summed."""
    by_name, _, _ = profile_device(fn, n)
    return sum(by_name.values())


def _turns(names):
    """A B … B A: each name twice, the second pass reversed."""
    return list(names) + list(reversed(names))


def compare(b, lq, lk, h, dh, masked, gen) -> dict:
    q, k, v, bias, do, scale = inputs(gen, b, lq, lk, h, dh, masked)
    kinds = [kind for kind in fa.INSTANCES if fa.instance_fits(kind, lq, lk, h, dh)]
    rec = {"B": b, "Lq": lq, "Lk": lk, "H": h, "Dh": dh, "masked": masked}
    ref_o = fa.field_attention_reference(q, k, v, bias, scale)
    ref_g = fa.field_attention_backward_reference(q, k, v, bias, do, scale)
    runs = {
        "fwd": ({fa._c_name("fwd", kind): (lambda kind=kind: fa.field_attention_forward(
            q, k, v, bias, scale, instance=fa._c_name("fwd", kind))) for kind in kinds},
            lambda out: (out - ref_o).abs().max().item(), fa.forward_instance,
            lambda: fa.field_attention_reference(q, k, v, bias, scale)),
        "bwd": ({fa._c_name("bwd", kind): (lambda kind=kind: fa.field_attention_backward(
            q, k, v, bias, do, scale, instance=fa._c_name("bwd", kind))) for kind in kinds},
            lambda out: max((g - r).abs().max().item() for g, r in zip(out, ref_g)),
            fa.backward_instance,
            lambda: fa.field_attention_backward_reference(q, k, v, bias, do, scale)),
    }
    for direction, (fns, err, choose, plain) in runs.items():
        out = {name: {"max_abs_err": err(fn())} for name, fn in fns.items()}
        times = {name: [] for name in fns}
        for name in _turns(fns):
            times[name].append(event_ms(fns[name], **TIMING))
        for name, fn in fns.items():
            out[name]["ms"] = times[name]
            out[name]["device_ms"] = device_ms(fn)
        bound, by = bound_ms(b, lq, lk, h, dh, backward=direction == "bwd")
        rec[direction] = {"chosen": choose(q, k, v, bias), "instances": out,
                          "plain_ms": event_ms(plain, **TIMING),
                          "bound_ms": bound, "bound_by": by}
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    mask4 = bias[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4, scale=scale)

    with torch.no_grad():
        rec["fwd"]["sdpa_ms"] = event_ms(sdpa, **TIMING)
    do_t = do.transpose(1, 2)
    both = event_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do_t), **TIMING)
    rec["bwd"]["sdpa_ms"] = both - rec["fwd"]["sdpa_ms"]
    return rec


def parse_shape(text: str):
    dims, _, flag = text.partition(":")
    b, lq, lk, h, dh = (int(x) for x in dims.split(","))
    return b, lq, lk, h, dh, flag == "masked"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("field_attn_instances: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = []
    for text in args.shapes:
        rec = compare(*parse_shape(text), gen)
        recs.append(rec)
        for direction in ("fwd", "bwd"):
            r = rec[direction]
            inst = "; ".join(
                f"{name} {x['ms']} ms by events, {x['device_ms']:.4f} on the device, "
                f"max |err| {x['max_abs_err']:.3e}" for name, x in r["instances"].items())
            print(f"{text} {direction}: {inst}; plain {r['plain_ms']:.4f} ms, SDPA f32 "
                  f"{r['sdpa_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
                  f"the wrapper takes {r['chosen']}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": torch.cuda.get_device_name(0), "shapes": recs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
