"""The CIN kernels' two instances of each direction timed against each other.

    python -m ml_function_tpu_torch.tools.cin_instances [--h 26,128,...]
        [--d 8] [--b 4096] [--f 26] [--o 128] [--out cin_instances.json]

At each H the tool launches those of ``cin_fwd`` and ``cin_fwd_wide`` (and
of ``cin_bwd`` and ``cin_bwd_wide``) that take the shape on the same
inputs, in the order block, wide, wide, block, each timed by CUDA events,
and prints the largest difference between the two instances' outputs
where both take it. Beside them, twice, the library yardstick of the
same layer at the kernels' bf16 inputs (``library_calls``: the forward's
GEMM and einsum, the backward's two GEMMs and einsum). The wrappers' own
choice (``forward_instance``, ``backward_instance``) is printed beside
them. Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.kernels import cin
from .timing import event_ms


def library_calls(xk, x0, w1, dy):
    """The library yardsticks of one CIN layer at the kernels' bf16 inputs:
    the forward's GEMM and einsum, the backward's two GEMMs and einsum."""
    d, b, h = xk.shape
    f, o = x0.shape[2], dy.shape[2]
    xk_b, w1_b, x0_b, dy_b = xk.bfloat16(), w1.bfloat16(), x0.bfloat16(), dy.bfloat16()
    du_b = (x0.unsqueeze(-1) * dy.unsqueeze(2)).reshape(d * b, f * o).bfloat16()

    def library_fwd():
        torch.einsum("dbfo,dbf->dbo", torch.matmul(xk_b, w1_b).view(d, b, f, o), x0_b)

    def library_bwd():
        torch.matmul(du_b, w1_b.t())
        torch.matmul(xk_b.view(d * b, h).t(), du_b)
        torch.einsum("dbh,hfo,dbo->dbf", xk_b, w1_b.view(h, f, o), dy_b)

    return library_fwd, library_bwd


def compare(d: int, b: int, h: int, f: int, o: int, gen) -> dict:
    """One shape: each direction's instances that take it timed in the
    order A B B A, and the library yardstick twice."""
    xk = torch.randn(d, b, h, device="cuda", generator=gen)
    x0 = torch.randn(d, b, f, device="cuda", generator=gen)
    w1 = torch.randn(h, f * o, device="cuda", generator=gen) / h ** 0.5
    dy = torch.randn(d, b, o, device="cuda", generator=gen)
    rec = {"D": d, "B": b, "H": h, "F": f, "O": o}
    fwd = {i: (lambda i=i: cin._launch_fwd(xk, x0, w1, instance=i))
           for i in ("cin_fwd", "cin_fwd_wide")}
    bwd = {i: (lambda i=i: cin.cin_layer_t_backward(xk, x0, w1, dy, instance=i))
           for i in ("cin_bwd", "cin_bwd_wide")}
    libraries = dict(zip(("fwd", "bwd"), library_calls(xk, x0, w1, dy)))
    for direction, fns, lib, choose in (("fwd", fwd, cin._lib_fwd(), cin.forward_instance),
                                        ("bwd", bwd, cin._lib_bwd(), cin.backward_instance)):
        names = [name for name in fns if cin._smem_fits(lib, name, h, f)]
        outs = [fns[name]() for name in names]
        pairs = [zip(a, outs[0]) if direction == "bwd" else [(a, outs[0])] for a in outs[1:]]
        diff = max(((p - q).abs().max().item() for ps in pairs for p, q in ps), default=None)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(event_ms(fns[name], reps=10, inner=3))
        library = [event_ms(libraries[direction], reps=10, inner=3) for _ in range(2)]
        rec[direction] = {"chosen": choose(h, f) if names else None, "max_abs_diff": diff,
                          **{f"{k}_ms": v for k, v in times.items()}, "library_ms": library}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", default="26,128,176,192,224,256,288,320,416")
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--b", type=int, default=4096)
    ap.add_argument("--f", type=int, default=26)
    ap.add_argument("--o", type=int, default=128)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = []
    for h in (int(v) for v in args.h.split(",")):
        rec = compare(args.d, args.b, h, args.f, args.o, gen)
        recs.append(rec)
        for direction in ("fwd", "bwd"):
            r = rec[direction]
            times = ", ".join(f"{k} {v}" for k, v in r.items() if k.endswith("_ms"))
            print(f"H {h} {direction} (D {args.d}, B {args.b}, F {args.f}, O {args.o}): "
                  f"{times}; max |diff| {r['max_abs_diff']}; the wrapper takes {r['chosen']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": torch.cuda.get_device_name(0), "shapes": recs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
