"""The CIN kernels' two instances of each direction timed against each other.

    python -m ml_function_tpu_torch.tools.cin_instances [--h 26,128,...]
        [--d 8] [--b 4096] [--f 26] [--o 128] [--out cin_instances.json]

At each H where both instances of a direction take the shape, the tool
launches ``cin_fwd`` and ``cin_fwd_wide`` (and ``cin_bwd`` and
``cin_bwd_wide``) on the same inputs, in the order block, wide, wide, block,
each timed by CUDA events, and prints the largest difference between the
two instances' outputs. The wrappers' own choice (``forward_instance``,
``backward_instance``) is printed beside them. Needs ``nvcc`` and a CUDA
device.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.kernels import cin
from .timing import event_ms


def compare(d: int, b: int, h: int, f: int, o: int, gen) -> dict:
    """One shape: each direction's instances timed in the order A B B A."""
    xk = torch.randn(d, b, h, device="cuda", generator=gen)
    x0 = torch.randn(d, b, f, device="cuda", generator=gen)
    w1 = torch.randn(h, f * o, device="cuda", generator=gen) / h ** 0.5
    dy = torch.randn(d, b, o, device="cuda", generator=gen)
    rec = {"D": d, "B": b, "H": h, "F": f, "O": o}
    fwd = {i: (lambda i=i: cin._launch_fwd(xk, x0, w1, instance=i))
           for i in ("cin_fwd", "cin_fwd_wide")}
    bwd = {i: (lambda i=i: cin.cin_layer_t_backward(xk, x0, w1, dy, instance=i))
           for i in ("cin_bwd", "cin_bwd_wide")}
    for direction, fns, lib, choose in (("fwd", fwd, cin._lib_fwd(), cin.forward_instance),
                                        ("bwd", bwd, cin._lib_bwd(), cin.backward_instance)):
        block, wide = fns
        if not (cin._smem_fits(lib, block, h, f) and cin._smem_fits(lib, wide, h, f)):
            rec[direction] = None
            continue
        a, c = fns[block](), fns[wide]()
        pairs = zip(a, c) if direction == "bwd" else [(a, c)]
        diff = max((p - q).abs().max().item() for p, q in pairs)
        times = {block: [], wide: []}
        for name in (block, wide, wide, block):
            times[name].append(event_ms(fns[name], reps=10, inner=3))
        rec[direction] = {"chosen": choose(h, f), "max_abs_diff": diff,
                          **{f"{k}_ms": v for k, v in times.items()}}
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
            if r is None:
                print(f"H {h} {direction}: one instance does not take the shape")
                continue
            times = ", ".join(f"{k} {v}" for k, v in r.items() if k.endswith("_ms"))
            print(f"H {h} {direction} (D {args.d}, B {args.b}, F {args.f}, O {args.o}): "
                  f"{times}; max |diff| {r['max_abs_diff']}; the wrapper takes {r['chosen']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": torch.cuda.get_device_name(0), "shapes": recs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
