"""The TF32 tensor-core rate the flash kernels can reach on the CUDA card.

    python -m ml_function_tpu_torch.tools.mma_rates [--out mma_rates.json]

Builds ``tools/mma_rates.cu`` with ``nvcc`` for ``sm_90a`` and times, by CUDA
events, long chains of ``mma.sync`` m16n8k8 TF32 products with f32
accumulation on every SM (what ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd_dkv.cu`` issue), at 1, 2 and 4 blocks of 4 warps an SM and
2 blocks of 8. Prints the card's name and power limit first; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import _build
from .timing import event_ms

SOURCE = Path(__file__).resolve().parent / "mma_rates.cu"
ITERS = 4096


def _load() -> ctypes.CDLL:
    out = _build.BUILD / "tools" / "libmma_rates.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.ratemma.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_rates: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    lib = _load()
    result = {"card": card, "tflops": {}}
    out = torch.zeros(1024, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for per_sm, threads in ((1, 128), (2, 128), (4, 128), (2, 256)):
        blocks = sms * per_sm

        def launch():
            if lib.ratemma(out.data_ptr(), blocks, threads, ITERS):
                raise SystemExit("mma_rates: the kernel failed to launch")

        ms = event_ms(launch, reps=5, inner=1, warmup=1)
        flops = 2 * 16 * 8 * 8 * 4 * ITERS * blocks * (threads // 32)
        key = f"{per_sm} blocks of {threads} an SM"
        result["tflops"][key] = flops / ms / 1e9
        print(f"{key}: mma.sync m16n8k8 {result['tflops'][key]:.1f} TFLOP/s")

    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
