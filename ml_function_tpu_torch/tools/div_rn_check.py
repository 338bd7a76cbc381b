"""``fa::div_rn`` against the IEEE division on the card.

    python -m ml_function_tpu_torch.tools.div_rn_check [--log2-pairs 33] [--seed 1]

The field-attention forward's L-64 instance (``ops/kernels/csrc/
field_attn_fwd.cu``) divides each exponential e by its row's sum with
``fa::div_rn`` (``csrc/field_attn.cuh``): the quotient e · r from r =
``__frcp_rn(sum)``, its remainder by an FMA and one FMA more (Markstein's
correction), where the plain version divides. The kernel keeps the plain
version's bits only if the two agree on every (e, sum) it meets: e in
[2^-64, 1] or 0 (an exponential that is not below 2^-64, the kernel's
fallback taking the rest) and sum in [1, 64] (the largest exponential of a
row is 1, and a row has at most 64). The tool compiles a small file that
includes the header, draws 2^log2-pairs (e, sum) pairs in those ranges from
a counter hash (every exponent equally often, the mantissas uniform, and
the ranges' ends), and counts the pairs whose two quotients differ in any
bit. Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess

from ..ops.kernels import _build

_CODE = r"""
#include "field_attn.cuh"

namespace {

__device__ unsigned long long mismatches;

__device__ __forceinline__ unsigned int mix(unsigned long long x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  return static_cast<unsigned int>(x ^ (x >> 33));
}

// pair i: e with a biased exponent of 63 to 126 (2^-64 <= e < 1), or e = 1
// or 0; sum with one of 127 to 132 (1 <= sum < 64), or sum = 64
__global__ void check(unsigned long long n, unsigned long long seed) {
  unsigned long long bad = 0;
  for (unsigned long long i = blockIdx.x * 1ull * blockDim.x + threadIdx.x; i < n;
       i += 1ull * gridDim.x * blockDim.x) {
    const unsigned int r1 = mix(2 * i + seed), r2 = mix(2 * i + 1 + 7 * seed);
    float e = __uint_as_float(((63u + (r1 >> 26)) << 23) | (r1 & 0x7fffffu));
    float s = __uint_as_float(((127u + (r2 >> 29) % 6u) << 23) | (r2 & 0x7fffffu));
    if ((r1 & 0xffu) == 0) e = (r1 & 0x100u) ? 1.f : 0.f;
    if ((r2 & 0xffu) == 0) s = 64.f;
    const float want = e / s, got = fa::div_rn(e, s, __frcp_rn(s));
    bad += __float_as_uint(want) != __float_as_uint(got);
  }
  if (bad) atomicAdd(&mismatches, bad);
}

}  // namespace

extern "C" int div_rn_mismatches(unsigned long long n, unsigned long long seed,
                                 unsigned long long* out) {
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyToSymbol(mismatches, &zero, sizeof(zero));
  if (err != cudaSuccess) return static_cast<int>(err);
  check<<<132 * 8, 256>>>(n, seed);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, mismatches, sizeof(*out));
  return static_cast<int>(err);
}
"""


def mismatches(log2_pairs: int = 33, seed: int = 1) -> int:
    """Pairs of 2^log2_pairs whose ``fa::div_rn`` quotient differs from the
    IEEE division's in any bit."""
    header = (_build.CSRC / "field_attn.cuh").read_bytes()
    digest = hashlib.sha256(_CODE.encode() + header).hexdigest()[:12]
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD / f"div_rn_check-{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(_CODE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(so), str(cu)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).div_rn_mismatches
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_ulonglong(0)
    err = fn(1 << log2_pairs, seed, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"div_rn check failed with CUDA error {err}")
    return out.value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-pairs", type=int, default=33)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bad = mismatches(args.log2_pairs, args.seed)
    print(json.dumps({"pairs": 1 << args.log2_pairs, "seed": args.seed, "mismatches": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
