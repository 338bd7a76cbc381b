// The TF32 tensor-core rate of mma.sync m16n8k8, the product that
// csrc/flash_fwd.cu and csrc/flash_bwd_dkv.cu issue. Built and run by
// tools/mma_rates.py.
#include <cuda_runtime.h>
#include <stdint.h>

// Each warp issues iters × 4 independent chains of mma.sync into its
// accumulators; the sum is written only if it hits a value it never takes,
// so that nothing is optimised away.
__global__ void rate_mma(float* out, int iters) {
  float d[4][4] = {};
  uint32_t a[4] = {__float_as_uint(1.f), __float_as_uint(0.5f), __float_as_uint(0.25f), __float_as_uint(2.f)};
  uint32_t b[2] = {__float_as_uint(1e-3f), __float_as_uint(2e-3f)};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < 4; ++c) for (int e = 0; e < 4; ++e) s += d[c][e];
  if (s == 12345.f) out[threadIdx.x] = s;
}

extern "C" int ratemma(float* out, int blocks, int threads, int iters) {
  rate_mma<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
