// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Layouts: q, o, dO (B, H, Lq, Dh), k, v (B, H, Lk, Dh), all contiguous f32,
// so the rows of one (b, h) pair are Dh contiguous floats each; the key bias
// is (B, Lk) (0 for a valid key, NEG_INF for a masked one), shared by the H
// heads of a batch row; lse and delta are (B, H, Lq).
//
// One thread owns one row (a query row in the forward and dQ kernels, a key
// row in dK/dV) and keeps that row's operands and accumulators in registers,
// padded with zeros from Dh to DP, a compile-time width (8, 16, 32 or 64).
// The rows of the other side stream through shared memory in tiles of
// TILE_FLOATS / DP rows; every thread of a block reads the same tile row at
// the same time, so each shared-memory read is one broadcast.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int THREADS = 128;         // rows of one block
constexpr float NEG_INF = -1e9f;     // the reference's mask value
constexpr int TILE_FLOATS = 2048;    // floats of one staged tile (8 KB)

// dst[r * DP + c] = src[r * dh + c] for r < n, c < dh; zero for dh <= c < DP.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n, int dh) {
  for (int e = threadIdx.x; e < n * DP; e += THREADS) {
    const int r = e / DP, c = e - r * DP;
    dst[e] = c < dh ? src[size_t(r) * dh + c] : 0.f;
  }
}

// x[c] = src[c] for c < dh, zero up to DP (a thread's own row).
template <int DP>
__device__ __forceinline__ void load_row(float (&x)[DP], const float* __restrict__ src, int dh,
                                         bool live) {
#pragma unroll
  for (int c = 0; c < DP; ++c) x[c] = (live && c < dh) ? src[c] : 0.f;
}

// sum_c a[c] * b[c], in order of c (the padded zeros add nothing).
template <int DP>
__device__ __forceinline__ float dot(const float (&a)[DP], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// The logit of one (query, key) pair from its dot product: times the scale,
// then plus the bias, two roundings as the reference forms it (an FMA would
// round the -1e9 of a masked key differently); NEG_INF in its place for a
// key after its query under the causal mask (a runtime flag, so one
// instance serves both).
__device__ __forceinline__ float logit(float qk, float scale, float bias, int row, int col,
                                       bool causal) {
  if (causal && col > row) return NEG_INF;
  return __fadd_rn(__fmul_rn(qk, scale), bias);
}

// The width the kernels are instantiated at for a head dim dh <= 64.
inline int padded_dim(int dh) { return dh <= 8 ? 8 : dh <= 16 ? 16 : dh <= 32 ? 32 : 64; }

}  // namespace flash

// Launches LAUNCH(DP) at the padded width of dh.
#define FLASH_DISPATCH(dh, LAUNCH)           \
  switch (flash::padded_dim(dh)) {           \
    case 8: LAUNCH(8); break;                \
    case 16: LAUNCH(16); break;              \
    case 32: LAUNCH(32); break;              \
    default: LAUNCH(64); break;              \
  }
