// Block-level pieces shared by the field-attention kernels (field_attn_fwd.cu,
// field_attn_bwd.cu). One block of THREADS threads works on one (batch row b,
// head h): the rows of q, k, v, dO for that pair are the Dh contiguous floats
// at ((b * L + i) * H + h) * Dh, one row every H * Dh floats (the (B, L, H, Dh)
// layout of the projections, read in place with no transpose).
//
// The (Lq, Lk) matrices (scores, weights, their cotangents) live whole in
// shared memory: the gate Lq * Lk <= 4096 bounds each at 16 KB. Rows of q, k,
// v are staged in tiles of at most TILE rows, so Lk = 4096 keys (1 MB of K and
// V at Dh = 64) stream through a fixed amount of shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fa {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;  // rows of q, k, v or dO staged at a time

// Floats of shared memory for the staged row tiles; a tile row is Dh + 1
// floats, so threads reading one column of different rows hit distinct banks.
__host__ __device__ inline int tile_floats(int lq, int lk, int dh) {
  const int tq = lq < TILE ? lq : TILE, tk = lk < TILE ? lk : TILE;
  return (tq + tk) * (dh + 1);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[r * (dh + 1) + c] = src[r * stride + c] for r < n, c < dh.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int n,
                                           int dh, int stride) {
  for (int e = threadIdx.x; e < n * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    dst[r * (dh + 1) + c] = src[size_t(r) * stride + c];
  }
}

// out[i * ny + j] = sum_d x[i, d] * y[j, d] for i < nx, j < ny; with kScores,
// then times scale, then plus bias[j], two roundings as the reference forms
// the logits (an FMA here would round the -1e9 of a masked key differently).
// xs and ys are the tile buffers. Ends with the block synchronised.
template <bool kScores>
__device__ void gram(const float* __restrict__ x, int nx, const float* __restrict__ y, int ny,
                     int dh, int stride, float* xs, float* ys, float* out, float scale,
                     const float* __restrict__ bias) {
  const int dhp = dh + 1;
  for (int x0 = 0; x0 < nx; x0 += TILE) {
    const int mx = min(TILE, nx - x0);
    for (int y0 = 0; y0 < ny; y0 += TILE) {
      const int my = min(TILE, ny - y0);
      __syncthreads();  // every read of the tiles' last contents is done
      if (y0 == 0) stage_rows(xs, x + size_t(x0) * stride, mx, dh, stride);
      stage_rows(ys, y + size_t(y0) * stride, my, dh, stride);
      __syncthreads();
      for (int e = threadIdx.x; e < mx * my; e += THREADS) {
        const int i = e / my, j = e - i * my;
        const float* xr = xs + i * dhp;
        const float* yr = ys + j * dhp;
        float s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(xr[d], yr[d], s);
        if (kScores) s = __fadd_rn(__fmul_rn(s, scale), bias[y0 + j]);
        out[size_t(x0 + i) * ny + y0 + j] = s;
      }
    }
  }
  __syncthreads();
}

// Each row of p (nr rows of nc) becomes its softmax, max subtracted: one warp
// a row. Ends with the block synchronised.
__device__ void softmax_rows(float* p, int nr, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nr; r += WARPS) {
    float* row = p + size_t(r) * nc;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nc; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nc; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nc; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();
}

// out[r, d] = scale * sum_c M(r, c) * y[c, d] for r < nr, d < dh, where
// M(r, c) = m[r * ld + c], or m[c * ld + r] with kTrans. M is in shared
// memory; the rows of y are read from device memory (and L1), neighbouring
// threads on neighbouring d; out is written in the (B, L, H, Dh) layout.
template <bool kTrans>
__device__ void apply(const float* m, int ld, int nr, int nc, const float* __restrict__ y,
                      float* __restrict__ out, int dh, int stride, float scale) {
  for (int e = threadIdx.x; e < nr * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh;
    const float* yc = y + d;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const float w = kTrans ? m[size_t(c) * ld + r] : m[size_t(r) * ld + c];
      acc = fmaf(w, __ldg(yc + size_t(c) * stride), acc);
    }
    out[size_t(r) * stride + d] = acc * scale;
  }
}

}  // namespace fa
