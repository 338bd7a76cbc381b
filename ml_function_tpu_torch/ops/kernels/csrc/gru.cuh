// Pieces shared by the (AU)GRU kernels (gru_fwd.cu, gru_bwd.cu).
//
// Block instances (gru_fwd, gru_bwd): a block takes `rows` batch rows of H
// threads each; thread (r, j) = (threadIdx.x / H, threadIdx.x % H) owns
// hidden unit j of batch row blockIdx.x * rows + r and keeps that unit's h
// (or its cotangent) in a register for the whole loop over L. Each step the
// row's h, rounded to bf16, is published in shared memory so that the row's
// H threads can form their three columns of h.wh. xw (B, L, 3H), seq and dseq (B, L, H), mask
// and att (B, L) are read and written in place in their batch-major layout:
// the H threads of a row touch H contiguous floats of each gate block.
//
// Warp instances (gru_fwd_warp, gru_bwd_warp), for H <= WHP: the hidden units
// are padded to WHP and a warp takes two batch rows, a thread per (row, unit),
// so nothing in the step loop waits on another warp; a block is WARPS warps.
// Each step a warp publishes its rows' bf16 h in warp-private shared memory,
// double-buffered by the step's parity behind one __syncwarp, and every lane
// reads its row's values as 16-byte broadcasts. Padded units and rows past B
// load from a valid address, compute on zeros and store nothing.
//
// Wide instances (gru_fwd_wide, gru_bwd_wide), for H > 64: a block is G
// groups of TU threads (TU = H rounded up to 32, at most 256; G = 256 / TU,
// so 2 up to H 128 and 1 past it), and group g takes RG batch rows (8, or 1
// where 8 rows' state does not fit in shared memory, past H 3,600). Thread
// (g, j) owns hidden units j, j + TU, ... of its group's rows, so no H is
// refused for its width (the backward's dwh scratch, gru_bwd.cu, must still
// fit in device memory). Each step the block publishes its rows' bf16 h (and in the backward
// bf16 dhh) in shared memory as [unit][row], a group's RG rows of a unit in
// one 16-byte load, and a thread forms its units' products for its RG rows
// at once, each weight read once for RG rows. The bf16-rounded wh sits in
// shared memory where it fits (6 H^2 bytes: to H 194 in the forward, 191 in
// the backward) and is read from global memory (the L2), rounded as it is
// read, past that. The f32 h and the backward's carried dh stay in device
// memory, each read back by the thread that wrote it, its loads issued
// before the product that hides them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gru {

constexpr int WHP = 16;           // hidden units a row of a warp instance, padded
constexpr int WARPS = 4;          // warps a block of a warp instance
constexpr int WROWS = 2 * WARPS;  // batch rows a block: two a warp
constexpr int L2_AHEAD = 4;       // steps ahead whose inputs a warp moves to L2

// The wide instances' plan, which sets a block's rows from H (the wrappers
// pass no rows to the wide instances).
constexpr int WIDE_THREADS = 256;           // threads a block at most
constexpr int WIDE_RG = 8;                  // batch rows a group, where they fit
constexpr size_t SMEM_LIMIT = 232448;       // shared memory a block may use on the H100
constexpr size_t WIDE_RED_BYTES = 256;      // the backward's da sums: (warps, RG) floats

inline int wide_unit_threads(int h) {
  const int t = (h + 31) / 32 * 32;
  return t < WIDE_THREADS ? t : WIDE_THREADS;
}
inline int wide_groups(int h) {
  const int g = WIDE_THREADS / wide_unit_threads(h);
  return g > 1 ? g : 1;
}
// bf16 elements between rows of the shared wh: 3H rounded up to 2 mod 4, so
// that a warp reading one column of consecutive rows (wh . dhh) hits 32 banks.
inline int wide_ldw(int h) {
  int l = 3 * h;
  while (l % 4 != 2) ++l;
  return l;
}
inline size_t wide_wh_bytes(int h) { return (size_t(2) * h * wide_ldw(h) + 15) / 16 * 16; }
__device__ __forceinline__ size_t wide_wh_bytes_dev(int h, int ldw) {
  return (size_t(2) * h * ldw + 15) / 16 * 16;
}
// The shared state a block keeps besides wh: bf16 h ([H][rows]) twice in
// the forward; bf16 h_prev and dhh ([H][rows], [3H][rows]) of `slots` steps
// and the da sums in the backward.
inline size_t wide_fwd_state(int h, int rows) { return size_t(4) * h * rows; }
inline size_t wide_bwd_state(int h, int rows, int slots) {
  return size_t(8) * h * rows * slots + WIDE_RED_BYTES;
}
inline int wide_rg(int h) {
  return wide_bwd_state(h, wide_groups(h) * WIDE_RG, 1) <= SMEM_LIMIT ? WIDE_RG : 1;
}
// Steps whose bf16 h_prev and dhh the backward keeps for one update of its
// dwh partial: as many as fit beside wh_bytes, at most 8.
constexpr int WIDE_MAX_SLOTS = 8;
inline int wide_bwd_slots(int h, int rows, size_t wh_bytes) {
  int s = WIDE_MAX_SLOTS;
  while (s > 1 && wh_bytes + wide_bwd_state(h, rows, s) > SMEM_LIMIT) --s;
  return s;
}

// n bf16 values from shared memory as floats (n = 8: one 16-byte load).
template <int N>
__device__ __forceinline__ void load_bf16(float* out, const __nv_bfloat16* p) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int v = 0; v < N / 8; ++v) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[v];
      const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(q[i]);
        out[8 * v + 2 * i] = f.x;
        out[8 * v + 2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

// wh[k, c] rounded to bf16: from the shared copy (WS) or from device memory.
template <bool WS>
__device__ __forceinline__ float wide_w(const __nv_bfloat16* whs, const float* __restrict__ wh,
                                        int ldw, int h3, int k, int c) {
  if constexpr (WS) {
    return __bfloat162float(whs[k * ldw + c]);
  } else {
    return __bfloat162float(__float2bfloat16_rn(wh[k * h3 + c]));
  }
}

// wh (H, 3H) -> the shared bf16 copy, rows ldw apart.
__device__ __forceinline__ void stage_wh_bf16(__nv_bfloat16* whs, const float* __restrict__ wh,
                                              int h, int ldw) {
  const int h3 = 3 * h;
  for (int e = threadIdx.x; e < h * h3; e += blockDim.x) {
    const int k = e / h3, c = e - k * h3;
    whs[k * ldw + c] = __float2bfloat16_rn(wh[e]);
  }
}

// Round to the nearest bf16 (ties to even) and back: the reference's bf16
// cast of each operand of a recurrent product.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The gate arithmetic is written with explicit round-to-nearest operations,
// in the order the plain version's tensor operations take, so that nvcc
// contracts nothing into an FMA: the two versions then give the same h bit
// for bit, and no h of the recurrence rounds to another bf16 value in one
// than in the other.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// One forward step of one (row, unit): h' from h, the step's projections xu,
// xr, xn, its mask m and attention gate a, and the recurrent products hu, hr,
// hn. Both forward instances take it, so they give the same bits.
__device__ __forceinline__ float step(float hv, float xu, float xr, float xn, float m, float a,
                                      float hu, float hr, float hn) {
  const float u0 = sigmoid(add(xu, hu));
  const float rg = sigmoid(add(xr, hr));
  const float n = tanhf(add(xn, mul(rg, hn)));
  const float u = mul(a, u0);
  const float h_new = add(mul(sub(1.f, u), hv), mul(u, n));
  return add(mul(m, h_new), mul(sub(1.f, m), hv));
}

// wh (H, 3H) -> shared, rounded to bf16, rows padded to 3H + 1 floats: the
// forward reads one row across the row's threads (consecutive columns), the
// backward one column (stride 3H + 1, odd, so no two threads share a bank).
__device__ __forceinline__ void stage_wh(float* whs, const float* __restrict__ wh, int h) {
  const int h3 = 3 * h, ldw = h3 + 1;
  for (int e = threadIdx.x; e < h * h3; e += blockDim.x) {
    const int k = e / h3, c = e - k * h3;
    whs[k * ldw + c] = bf16r(wh[e]);
  }
}

// hh_u, hh_r, hh_n of hidden unit j: sum_k hb[k] * whs[k, {j, H + j, 2H + j}]
// with hb the row's bf16-rounded h in shared memory, summed over k in order.
// Products of two bf16 values are exact in f32, so each FMA rounds as a
// multiply and an add would, and the plain version, which sums in the same
// order, gives the same bits.
__device__ __forceinline__ void recurrent_product(const float* hb, const float* whs, int h,
                                                  int j, float& hu, float& hr, float& hn) {
  const int ldw = 3 * h + 1;
  hu = hr = hn = 0.f;
  for (int k = 0; k < h; ++k) {
    const float x = hb[k];
    const float* w = whs + k * ldw;
    hu = fmaf(x, w[j], hu);
    hr = fmaf(x, w[h + j], hr);
    hn = fmaf(x, w[2 * h + j], hn);
  }
}

}  // namespace gru
