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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gru {

constexpr int WHP = 16;           // hidden units a row of a warp instance, padded
constexpr int WARPS = 4;          // warps a block of a warp instance
constexpr int WROWS = 2 * WARPS;  // batch rows a block: two a warp
constexpr int L2_AHEAD = 4;       // steps ahead whose inputs a warp moves to L2

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
