// Flash-attention backward, dQ, for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces ml_function_tpu/ops/kernels/flash_attention.py::_bwd_dq_kernel
// (the first pallas_call of _bwd_calls). For each (batch row b, head h) and
// query row i, recomputing the probabilities of the forward (flash_fwd.cu)
// from its lse, with delta_i = rowsum(dO_i * O_i):
//
//   p_j = exp(s_j - lse_i),   ds_j = p_j * (dO_i . v_j - delta_i),
//   dq_i = scale * sum_j ds_j k_j
//
// with the layouts of flash_fwd.cu, dO like q and delta like lse, all f32 on
// the CUDA cores, Dh <= 64.
//
// What bounds it on the H100: at SIM's flash-ESU shape (B 8, H 2,
// Lq = Lk = 16,384, Dh 8) it does 6 * B * H * Lq * Lk * Dh = 206 GFLOP
// (3.08 ms at the 67 TFLOP/s of f32) for some 42 MB in and out: arithmetic
// bounds it, with one exp a (query, key) pair besides.
//
// Design: the grid of the forward, one thread per query row of one (b, h),
// with its q and dO rows, its lse and delta and its dq accumulator in
// registers (Dh padded with zeros to 8, 16, 32 or 64 at compile time), while
// tiles of K, V and the bias stream through shared memory and every thread
// reads the same key at once. Each thread writes its own dq row once: no
// atomics, and the same inputs give the same bits.
//
// This kernel still runs its products on the CUDA cores. flash.cuh holds the
// split-TF32 tensor-core pieces that flash_fwd.cu and flash_bwd_dkv.cu are
// built from (fragments, the key permutation, staging of split tiles); dQ is
// the forward's grid with dS.K in place of P.V, so it can take them up as
// they are.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "flash.cuh"

namespace {

template <int DP>
__global__ void __launch_bounds__(flash::THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        const float* __restrict__ delta, float* __restrict__ dq, float scale,
                        bool causal, int nh, int lq, int lk, int dh) {
  constexpr int TK = flash::TILE_FLOATS / DP;   // rows of a staged tile
  __shared__ __align__(16) float ks[TK * DP];
  __shared__ __align__(16) float vs[TK * DP];
  __shared__ float bs[TK];
  const int bh = blockIdx.x, row = blockIdx.y * flash::THREADS + threadIdx.x;
  const bool live = row < lq;
  const size_t qrow = size_t(bh) * lq + row;
  const float* kb = k + size_t(bh) * lk * dh;
  const float* vb = v + size_t(bh) * lk * dh;
  const float* bb = bias + size_t(bh / nh) * lk;

  float qr[DP], dor[DP], acc[DP];
  flash::load_row<DP>(qr, q + qrow * dh, dh, live);
  flash::load_row<DP>(dor, dout + qrow * dh, dh, live);
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] = 0.f;
  const float lrow = live ? lse[qrow] : 0.f;
  const float drow = live ? delta[qrow] : 0.f;

  for (int t0 = 0; t0 < lk; t0 += TK) {
    const int n = min(TK, lk - t0);
    __syncthreads();  // every read of the last tile is done
    flash::stage<DP>(ks, kb + size_t(t0) * dh, n, dh);
    flash::stage<DP>(vs, vb + size_t(t0) * dh, n, dh);
    for (int j = threadIdx.x; j < n; j += flash::THREADS) bs[j] = bb[t0 + j];
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float* kr = ks + j * DP;
      const float s = flash::logit(flash::dot<DP>(qr, kr), scale, bs[j], row, t0 + j, causal);
      const float p = flash::fast_exp(s - lrow);
      const float ds = p * (flash::dot<DP>(dor, vs + j * DP) - drow);
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(ds, kr[c], acc[c]);
    }
  }
  if (live) {
    float* out = dq + qrow * dh;
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < dh) out[c] = acc[c] * scale;
  }
}

}  // namespace

extern "C" {

// q, dout (B, H, Lq, Dh), k and v (B, H, Lk, Dh), bias (B, Lk), lse and delta
// (B, H, Lq) f32 -> dq (B, H, Lq, Dh) f32, all contiguous on the current
// device; 1 <= Dh <= 64, Lq, Lk >= 1. Returns the CUDA error code of the launch
// (0 on success).
int flash_bwd_dq(const float* q, const float* k, const float* v, const float* bias,
                 const float* lse, const float* dout, const float* delta, float* dq, float scale,
                 int causal, int b, int h, int lq, int lk, int dh, void* stream) {
  const dim3 grid(b * h, (lq + flash::THREADS - 1) / flash::THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP)                                                                 \
  flash_bwd_dq_kernel<DP><<<grid, flash::THREADS, 0, st>>>(q, k, v, bias, lse, dout, delta, dq, \
                                                           scale, causal != 0, h, lq, lk, dh)
  FLASH_DISPATCH(dh, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
