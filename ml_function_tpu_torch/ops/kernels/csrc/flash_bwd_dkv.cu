// Flash-attention backward, dK and dV, for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces ml_function_tpu/ops/kernels/flash_attention.py::_bwd_dkv_kernel
// (the second pallas_call of _bwd_calls). For each (batch row b, head h) and
// key row j, recomputing the probabilities of the forward (flash_fwd.cu)
// from its lse, with delta_i = rowsum(dO_i * O_i):
//
//   p_i = exp(s_ij - lse_i),   dv_j = sum_i p_i dO_i,
//   ds_i = p_i * (dO_i . v_j - delta_i),   dk_j = scale * sum_i ds_i q_i
//
// with the layouts of flash_fwd.cu, all f32 on the CUDA cores, Dh <= 64.
//
// What bounds it on the H100: at SIM's flash-ESU shape (B 8, H 2,
// Lq = Lk = 16,384, Dh 8) it does 8 * B * H * Lq * Lk * Dh = 275 GFLOP
// (4.10 ms at the 67 TFLOP/s of f32) for some 50 MB in and out: arithmetic
// bounds it, with one exp a (query, key) pair besides.
//
// Design: the TPU kernel looped over query blocks with q, dO, lse and delta
// transposed so that Dh sat on its sublanes; here one block of 128 threads
// takes 128 key rows of one (b, h), each thread keeping its k and v rows,
// its key's bias and its dk and dv accumulators in registers (Dh padded with
// zeros to 8, 16, 32 or 64 at compile time), while tiles of q, dO, lse and
// delta stream through shared memory in their natural layouts and every
// thread reads the same query at once. Each thread writes its own dk and dv
// rows once: no atomics across blocks, and the same inputs give the same
// bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "flash.cuh"

namespace {

template <int DP>
__global__ void __launch_bounds__(flash::THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, float scale, bool causal, int nh, int lq, int lk,
                         int dh) {
  constexpr int TQ = flash::TILE_FLOATS / DP;   // rows of a staged tile
  __shared__ __align__(16) float qs[TQ * DP];
  __shared__ __align__(16) float dos[TQ * DP];
  __shared__ float ls[TQ];
  __shared__ float dls[TQ];
  const int bh = blockIdx.x, col = blockIdx.y * flash::THREADS + threadIdx.x;
  const bool live = col < lk;
  const size_t krow = size_t(bh) * lk + col;
  const float* qb = q + size_t(bh) * lq * dh;
  const float* db = dout + size_t(bh) * lq * dh;
  const float* lb = lse + size_t(bh) * lq;
  const float* deb = delta + size_t(bh) * lq;

  float kr[DP], vr[DP], dka[DP], dva[DP];
  flash::load_row<DP>(kr, k + krow * dh, dh, live);
  flash::load_row<DP>(vr, v + krow * dh, dh, live);
#pragma unroll
  for (int c = 0; c < DP; ++c) dka[c] = dva[c] = 0.f;
  const float bcol = live ? bias[size_t(bh / nh) * lk + col] : 0.f;

  for (int t0 = 0; t0 < lq; t0 += TQ) {
    const int n = min(TQ, lq - t0);
    __syncthreads();  // every read of the last tile is done
    flash::stage<DP>(qs, qb + size_t(t0) * dh, n, dh);
    flash::stage<DP>(dos, db + size_t(t0) * dh, n, dh);
    for (int i = threadIdx.x; i < n; i += flash::THREADS) {
      ls[i] = lb[t0 + i];
      dls[i] = deb[t0 + i];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float* qi = qs + i * DP;
      const float* di = dos + i * DP;
      const float s = flash::logit(flash::dot<DP>(kr, qi), scale, bcol, t0 + i, col, causal);
      const float p = __expf(s - ls[i]);
#pragma unroll
      for (int c = 0; c < DP; ++c) dva[c] = fmaf(p, di[c], dva[c]);
      const float ds = p * (flash::dot<DP>(vr, di) - dls[i]);
#pragma unroll
      for (int c = 0; c < DP; ++c) dka[c] = fmaf(ds, qi[c], dka[c]);
    }
  }
  if (live) {
    float* dkr = dk + krow * dh;
    float* dvr = dv + krow * dh;
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < dh) {
        dkr[c] = dka[c] * scale;
        dvr[c] = dva[c];
      }
  }
}

}  // namespace

extern "C" {

// q, dout (B, H, Lq, Dh), k and v (B, H, Lk, Dh), bias (B, Lk), lse and delta
// (B, H, Lq) f32 -> dk, dv (B, H, Lk, Dh) f32, all contiguous on the current
// device; 1 <= Dh <= 64, Lq, Lk >= 1. Returns the CUDA error code of the launch
// (0 on success).
int flash_bwd_dkv(const float* q, const float* k, const float* v, const float* bias,
                  const float* lse, const float* dout, const float* delta, float* dk, float* dv,
                  float scale, int causal, int b, int h, int lq, int lk, int dh, void* stream) {
  const dim3 grid(b * h, (lk + flash::THREADS - 1) / flash::THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP)                                                   \
  flash_bwd_dkv_kernel<DP><<<grid, flash::THREADS, 0, st>>>(         \
      q, k, v, bias, lse, dout, delta, dk, dv, scale, causal != 0, h, lq, lk, dh)
  FLASH_DISPATCH(dh, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
