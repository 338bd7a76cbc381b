// Flash-attention forward for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces ml_function_tpu/ops/kernels/flash_attention.py::_fwd_kernel
// (launched there by _fwd_call). For each (batch row b, head h) and query row
// i, with s_j = (q_i . k_j) * scale + bias[b, j] (NEG_INF for j > i when
// causal):
//
//   o_i = sum_j exp(s_j - m) v_j / l,   lse_i = m + log(l),
//   m = max(max_j s_j, NEG_INF),        l = max(sum_j exp(s_j - m), 1e-30)
//
// with q, o (B, H, Lq, Dh), k, v (B, H, Lk, Dh), bias (B, Lk), lse (B, H, Lq),
// all f32, Dh <= 64. Products and sums are f32 on the CUDA cores, as the
// reference computes them; TF32 or bf16 tensor cores would change the
// numbers.
//
// What bounds it on the H100: at SIM's flash-ESU shape (B 8, H 2,
// Lq = Lk = 16,384, Dh 8) it does 4 * B * H * Lq * Lk * Dh = 137 GFLOP
// (2.05 ms at the 67 TFLOP/s of f32) for 8.4 MB of q, k, v and o each:
// arithmetic bounds it, with one exp a (query, key) pair besides.
//
// Design: the TPU kernel padded Lq to 128, Lk to 512 and Dh to 8 and stored
// K and V transposed for its lanes; none of that is needed here. One block
// of 128 threads takes 128 query rows of one (b, h); each thread keeps its
// query row and its running (m, l, acc[Dh]) in registers (Dh padded with
// zeros to 8, 16, 32 or 64 at compile time). Tiles of K, V and the bias
// stream through shared memory (8 KB each), and every thread reads the same
// key at once, a broadcast. Keys are scored 16 at a time, so the running
// sums are rescaled once per 16 keys. Keys past Lk do not exist (no padded
// key enters the softmax), so a query whose keys are all masked gets
// mean(V), the reference's dense value. The (Lq, Lk) matrix never leaves
// registers; nothing but o and lse reaches device memory.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "flash.cuh"

namespace {

constexpr int KC = 16;   // keys scored before one rescale of the running sums

template <int DP>
__global__ void __launch_bounds__(flash::THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse, float scale, bool causal,
                     int nh, int lq, int lk, int dh) {
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

  float qr[DP], acc[DP];
  flash::load_row<DP>(qr, q + qrow * dh, dh, live);
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] = 0.f;
  float m = flash::NEG_INF, l = 0.f;

  for (int t0 = 0; t0 < lk; t0 += TK) {
    const int n = min(TK, lk - t0);
    __syncthreads();  // every read of the last tile is done
    flash::stage<DP>(ks, kb + size_t(t0) * dh, n, dh);
    flash::stage<DP>(vs, vb + size_t(t0) * dh, n, dh);
    for (int j = threadIdx.x; j < n; j += flash::THREADS) bs[j] = bb[t0 + j];
    __syncthreads();
    if (!live) continue;
    for (int c0 = 0; c0 < n; c0 += KC) {
      float s[KC];
      float mc = m;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kj = c0 + j;
        s[j] = kj < n ? flash::logit(flash::dot<DP>(qr, ks + kj * DP), scale, bs[kj], row,
                                     t0 + kj, causal)
                      : -CUDART_INF_F;  // no such key: weight exp(-inf) = 0
        mc = fmaxf(mc, s[j]);
      }
      const float alpha = __expf(m - mc);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] *= alpha;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (c0 + j < n) {
          const float p = __expf(s[j] - mc);
          const float* vr = vs + (c0 + j) * DP;
          ps += p;
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
        }
      }
      l = l * alpha + ps;
      m = mc;
    }
  }
  if (live) {
    const float ls = fmaxf(l, 1e-30f);
    float* orow = o + qrow * dh;
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < dh) orow[c] = acc[c] / ls;
    lse[qrow] = m + logf(ls);
  }
}

}  // namespace

extern "C" {

// q (B, H, Lq, Dh), k and v (B, H, Lk, Dh), bias (B, Lk) f32 -> o
// (B, H, Lq, Dh), lse (B, H, Lq) f32, all contiguous on the current device;
// 1 <= Dh <= 64, Lq, Lk >= 1. Returns the CUDA error code of the launch (0 on
// success).
int flash_fwd(const float* q, const float* k, const float* v, const float* bias, float* o,
              float* lse, float scale, int causal, int b, int h, int lq, int lk, int dh,
              void* stream) {
  const dim3 grid(b * h, (lq + flash::THREADS - 1) / flash::THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP)                                                                          \
  flash_fwd_kernel<DP><<<grid, flash::THREADS, 0, st>>>(q, k, v, bias, o, lse, scale, causal != 0, \
                                                        h, lq, lk, dh)
  FLASH_DISPATCH(dh, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
