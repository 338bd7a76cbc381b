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
// with the layouts of flash_fwd.cu, dO like q and delta like lse, all f32,
// Dh <= 64. Its three products (S = q.Kᵀ, dP = dO.Vᵀ, dQ += dS.K) run on the
// tensor cores as split-TF32 mma.sync m16n8k8 (flash.cuh), f32-accurate
// and with no bias toward zero: dq within 1.8e-6 of max|f64|, its mean
// shrink 1.9e-7 of its mean |value| (tools/flash_numerics.py; the CUDA-core
// kernel it replaced erred by 6.7e-6).
//
// What bounds it on the H100: at SIM's flash-ESU shape (B 8, H 2,
// Lq = Lk = 16,384, Dh 8) it takes 4.29e9 (query, key) pairs. Its products,
// 6 * Dh flops a pair, take 1.25 ms in three TF32 passes at 495 TFLOP/s; its
// one exponential a pair 1.03 ms on the SFU; its 42 MB 0.013 ms. So the
// tensor cores bound it at 1.25 ms (3.08 ms at the f32 rate of the CUDA
// cores). It takes 4.45-4.46 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py), against 7.02-7.03 ms for the CUDA-core kernel it
// replaced, in the same call. What holds it there: for each 128 pairs a
// warp issues 9 mma.sync (2.0-2.5 ms of tensor work alone at the
// 250-308 TFLOP/s that mma.sync reaches in TF32, tools/mma_rates.py), 4 ex2
// and, by the code's count, about 45 other instructions (scale, bias,
// exponent, dS, the rounded split of dS, the f32 adds of each k-step's
// product, loads), from one scheduler with 4 warps, as in the forward and
// dK/dV. wgmma for S and dP (N 64 keys) is the lever left.
//
// Design: the forward's grid (flash_fwd.cu) with dS.K in place of P.V. The
// TPU kernel kept K and V transposed and Lk padded to 512; here a block of
// 8 warps takes 128 query rows of one (b, h) and each warp owns 16 of them
// (the mma's M): their q and dO split into hi and lo A fragments, kept in
// registers (in shared memory at Dh 64, for the registers), their lse,
// lse * log2 e and delta, and the dq accumulators (C fragments). Tiles of KT
// keys are split once as they are staged into shared memory, double-
// buffered (the next tile's floats are loaded while the warps compute on
// this one): K twice, in "rows" (the B operand of q.Kᵀ, contracted over Dh)
// and in "pairs" (the B operand of dS.K, contracted over the keys), V in
// "rows" (dO.Vᵀ), and the bias. For 8 keys at a time a warp forms S and dP
// over the Dh k-steps, P = exp(S - lse) and dS = P * (dP - delta) in the
// C fragments, turns dS into an A fragment in place (the key permutation,
// flash.cuh) and adds dS.K, formed from zero, into its accumulators in f32:
// nothing is chained through the tensor cores' truncating sum. Only the
// last tile, and tiles that cross the causal diagonal, pay for the per-pair
// checks; a warp with a row whose keys are all masked (its lse lies in the
// masked regime, flash.cuh) takes exp(s - lse) with s - lse formed first.
// Each warp writes its own dq rows once, scaled once: no atomics, and the
// same inputs give the same bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "flash.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;   // query rows of one block

// The tiling at each padded width: the path's Dh 8 keeps two blocks an SM
// (128 registers a thread); at Dh 64 q and dO (128 registers of fragments)
// are read from shared memory instead, two k-steps at a time, so that
// nothing spills.
template <int DP>
struct Dq {
  static constexpr int KT = DP <= 16 ? 64 : DP == 32 ? 32 : 16;   // keys of one staged tile
  static constexpr int SUB = DP <= 16 ? 32 : DP == 32 ? 16 : 8;   // keys a warp takes at once
  static constexpr int NJ = SUB / 8;                              // k-steps of dS.K in SUB
  static constexpr bool SHARED_Q = DP == 64;     // q and dO split in shared memory
  static constexpr int OWN = SHARED_Q ? ROWS * flash::row_stride<DP>() : 0;   // q or dO
  static constexpr int RS = KT * flash::row_stride<DP>();          // K or V, "rows"
  static constexpr int PS = KT / 2 * flash::pair_stride<DP>();     // K, "pairs"
  static constexpr int BUF = 2 * RS + PS + KT;                     // + the bias
  static constexpr int SMEM = (2 * OWN + 2 * BUF) * 4;             // bytes
  static constexpr int MIN_BLOCKS = DP == 8 ? 2 : 1;   // an SM, for the registers
};

// What a warp keeps for its 16 query rows: q and dO split into A fragments
// (unless SHARED_Q), the dq accumulators, and for the two rows a lane holds
// lse, lse * log2 e and delta.
template <int DP>
struct Rows {
  flash::FragA qa[DP / 8], da[DP / 8];
  float acc[DP / 8][4];
  float lse[2], ml[2], delta[2];
};

// SUB keys for one warp, 8 at a time: S and dP over Dh, P, dS, and dS.K
// into the accumulators. CHECK: some key of the SUB is past Lk, or after
// one of the warp's rows under the causal mask. EXACT: a row of the warp
// has every key masked.
template <int DP, bool CHECK, bool EXACT>
__device__ __forceinline__ void dq_tile(const float* ks, const float* vs, const float* kp,
                                        const float* bs, const float* qs, const float* dos,
                                        Rows<DP>& w, float scale, bool causal, int row0, int r0,
                                        int t0, int lk, int g, int t) {
#pragma unroll
  for (int j = 0; j < Dq<DP>::NJ; ++j) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (Dq<DP>::SHARED_Q) {
      // two k-steps at a time: unrolled whole, the fragments' loads of all
      // eight were hoisted and spilled
#pragma unroll 1
      for (int k0 = 0; k0 < DP / 8; k0 += 2) {
#pragma unroll
        for (int kk = k0; kk < k0 + 2; ++kk) {
          flash::mma3_sum(s, kk, flash::a_rows<DP>(qs, r0, kk, g, t),
                          flash::b_rows<DP>(ks, 8 * j, kk, g, t));
          flash::mma3_sum(dp, kk, flash::a_rows<DP>(dos, r0, kk, g, t),
                          flash::b_rows<DP>(vs, 8 * j, kk, g, t));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        flash::mma3_sum(s, kk, w.qa[kk], flash::b_rows<DP>(ks, 8 * j, kk, g, t));
        flash::mma3_sum(dp, kk, w.da[kk], flash::b_rows<DP>(vs, 8 * j, kk, g, t));
      }
    }
    const float2 b = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // element e: query row g + 8 (e >> 1) of the warp, key 8j + 2t + (e & 1)
      const int r = e >> 1, key = t0 + 8 * j + 2 * t + (e & 1), row = row0 + g + 8 * r;
      float x = (e & 1) ? b.y : b.x;
      if (CHECK) {
        x = key >= lk ? -CUDART_INF_F : flash::logit(s[e], scale, x, row, key, causal);
      } else {
        x = __fadd_rn(__fmul_rn(s[e], scale), x);
      }
      const float p = flash::exp_minus<EXACT>(x, w.lse[r], w.ml[r]);
      dp[e] = p * (dp[e] - w.delta[r]);
    }
    const flash::FragA sa = flash::a_from_c(dp);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      flash::mma3_add(w.acc[n], sa, flash::b_pairs<DP>(kp, j, n, g, t));
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, Dq<DP>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        const float* __restrict__ delta, float* __restrict__ dq, float scale,
                        bool causal, int nh, int lq, int lk, int dh) {
  using C = Dq<DP>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // the block's q, split (SHARED_Q)
  float* dos = qs + C::OWN;                      // and its dO
  float* bufs = dos + C::OWN;
  const int bh = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qblock = blockIdx.y * ROWS, r0 = warp * 16, row0 = qblock + r0;
  const float* kb = k + size_t(bh) * lk * dh;
  const float* vb = v + size_t(bh) * lk * dh;
  const float* bb = bias + size_t(bh / nh) * lk;
  const float* qb = q + size_t(bh) * lq * dh;
  const float* db = dout + size_t(bh) * lq * dh;

  Rows<DP> w;
  if constexpr (C::SHARED_Q) {
    flash::Stager<DP, ROWS, NT> own;
    const int n = min(ROWS, lq - qblock);
    own.fetch_rows(qb + size_t(qblock) * dh, n, dh);
    own.store_rows(qs);
    own.fetch_rows(db + size_t(qblock) * dh, n, dh);
    own.store_rows(dos);
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      w.qa[kk] = flash::a_global(qb, row0, kk, lq, dh, g, t);
      w.da[kk] = flash::a_global(db, row0, kk, lq, dh, g, t);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    w.lse[r] = row < lq ? lse[size_t(bh) * lq + row] : 0.f;
    w.ml[r] = w.lse[r] * flash::LOG2E;
    w.delta[r] = row < lq ? delta[size_t(bh) * lq + row] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) w.acc[n][0] = w.acc[n][1] = w.acc[n][2] = w.acc[n][3] = 0.f;
  const bool exact =
      __any_sync(0xffffffffu, w.lse[0] < flash::MASKED || w.lse[1] < flash::MASKED);

  flash::Stager<DP, C::KT, NT> krs, kps, vrs;
  float bnext = 0.f;
  auto fetch = [&](int t0) {
    const int n = min(C::KT, lk - t0);
    krs.fetch_rows(kb + size_t(t0) * dh, n, dh);
    kps.fetch_pairs(kb + size_t(t0) * dh, n, dh);
    vrs.fetch_rows(vb + size_t(t0) * dh, n, dh);
    if (threadIdx.x < C::KT) bnext = threadIdx.x < n ? bb[t0 + threadIdx.x] : 0.f;
  };
  auto store = [&](float* buf) {
    krs.store_rows(buf);
    vrs.store_rows(buf + C::RS);
    kps.store_pairs(buf + 2 * C::RS);
    if (threadIdx.x < C::KT) buf[2 * C::RS + C::PS + threadIdx.x] = bnext;
  };
  fetch(0);
  store(bufs);
  __syncthreads();
  const bool live = row0 < lq;
  for (int t0 = 0, it = 0; t0 < lk; t0 += C::KT, ++it) {
    const float* buf = bufs + (it & 1) * C::BUF;
    const bool more = t0 + C::KT < lk;
    if (more) fetch(t0 + C::KT);
    if (live) {
#pragma unroll 1
      for (int k0 = 0; k0 < C::KT && t0 + k0 < lk; k0 += C::SUB) {
        const float* ks = buf + k0 * flash::row_stride<DP>();
        const float* vs = buf + C::RS + k0 * flash::row_stride<DP>();
        const float* kp = buf + 2 * C::RS + k0 / 2 * flash::pair_stride<DP>();
        const float* bs = buf + 2 * C::RS + C::PS + k0;
        const int tk = t0 + k0;
        const bool check = tk + C::SUB > lk || (causal && tk + C::SUB - 1 > row0);
#define DQ_TILE(CHECK, EXACT) \
  dq_tile<DP, CHECK, EXACT>(ks, vs, kp, bs, qs, dos, w, scale, causal, row0, r0, tk, lk, g, t)
        if (exact) {
          if (check) DQ_TILE(true, true); else DQ_TILE(false, true);
        } else {
          if (check) DQ_TILE(true, false); else DQ_TILE(false, false);
        }
#undef DQ_TILE
      }
    }
    if (more) store(bufs + ((it + 1) & 1) * C::BUF);
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= lq) continue;
    float* out = dq + (size_t(bh) * lq + row) * dh;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        if (c < dh) out[c] = w.acc[n][2 * r + e] * scale;
      }
    }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP)                                                                          \
  {                                                                                         \
    using C = Dq<DP>;                                                                       \
    static bool ready = false;                                                              \
    if (const int e = flash::allow_smem(flash_bwd_dq_kernel<DP>, C::SMEM, ready)) return e; \
    const dim3 grid(b * h, (lq + ROWS - 1) / ROWS);                                         \
    flash_bwd_dq_kernel<DP><<<grid, NT, C::SMEM, st>>>(q, k, v, bias, lse, dout, delta, dq, \
                                                       scale, causal != 0, h, lq, lk, dh);  \
  }
  FLASH_DISPATCH(dh, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
