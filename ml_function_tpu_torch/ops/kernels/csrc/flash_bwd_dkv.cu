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
// with the layouts of flash_fwd.cu, all f32, Dh <= 64. Its four products
// (Sᵀ = K.Qᵀ, dPᵀ = V.dOᵀ, dV += Pᵀ.dO, dK += dSᵀ.Q) run on the tensor cores
// as split-TF32 mma.sync m16n8k8 (flash.cuh), f32-accurate and with no
// bias toward zero: dk and dv within 1.5e-6 of max|f64|, their mean shrink
// 1.7e-7 and 1.2e-7 of their mean |value| (tools/flash_numerics.py; the
// CUDA-core kernel it replaced erred by 3.2e-6 and 2.4e-6).
//
// What bounds it on the H100: at SIM's flash-ESU shape (B 8, H 2,
// Lq = Lk = 16,384, Dh 8) it takes 4.29e9 (query, key) pairs. Its products,
// 8 * Dh flops a pair, take 1.67 ms in three TF32 passes at 495 TFLOP/s; its
// one exponential a pair 1.03 ms on the SFU; its 50 MB 0.015 ms. So the
// tensor cores bound it at 1.67 ms (4.10 ms at the f32 rate of the CUDA
// cores). It takes 6.58-6.64 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py), against 8.57-8.73 ms for the CUDA-core kernel it
// replaced, in the same run. What holds it there: for each 128 pairs a
// warp issues 12 mma.sync (2.7-3.3 ms of tensor work alone at the
// 250-308 TFLOP/s that mma.sync reaches in TF32, tools/mma_rates.py), 4 ex2
// and, by the code's count, about 50 other instructions (scale, bias,
// exponent, dS, the rounded splits of P and dS, the f32 adds of each
// k-step's products, loads), from one scheduler with 4 warps. wgmma for Sᵀ
// and dPᵀ (M 64 keys, N the queries) is the lever left.
//
// Design: the TPU kernel looped over query blocks with q, dO, lse and delta
// transposed so that Dh sat on its sublanes. Here a block of 8 warps (4 at
// Dh 64, for shared memory) takes 128 (64) key rows of one (b, h); their k
// and v rows are split once into shared memory, and each warp owns 16 of
// them (the mma's M), with its dK and dV accumulators (C fragments) in
// registers. Tiles of QT queries of q and dO, each split once in both
// layouts of flash.cuh ("rows" for the products over Dh, "pairs" for the
// products over the queries), and of lse and delta, are staged
// double-buffered: the next tile's floats are loaded into registers while
// the warps compute on this one. A warp takes SUB queries at a time: it forms
// its 16 x SUB blocks of Sᵀ and dPᵀ, turns them into Pᵀ and dSᵀ in place,
// and feeds those C fragments straight into the dV and dK products (the
// permutation of the queries, flash.cuh). Only the last tile, and tiles
// that cross the causal diagonal, pay for the per-pair checks; a query
// whose keys are all masked (its lse near NEG_INF) takes exp(s - lse) with
// s - lse formed first (flash::MASKED). Each warp writes its own dk and dv
// rows once: no atomics across blocks, and the same inputs give the same
// bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "flash.cuh"

namespace {

// The tiling at each padded width: the path's Dh 8 keeps two blocks of 8
// warps an SM (128 registers a thread) and stages 64 queries at a time;
// the wider heads trade tile sizes for registers, so that nothing spills.
template <int DP>
struct Dkv {
  static constexpr int WARPS = DP == 64 ? 4 : 8;    // 4 at Dh 64, for shared memory
  static constexpr int NT = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;          // key rows of one block
  static constexpr int QT = DP <= 16 ? 64 : DP == 32 ? 32 : 16;   // queries a staged tile
  static constexpr int SUB = DP == 8 ? 32 : DP <= 32 ? 16 : 8;    // queries a warp forms at once
  static constexpr int MIN_BLOCKS = DP == 8 ? 2 : 1;   // an SM, for the registers
  // the next tile's floats are loaded while this one is computed; at Dh 64
  // they are loaded as they are stored, to keep registers for the sums
  static constexpr bool PREFETCH = DP < 64;
  static constexpr int OWN = ROWS * flash::row_stride<DP>();   // k or v, split
  static constexpr int RS = QT * flash::row_stride<DP>();      // q or dO, "rows"
  static constexpr int PS = QT / 2 * flash::pair_stride<DP>(); // q or dO, "pairs"
  static constexpr int BUF = 2 * RS + 2 * PS + 3 * QT;         // + lse, lse·log2 e, delta
  static constexpr int SMEM = (2 * OWN + 2 * BUF) * 4;         // bytes
};

// The staged tile's parts.
template <int DP>
struct QTile {
  const float *qr, *dr, *qp, *dp, *lse, *ml, *delta;
  __device__ __forceinline__ explicit QTile(const float* buf) {
    using C = Dkv<DP>;
    qr = buf;
    dr = qr + C::RS;
    qp = dr + C::RS;
    dp = qp + C::PS;
    lse = dp + C::PS;
    ml = lse + C::QT;
    delta = ml + C::QT;
  }
};

// One tile of queries for one warp, SUB queries at a time (the registers of
// Sᵀ and dPᵀ). CHECK: some query of the tile is past Lq, or before one of
// the warp's keys under the causal mask. EXACT: some query of the tile has
// every key masked (its lse lies in the masked regime, flash.cuh).
template <int DP, bool CHECK, bool EXACT>
__device__ __forceinline__ void dkv_tile(const QTile<DP>& tile, const float* ks, const float* vs,
                                         float (&dk)[DP / 8][4], float (&dv)[DP / 8][4],
                                         const float (&bk)[2], float scale, bool causal,
                                         int key0, int t0, int lq, int g, int t) {
  constexpr int QT = Dkv<DP>::QT, SJ = Dkv<DP>::SUB / 8;
  const int r0 = key0 % Dkv<DP>::ROWS;   // the warp's first row in ks, vs
#pragma unroll 1
  for (int j0 = 0; j0 < QT / 8; j0 += SJ) {
    float st[SJ][4], dpt[SJ][4];
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const flash::FragA ka = flash::a_rows<DP>(ks, r0, kk, g, t);
      const flash::FragA va = flash::a_rows<DP>(vs, r0, kk, g, t);
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        flash::mma3_sum(st[j], kk, ka, flash::b_rows<DP>(tile.qr, 8 * (j0 + j), kk, g, t));
        flash::mma3_sum(dpt[j], kk, va, flash::b_rows<DP>(tile.dr, 8 * (j0 + j), kk, g, t));
      }
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int i0 = 8 * (j0 + j) + 2 * t;
      const float2 ml = *reinterpret_cast<const float2*>(tile.ml + i0);
      const float2 dl = *reinterpret_cast<const float2*>(tile.delta + i0);
      const float2 ls = *reinterpret_cast<const float2*>(tile.lse + i0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // element e: key row g + 8 (e >> 1) of the warp, query i0 + (e & 1)
        const int query = t0 + i0 + (e & 1), key = key0 + g + 8 * (e >> 1);
        float s;
        if (CHECK) {
          s = query >= lq ? -CUDART_INF_F
                          : flash::logit(st[j][e], scale, bk[e >> 1], query, key, causal);
        } else {
          s = __fadd_rn(__fmul_rn(st[j][e], scale), bk[e >> 1]);
        }
        const float p = flash::exp_minus<EXACT>(s, (e & 1) ? ls.y : ls.x, (e & 1) ? ml.y : ml.x);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dl.y : dl.x));
      }
      const flash::FragA pa = flash::a_from_c(st[j]);
      const flash::FragA sa = flash::a_from_c(dpt[j]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const flash::FragB ob = flash::b_pairs<DP>(tile.dp, j0 + j, n, g, t);
        const flash::FragB qb = flash::b_pairs<DP>(tile.qp, j0 + j, n, g, t);
        flash::mma3_add(dv[n], pa, ob);
        flash::mma3_add(dk[n], sa, qb);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(Dkv<DP>::NT, Dkv<DP>::MIN_BLOCKS)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, float scale, bool causal, int nh, int lq, int lk,
                         int dh) {
  using C = Dkv<DP>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + C::OWN;
  float* bufs = vs + C::OWN;
  const int bh = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kblock = blockIdx.y * C::ROWS, key0 = kblock + warp * 16;
  const float* qb = q + size_t(bh) * lq * dh;
  const float* db = dout + size_t(bh) * lq * dh;
  const float* lb = lse + size_t(bh) * lq;
  const float* deb = delta + size_t(bh) * lq;
  {  // the block's k and v rows, split once
    flash::Stager<DP, C::ROWS, C::NT> own;
    const int n = min(C::ROWS, lk - kblock);
    own.fetch_rows(k + (size_t(bh) * lk + kblock) * dh, n, dh);
    own.store_rows(ks);
    own.fetch_rows(v + (size_t(bh) * lk + kblock) * dh, n, dh);
    own.store_rows(vs);
  }
  float bk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    bk[r] = key < lk ? bias[size_t(bh / nh) * lk + key] : 0.f;
  }
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  flash::Stager<DP, C::QT, C::NT> qrs, drs, qps, dps;
  float lnext = 0.f, dnext = 0.f;
  bool masked = false;   // the tile being stored has a query in the masked regime
  // q and dO of the tile at t0 into registers, and its row statistics
  auto load = [&](int t0) {
    const int n = min(C::QT, lq - t0);
    qrs.fetch_rows(qb + size_t(t0) * dh, n, dh);
    drs.fetch_rows(db + size_t(t0) * dh, n, dh);
    qps.fetch_pairs(qb + size_t(t0) * dh, n, dh);
    dps.fetch_pairs(db + size_t(t0) * dh, n, dh);
    if (threadIdx.x < C::QT) {
      lnext = threadIdx.x < n ? lb[t0 + threadIdx.x] : 0.f;
      dnext = threadIdx.x < n ? deb[t0 + threadIdx.x] : 0.f;
    }
  };
  auto fetch = [&](int t0) {
    if (C::PREFETCH) load(t0);
  };
  auto store = [&](float* buf, int t0) {
    if (!C::PREFETCH) load(t0);
    qrs.store_rows(buf);
    drs.store_rows(buf + C::RS);
    qps.store_pairs(buf + 2 * C::RS);
    dps.store_pairs(buf + 2 * C::RS + C::PS);
    if (threadIdx.x < C::QT) {
      float* rowstats = buf + 2 * C::RS + 2 * C::PS;
      rowstats[threadIdx.x] = lnext;
      rowstats[C::QT + threadIdx.x] = lnext * flash::LOG2E;
      rowstats[2 * C::QT + threadIdx.x] = dnext;
    }
    masked = threadIdx.x < C::QT && lnext < flash::MASKED;
  };
  fetch(0);
  store(bufs, 0);
  bool exact = __syncthreads_or(masked);
  const bool live = key0 < lk;
  for (int t0 = 0, it = 0; t0 < lq; t0 += C::QT, ++it) {
    const QTile<DP> tile(bufs + (it & 1) * C::BUF);
    const bool more = t0 + C::QT < lq;
    if (more) fetch(t0 + C::QT);
    if (live) {
      if (exact)
        dkv_tile<DP, true, true>(tile, ks, vs, dka, dva, bk, scale, causal, key0, t0, lq, g, t);
      else if (t0 + C::QT > lq || (causal && key0 + 15 > t0))
        dkv_tile<DP, true, false>(tile, ks, vs, dka, dva, bk, scale, causal, key0, t0, lq, g, t);
      else
        dkv_tile<DP, false, false>(tile, ks, vs, dka, dva, bk, scale, causal, key0, t0, lq, g, t);
    }
    masked = false;
    if (more) store(bufs + ((it + 1) & 1) * C::BUF, t0 + C::QT);
    exact = __syncthreads_or(masked);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (key >= lk) continue;
    const size_t krow = size_t(bh) * lk + key;
    float* dkr = dk + krow * dh;
    float* dvr = dv + krow * dh;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        if (c < dh) {
          dkr[c] = dka[n][2 * r + e] * scale;
          dvr[c] = dva[n][2 * r + e];
        }
      }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP)                                                                        \
  {                                                                                       \
    using C = Dkv<DP>;                                                                    \
    static bool ready = false;                                                            \
    if (const int e = flash::allow_smem(flash_bwd_dkv_kernel<DP>, C::SMEM, ready)) return e; \
    const dim3 grid(b * h, (lk + C::ROWS - 1) / C::ROWS);                                 \
    flash_bwd_dkv_kernel<DP><<<grid, C::NT, C::SMEM, st>>>(                               \
        q, k, v, bias, lse, dout, delta, dk, dv, scale, causal != 0, h, lq, lk, dh);      \
  }
  FLASH_DISPATCH(dh, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
