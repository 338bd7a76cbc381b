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
// all f32, Dh <= 64.
//
// Products: q.kᵀ and P.V run on the tensor cores as split-TF32 mma.sync
// m16n8k8 (flash.cuh): three TF32 passes a product and f32 sums, so the
// kernel stays as close to an f64 reference as an f32 one, with no bias
// toward zero: o within 2.8e-6 of max|o| and lse within 2.6e-6, o's mean
// shrink 1.1e-7 of its mean |value| (tools/flash_numerics.py; the CUDA-core
// kernel it replaced erred by 4.4e-6 and 2.5e-6).
//
// What bounds it on the H100: at SIM's flash-ESU shape (B 8, H 2,
// Lq = Lk = 16,384, Dh 8) it takes 4.29e9 (query, key) pairs. Its products,
// 4 * Dh flops a pair, take 0.83 ms in three TF32 passes at 495 TFLOP/s; its
// one exponential a pair, on the SFU's 16 a clock an SM, 1.03 ms at
// 1.98 GHz; its 33.6 MB of q, k, v and o 0.01 ms. So the exponentials bound
// it at 1.03 ms (2.05 ms at the f32 rate of the CUDA cores). It takes
// 4.15-4.22 ms on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against
// 6.95-7.09 ms for the CUDA-core kernel it replaced, in the same run. What
// holds it there: for each 128 pairs a warp issues 6 mma.sync (1.3-1.6 ms
// of tensor work alone at the 250-308 TFLOP/s that mma.sync reaches in
// TF32, tools/mma_rates.py), 4 ex2 (8 clocks each on the SFU) and, by the
// code's count, about 48 other instructions (scale, bias, max, sum, the
// rounded split of P, the f32 adds of each k-step's product, loads), all
// from one scheduler with 4 warps; the three pipes overlap poorly. wgmma
// for q.kᵀ is the lever left for the products.
//
// Design: the TPU kernel padded Lq to 128, Lk to 512 and Dh to 8 and stored
// K and V transposed for its lanes; none of that is needed here. A block of
// 8 warps takes 128 query rows of one (b, h); each warp owns 16 of them (the
// mma's M), keeps their q split into hi and lo in registers, and keeps its
// running max m, partial sums l and output accumulators (C fragments) there
// too. Tiles of KT keys of K (the "rows" layout), V (the "pairs" layout)
// and the bias are split once as they are staged into shared memory,
// double-buffered: the next tile's floats are loaded into registers while
// the warps compute on this one. A warp scores SUB keys at a time: it forms
// its 16 x SUB logits, takes each row's max across the quad of lanes that
// share it (two shuffles), rescales its accumulators once, and feeds the
// probabilities, still in C fragments, straight into P.V (the key
// permutation, flash.cuh). Keys past Lk do not exist (weight 0), so a query
// whose keys are all masked gets mean(V), the reference's dense value; such
// a row's logits and max both sit near NEG_INF, and it takes exp(s - m)
// with s - m formed first (flash::MASKED). Only the last tile, and tiles
// that cross the causal diagonal, pay for the per-pair checks. The (Lq, Lk)
// matrix never leaves registers; nothing but o and lse reaches device
// memory, each written once by one warp, so two runs give the same bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "flash.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;   // query rows of one block

// The tiling at each padded width: the path's Dh 8 keeps two blocks an SM
// (128 registers a thread) and scores 32 keys at once (at 64 it spilled
// once each k-step's product was added in f32); Dh 64 scores 8, so that
// nothing spills.
template <int DP>
struct Fwd {
  static constexpr int KT = DP <= 16 ? 64 : 32;     // keys of one staged tile
  static constexpr int SUB = DP <= 32 ? 32 : 8;     // keys a warp scores at once
  static constexpr int NJ = SUB / 8;                // k-steps of P.V in SUB
  static constexpr int KS = KT * flash::row_stride<DP>();
  static constexpr int VS = KT / 2 * flash::pair_stride<DP>();
  static constexpr int BUF = KS + VS + KT;          // floats of one buffer
  static constexpr int SMEM = 2 * BUF * 4;          // bytes, both buffers
  static constexpr int MIN_BLOCKS = DP == 8 ? 2 : 1;   // an SM, for the registers
};

// What a warp keeps for its 16 query rows: q split into A fragments, the
// output accumulators (C fragments), and each row's running max m and this
// lane's part of its sum l (a lane holds two rows).
template <int DP>
struct Rows {
  flash::FragA qa[DP / 8];
  float acc[DP / 8][4];
  float m[2], l[2];
};

// The probabilities of one sub-tile's logits s (in place), their sums into l
// and P.V into acc, each k-step's product added in f32 (flash::mma3_add).
// EXACT: a row of the warp has had every key masked so far.
template <int DP, bool EXACT>
__device__ __forceinline__ void fwd_pv(float (&s)[Fwd<DP>::NJ][4], const float* vs, Rows<DP>& w,
                                       const float (&ml)[2], int g, int t) {
#pragma unroll
  for (int j = 0; j < Fwd<DP>::NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = flash::exp_minus<EXACT>(s[j][e], w.m[e >> 1], ml[e >> 1]);
      w.l[e >> 1] += p;
      s[j][e] = p;
    }
    const flash::FragA pa = flash::a_from_c(s[j]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      flash::mma3_add(w.acc[n], pa, flash::b_pairs<DP>(vs, j, n, g, t));
  }
}

// One sub-tile of SUB keys for one warp: the logits of its 16 rows against
// the keys, the online-softmax update and P.V. CHECK: some key of the
// sub-tile is past Lk, or after one of the warp's rows under the causal
// mask.
template <int DP, bool CHECK>
__device__ __forceinline__ void fwd_tile(const float* ks, const float* vs, const float* bs,
                                         Rows<DP>& w, float scale, bool causal, int row0, int t0,
                                         int lk, int g, int t) {
  using C = Fwd<DP>;
  float s[C::NJ][4];
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      flash::mma3_sum(s[j], kk, w.qa[kk], flash::b_rows<DP>(ks, 8 * j, kk, g, t));
  }
  float mx[2] = {w.m[0], w.m[1]};
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + 8 * j + 2 * t + (e & 1), row = row0 + g + 8 * (e >> 1);
      float x = (e & 1) ? b.y : b.x;
      if (CHECK) {
        x = key >= lk ? -CUDART_INF_F : flash::logit(s[j][e], scale, x, row, key, causal);
      } else {
        x = __fadd_rn(__fmul_rn(s[j][e], scale), x);
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float ml[2];
  bool masked = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = flash::quad_max(mx[r]);
    const float alpha = flash::fast_exp(w.m[r] - mnew);
    w.m[r] = mnew;
    ml[r] = mnew * flash::LOG2E;
    masked |= mnew < flash::MASKED;
    w.l[r] *= alpha;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      w.acc[n][2 * r] *= alpha;
      w.acc[n][2 * r + 1] *= alpha;
    }
  }
  if (__any_sync(0xffffffffu, masked))
    fwd_pv<DP, true>(s, vs, w, ml, g, t);
  else
    fwd_pv<DP, false>(s, vs, w, ml, g, t);
}

template <int DP>
__global__ void __launch_bounds__(NT, Fwd<DP>::MIN_BLOCKS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse, float scale, bool causal,
                     int nh, int lq, int lk, int dh) {
  using C = Fwd<DP>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * ROWS + warp * 16;   // the warp's first query row
  const float* kb = k + size_t(bh) * lk * dh;
  const float* vb = v + size_t(bh) * lk * dh;
  const float* bb = bias + size_t(bh / nh) * lk;
  const float* qb = q + size_t(bh) * lq * dh;

  Rows<DP> w;
  // the warp's 16 q rows as A fragments, split once
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) w.qa[kk] = flash::a_global(qb, row0, kk, lq, dh, g, t);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) w.acc[n][0] = w.acc[n][1] = w.acc[n][2] = w.acc[n][3] = 0.f;
  w.m[0] = w.m[1] = flash::NEG_INF;
  w.l[0] = w.l[1] = 0.f;

  flash::Stager<DP, C::KT, NT> kst, vst;
  float bnext = 0.f;
  auto fetch = [&](int t0) {
    const int n = min(C::KT, lk - t0);
    kst.fetch_rows(kb + size_t(t0) * dh, n, dh);
    vst.fetch_pairs(vb + size_t(t0) * dh, n, dh);
    if (threadIdx.x < C::KT) bnext = threadIdx.x < n ? bb[t0 + threadIdx.x] : 0.f;
  };
  auto store = [&](float* buf) {
    kst.store_rows(buf);
    vst.store_pairs(buf + C::KS);
    if (threadIdx.x < C::KT) buf[C::KS + C::VS + threadIdx.x] = bnext;
  };
  fetch(0);
  store(smem);
  __syncthreads();
  const bool live = row0 < lq;
  for (int t0 = 0, it = 0; t0 < lk; t0 += C::KT, ++it) {
    const float* buf = smem + (it & 1) * C::BUF;
    const bool more = t0 + C::KT < lk;
    if (more) fetch(t0 + C::KT);
    if (live) {
#pragma unroll 1
      for (int k0 = 0; k0 < C::KT; k0 += C::SUB) {
        const float* ks = buf + k0 * flash::row_stride<DP>();
        const float* vs = buf + C::KS + k0 / 2 * flash::pair_stride<DP>();
        const float* bs = buf + C::KS + C::VS + k0;
        const int tk = t0 + k0;
        if (tk + C::SUB > lk || (causal && tk + C::SUB - 1 > row0))
          fwd_tile<DP, true>(ks, vs, bs, w, scale, causal, row0, tk, lk, g, t);
        else
          fwd_tile<DP, false>(ks, vs, bs, w, scale, causal, row0, tk, lk, g, t);
      }
    }
    if (more) store(smem + ((it + 1) & 1) * C::BUF);
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float ls = fmaxf(flash::quad_sum(w.l[r]), 1e-30f);
    if (row >= lq) continue;
    const size_t qrow = size_t(bh) * lq + row;
    float* orow = o + qrow * dh;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < dh) orow[c] = w.acc[n][2 * r] / ls;
      if (c + 1 < dh) orow[c + 1] = w.acc[n][2 * r + 1] / ls;
    }
    if (t == 0) lse[qrow] = w.m[r] + logf(ls);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP)                                                                         \
  {                                                                                        \
    using C = Fwd<DP>;                                                                     \
    static bool ready = false;                                                             \
    if (const int e = flash::allow_smem(flash_fwd_kernel<DP>, C::SMEM, ready)) return e;   \
    const dim3 grid(b * h, (lq + ROWS - 1) / ROWS);                                        \
    flash_fwd_kernel<DP><<<grid, NT, C::SMEM, st>>>(q, k, v, bias, o, lse, scale,          \
                                                    causal != 0, h, lq, lk, dh);           \
  }
  FLASH_DISPATCH(dh, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
