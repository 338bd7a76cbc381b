// Field-attention forward for Hopper (sm_90a), with a plain C interface for
// ctypes: four instances of one contract, chosen by the wrapper from the
// shape (kernels/field_attention.py: forward_instance).
//
// Replaces ml_function_tpu/ops/kernels/field_attention.py::_fwd_kernel
// (launched there by _call). For each batch row b and head h:
//
//   o[b, :, h] = softmax(q[b, :, h] k[b, :, h]^T * scale + bias[b]) v[b, :, h]
//
// with q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), bias (B, Lk), o (B, Lq, H, Dh),
// all f32, for Lq * Lk <= 4096 and Dh <= 64. Products and sums are f32 on the
// CUDA cores: the reference is f32 throughout, and TF32 or bf16 tensor cores
// would change the numbers. Every instance forms a logit as the plain version
// does, the product times scale, then plus the bias (two roundings: an FMA
// would round the -1e9 of a masked key differently, and a row whose keys are
// all masked would stop being uniform), then expf(s - max) and a division by
// the row's sum.
//
// What bounds it on the H100: at AutoInt's shape (B 4096, L 27, H 2, Dh 16)
// it does 4 * B * H * Lq * Lk * Dh = 382 MFLOP (6 us at the 67 TFLOP/s of f32)
// for 57 MB in and out (17 us at 3.35 TB/s): memory bounds it.
//
// field_attn_fwd_warp, for Lq, Lk <= 32, Dh <= 16 and H <= 8 (AutoInt's
// layers, SIM's top-8 ESU): one warp a (b, h), in the layout of the
// backward's warp instance (field_attn.cuh). A block copies its batch rows'
// q, k, v and bias into shared memory with coalesced loads; lane i owns
// query i: it forms its logits against k_j broadcast from shared memory into
// its column of a per-warp (Lk, ld) matrix, so the row's max and sum are
// formed in one lane, with no shuffles: the sum in the order of
// torch.softmax's warp butterfly (a tree over 32 slots, pairs 16 apart, then
// 8, 4, 2, 1), so that the weights, and at AutoInt's shape o, have the plain
// version's bits, as the block instance's do (a sum in key order moved
// AutoInt's scores 6e-4 from the plain route's through the bf16 roundings
// after the attention); then o_i = sum_j (e_ij / sum) v_j in key order with
// v_j broadcast, written into q_i's slot and copied out by the block with
// coalesced stores. Two block barriers, one after the copy-in and one
// before the copy-out; nothing in between waits on another warp. The logit
// row stays in shared memory: 32 logits in registers spilled in the
// backward at the 128 registers of 16 warps an SM. At AutoInt's shape it
// takes 0.0467 ms on the device (0.0508-0.0509 a call by events) on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against 0.1342-0.1351 for
// the block instance on that shape: 2.7x the bound. About 2,500
// instructions a (b, h), some 20 us of issue at six 4-warp blocks an SM;
// by inference the rest is each block's copy-in, compute and copy-out in
// turn and the shared-memory pipe serving 8 row broadcasts a key.
//
// field_attn_fwd_l64, for the shapes past the warp instance's 32 positions
// up to 64 queries and keys (Dh <= 16, H <= 8: DMIN's refiner, (B 4096,
// L 64, H 2, Dh 8), and SIM's ESU at a top k of 33 to 64): the warp
// instance's blocks and slab copies, one warp a (b, h), a lane on query i
// and then on query i + 32. At DMIN's shape the work is 4 * B * H * Lq *
// Lk * Dh = 1.07 GFLOP (16 us at 67 TFLOP/s) for 68 MB in and out (20 us
// at 3.35 TB/s): memory bounds it, but the block instance, with the whole
// (64, 64) logit matrix of a (b, h) in shared memory, three phases behind
// barriers, a division per staged element and v read through L1, took
// 17x that. Here a query's 64 logits stay in the lane's registers (the
// loops over keys unrolled to 64, so every index is a constant): no (Lq,
// Lk) matrix in shared memory, k_j and v_j broadcast from the slabs as
// 16-byte loads. The key slabs are padded to 64 rows with zeros and a
// bias of -inf (fa::l64_keys_in), so the unrolled loops test no bound and
// the compiler interleaves their keys. Each logit is the FMA chain over d
// in order, times scale, plus the bias (two roundings); then the max,
// expf(s - max), the sum in torch.softmax's order for 33 to 64 keys (lane
// l of its butterfly holds 0 + e[l] + e[l + 32], then pairs 16 apart, 8,
// 4, 2, 1: fa::softmax_sum64, formed in the lane), a = e / sum, and o_i
// the FMA chain over the keys in order: the plain version's arithmetic, so
// at DMIN's shape o has its bits. The division is fa::div_rn (three
// operations from one correctly rounded reciprocal a query, the IEEE
// quotient's bits in its range) unless the row holds an exponential below
// 2^-64, which takes the IEEE division. Two block barriers, after the
// copy-in and before the copy-out; nothing between them waits on another
// warp. No tensor cores: TF32, even split, would not keep those bits, and
// the FMAs are not what bounds it. What holds it above its bound is not
// measured (no hardware counter was read): some 36 instructions a (query,
// key) pair a lane, 38 M warp instructions at DMIN's shape, would take
// about 36 us at full issue.
//
// field_attn_fwd_wide, for every other shape up to 64 queries and keys: Dh
// 17 to 64 (AutoInt at the AutoInt paper's 2 heads of 32, the gate's Dh-64
// edge) or H past 8, where a row no longer fits a lane's registers and a
// block of whole batch rows no longer fits shared memory. At AutoInt's
// (B 4096, L 27, H 2, Dh 32) the work is 0.76 GFLOP (11 us at 67 TFLOP/s)
// for 113 MB in and out (34 us at 3.35 TB/s): memory bounds it. One warp a
// (b, h) and 32 queries: the pair's rows of q, k and v (L of each, L =
// max(Lq, Lk) rounded up to 32 or 64) are staged apart from every other
// pair's by cp.async (fa::wide_rows_in), so a block of 64 threads holds
// 64 / L pairs whatever H is, and no pair waits on another: q and k in one
// group of copies, v in a second that lands while the logits are formed.
// A lane on query i keeps its L logits in registers and reads q_i and k_j
// 16 columns at a time (fa::wide_dots), so it holds L sums and one chunk of
// a row at any Dh; the logit, the softmax (torch.softmax's sum order,
// fa::div_rn) and o_i are the L-64 instance's arithmetic, so at AutoInt's
// shape o has the plain version's bits. A second template instance skips
// the groups of 8 keys past Lk where a whole group is padding (at Lk 12 of
// 32, say); where nothing is skipped its branches cost 5-6% at AutoInt's
// shape (0.0706-0.0710 against 0.0670-0.0672 ms on the device, in turns on
// one NVIDIA H100 80GB HBM3 at 700 W), so the other instance has none. At
// AutoInt's shape it takes 0.0668-0.0675 ms on the device (0.073-0.091 a
// call by events, the wrapper's host time showing) on that card
// (tools/field_attn_instances.py, chip_smoke.py), against 0.21 ms for the
// block instance and 0.28 for SDPA's f32 forward: 2.0x its bound. At the
// gate's (512, 64, 64, 2, 64) it takes 0.063-0.065 ms on the device, on a
// par with SDPA's 0.068-0.075 by events: 52 KB of shared memory a pair and
// 167 registers a thread keep 8 warps an SM there.
//
// field_attn_fwd, for every other shape inside the gate: one block of 128
// threads per (b, h), reading the projections' (B, L, H, Dh) layout in
// place: it stages row tiles of q and k in shared memory, forms the whole
// (Lq, Lk) score matrix there (16 KB at most under the gate), takes each
// row's softmax with one warp, and multiplies by v read row by row through
// L1. At AutoInt's shape it took 0.137-0.146 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py), 8x the bound: each block's three phases run in turn
// behind barriers, with a division per staged element.
//
// The TPU kernel transposed q, k, v to (H, L, Dh, B) so the batch filled its
// 128 lanes; no instance transposes, and ragged B, Lq != Lk and any
// Dh <= 64 need no padding in device memory. Nothing but o reaches device
// memory.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "field_attn.cuh"

namespace {

// ---- field_attn_fwd_warp: one warp a (b, h) ----

// Floats of shared memory: the slabs of q (Lq rows), k and v (Lk rows), the
// bias (rounded up to 4 floats) and each warp's (Lk, ld) logits.
size_t warp_smem_floats(int lq, int lk, int h, int dp) {
  const size_t nb = fa::warp_rows(h), s = fa::slab_stride(h, dp);
  return nb * (lq + 2 * lk) * s + (nb * lk + 3) / 4 * 4 + nb * h * lk * fa::mat_ld(lq);
}

template <int DP>
__global__ void __launch_bounds__(32 * fa::WARP_MAX_H, 3)
    field_attn_fwd_warp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               float* __restrict__ o, float scale, int nbatch, int lq, int lk,
                               int h, int dh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int rows = fa::warp_rows(h), s = fa::slab_stride(h, DP), ld = fa::mat_ld(lq);
  const int b0 = blockIdx.x * rows, nb = min(rows, nbatch - b0);
  float* qs = smem;                    // (rows, lq) rows of H heads: q, then o
  float* ks = qs + rows * lq * s;      // (rows, lk): k
  float* vs = ks + rows * lk * s;      // v
  float* bs = vs + rows * lk * s;      // (rows, lk) bias
  float* mats = bs + (rows * lk + 3) / 4 * 4;   // each warp's logits, (lk, ld)
  const size_t qoff = size_t(b0) * lq * h * dh, koff = size_t(b0) * lk * h * dh;
  if (vec) {
    fa::slabs_in<DP, true, 1>(qs, nullptr, q + qoff, nullptr, nb, lq, h, dh);
    fa::slabs_in<DP, true>(ks, vs, k + koff, v + koff, nb, lk, h, dh);
  } else {
    fa::slabs_in<DP, false, 1>(qs, nullptr, q + qoff, nullptr, nb, lq, h, dh);
    fa::slabs_in<DP, false>(ks, vs, k + koff, v + koff, nb, lk, h, dh);
  }
  for (int e = threadIdx.x; e < nb * lk; e += blockDim.x) bs[e] = bias[size_t(b0) * lk + e];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bl = warp / h, hh = warp % h;
  if (bl < nb && lane < lq) {
    float* qi = qs + (bl * lq + lane) * s + hh * DP;   // query i = lane, then o_i
    const float* kh = ks + bl * lk * s + hh * DP;       // key j at kh + j * s
    const float* vh = vs + bl * lk * s + hh * DP;
    const float* bh = bs + bl * lk;
    float* ai = mats + warp * lk * ld + lane;   // logit, then exponential, of key j at ai[j * ld]
    float x[DP], y[DP];
    fa::load_row<DP>(x, qi);
    float m = -CUDART_INF_F;
#pragma unroll 1
    for (int j = 0; j < lk; ++j) {
      fa::load_row<DP>(y, kh + j * s);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) d = fmaf(x[c], y[c], d);
      const float lg = __fadd_rn(__fmul_rn(d, scale), bh[j]);
      ai[j * ld] = lg;
      m = fmaxf(m, lg);
    }
    // the exponentials, and their sum in torch.softmax's order (a butterfly
    // over 32 lanes, a key a lane: pairs 16 apart, then 8, 4, 2, 1), formed
    // as a tree in this lane: the weights then have the plain version's bits
    auto ex = [&](int jj) {   // e of key jj (0 past lk), kept in its logit's place
      float e = 0.f;
      if (jj < lk) {
        e = expf(ai[jj * ld] - m);
        ai[jj * ld] = e;
      }
      return e;
    };
    float t[8];   // the butterfly's first two levels at once, then the rest
#pragma unroll
    for (int l = 0; l < 8; ++l) t[l] = (ex(l) + ex(l + 16)) + (ex(l + 8) + ex(l + 24));
#pragma unroll
    for (int l = 0; l < 4; ++l) t[l] += t[l + 4];
    t[0] += t[2];
    t[1] += t[3];
    const float sum = t[0] + t[1];
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < lk; ++j) {
      const float a = ai[j * ld] / sum;
      fa::load_row<DP>(y, vh + j * s);
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(a, y[c], acc[c]);
    }
    fa::store_row<DP>(qi, acc, 1.f);   // only this lane reads q_i
  }
  __syncthreads();
  if (vec)
    fa::slab_out<DP, true>(o + qoff, qs, nb, lq, h, dh);
  else
    fa::slab_out<DP, false>(o + qoff, qs, nb, lq, h, dh);
}

// ---- field_attn_fwd_l64: one warp a (b, h), up to 64 queries and keys ----

// Floats of shared memory: the slab of q (Lq rows), the padded slabs of k
// and v (L64 rows a batch row) and the padded bias; no logits.
size_t l64_smem_floats(int lq, int h, int dp) {
  const size_t nb = fa::warp_rows(h), s = fa::slab_stride(h, dp);
  return nb * (lq + 2 * fa::L64) * s + nb * fa::L64;
}

// acc = sum_j a_j v_j over the L64 keys in order, a_j = e[j] / sum (by
// fa::div_rn from r = 1 / sum with kFast, else the IEEE division).
template <int DP, bool kFast>
__device__ __forceinline__ void apply64(float (&acc)[DP], const float (&e)[fa::L64], float sum,
                                        float r, const float* vh, int s) {
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < fa::L64; ++j) {
    const float a = kFast ? fa::div_rn(e[j], sum, r) : e[j] / sum;
    float y[DP];
    fa::load_row<DP>(y, vh + j * s);
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = fmaf(a, y[c], acc[c]);
  }
}

template <int DP>
__global__ void __launch_bounds__(32 * fa::WARP_MAX_H, 2)
    field_attn_fwd_l64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              float* __restrict__ o, float scale, int nbatch, int lq, int lk,
                              int h, int dh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int rows = fa::warp_rows(h), s = fa::slab_stride(h, DP);
  const int b0 = blockIdx.x * rows, nb = min(rows, nbatch - b0);
  float* qs = smem;                      // (rows, lq) rows of H heads: q, then o
  float* ks = qs + rows * lq * s;        // (rows, L64): k, zero past lk
  float* vs = ks + rows * fa::L64 * s;   // v
  float* bs = vs + rows * fa::L64 * s;   // (rows, L64) bias, -inf past lk
  const size_t qoff = size_t(b0) * lq * h * dh, koff = size_t(b0) * lk * h * dh;
  if (vec) {
    fa::slabs_in<DP, true, 1>(qs, nullptr, q + qoff, nullptr, nb, lq, h, dh);
    fa::l64_keys_in<DP, true>(ks, vs, bs, k + koff, v + koff, bias + size_t(b0) * lk, nb, lk,
                              h, dh);
  } else {
    fa::slabs_in<DP, false, 1>(qs, nullptr, q + qoff, nullptr, nb, lq, h, dh);
    fa::l64_keys_in<DP, false>(ks, vs, bs, k + koff, v + koff, bias + size_t(b0) * lk, nb, lk,
                               h, dh);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bl = warp / h, hh = warp % h;
  if (bl < nb) {
    const float* kh = ks + bl * fa::L64 * s + hh * DP;   // key j at kh + j * s
    const float* vh = vs + bl * fa::L64 * s + hh * DP;
    const float* bh = bs + bl * fa::L64;
#pragma unroll 1
    for (int i = lane; i < lq; i += 32) {   // query i, then i + 32
      float* qi = qs + (bl * lq + i) * s + hh * DP;   // q_i, then o_i
      float acc[DP];
      {
        float e[fa::L64];   // the logits, then their exponentials
        {
          float x[DP];
          fa::load_row<DP>(x, qi);
          fa::exps64<DP>(e, x, kh, s, bh, scale);
        }
        const float sum = fa::softmax_sum64(e);
        // div_rn's range: the largest e is 1, so 1 <= sum <= 64; an e in
        // (0, 2^-64) takes the IEEE division for the whole row
        bool tiny = false;
#pragma unroll
        for (int j = 0; j < fa::L64; ++j) tiny |= e[j] > 0.f && e[j] < 0x1p-64f;
        if (tiny)
          apply64<DP, false>(acc, e, sum, 0.f, vh, s);
        else
          apply64<DP, true>(acc, e, sum, __frcp_rn(sum), vh, s);
      }
      fa::store_row<DP>(qi, acc, 1.f);   // only this lane reads q_i
    }
  }
  __syncthreads();
  if (vec)
    fa::slab_out<DP, true>(o + qoff, qs, nb, lq, h, dh);
  else
    fa::slab_out<DP, false>(o + qoff, qs, nb, lq, h, dh);
}

// ---- field_attn_fwd_wide: one warp a (b, h) and 32 queries, any H and Dh ----

// Floats of shared memory of one (b, h): L staged rows each of q, k and v,
// and the bias (L floats, -inf past lk).
__host__ __device__ size_t wide_pair_floats(int l, int dh) {
  return size_t(3 * l) * fa::wide_stride(dh) + l;
}

template <int L, bool SKIP>
__global__ void __launch_bounds__(fa::WIDE_THREADS)
    field_attn_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               float* __restrict__ o, float scale, int nbatch, int lq, int lk,
                               int h, int dh, bool vec) {
  constexpr int PAIRS = fa::WIDE_THREADS / L;   // (b, h) pairs a block, L threads each
  constexpr int CW = fa::WIDE_CHUNK, G = fa::WIDE_GROUP;
  extern __shared__ __align__(16) float smem[];
  const int s = fa::wide_stride(dh), cols = s - 4, stride = h * dh;
  const int slot = threadIdx.x / L, t = threadIdx.x % L;
  const long long pair = static_cast<long long>(blockIdx.x) * PAIRS + slot;
  const bool live = pair < static_cast<long long>(nbatch) * h;
  const int b = live ? static_cast<int>(pair / h) : 0, hh = live ? static_cast<int>(pair % h) : 0;
  float* qs = smem + slot * wide_pair_floats(L, dh);   // L rows: q, zero past lq
  float* ks = qs + L * s;                              // k, zero past lk
  float* vs = ks + L * s;                              // v, zero past lk
  float* bs = vs + L * s;                              // bias, -inf past lk
  const size_t qoff = (size_t(b) * lq * h + hh) * dh, koff = (size_t(b) * lk * h + hh) * dh;
  // two groups of copies: q and k for the logits, then v for o behind them
  if (live) {
    fa::wide_rows_in<L>(qs, q + qoff, lq, stride, dh, s, t, vec);
    fa::wide_rows_in<L>(ks, k + koff, lk, stride, dh, s, t, vec);
    bs[t] = t < lk ? bias[size_t(b) * lk + t] : -CUDART_INF_F;
  }
  fa::cp_async_commit();
  if (live) fa::wide_rows_in<L>(vs, v + koff, lk, stride, dh, s, t, vec);
  fa::cp_async_commit();
  fa::cp_async_wait<1>();
  __syncthreads();

  // lane on query i: its L logits in registers, each the FMAs over d in
  // order (a chunk of q_i at a time against k_j broadcast, fa::wide_dots),
  // then times scale, plus the bias; the max, the exponentials and their
  // sum in torch.softmax's order, then the weights e / sum in place. Keys
  // past lk, a group of G at a time, add nothing and are skipped.
  const int i = t;
  float e[L];
#pragma unroll
  for (int j = 0; j < L; ++j) e[j] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < cols; c0 += CW) {
    float x[CW];
    fa::load_row<CW>(x, qs + i * s + c0);
#pragma unroll
    for (int j0 = 0; j0 < L; j0 += G)
      if (!SKIP || j0 < lk) fa::wide_dots<L>(e, j0, x, ks + c0, s);
  }
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    e[j] = __fadd_rn(__fmul_rn(e[j], scale), bs[j]);
    m = fmaxf(m, e[j]);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) e[j] = expf(e[j] - m);
  const float sum = fa::wide_sum<L>(e);
  // fa::div_rn's range: the largest e is 1, so 1 <= sum <= 64; an e in
  // (0, 2^-64) takes the IEEE division for the whole row
  bool tiny = false;
#pragma unroll
  for (int j = 0; j < L; ++j) tiny |= e[j] > 0.f && e[j] < 0x1p-64f;
  if (tiny) {
#pragma unroll
    for (int j = 0; j < L; ++j) e[j] = e[j] / sum;
  } else {
    const float r = __frcp_rn(sum);
#pragma unroll
    for (int j = 0; j < L; ++j) e[j] = fa::div_rn(e[j], sum, r);
  }

  fa::cp_async_wait<0>();
  __syncthreads();
  // o_i = sum_j a_ij v_j, the FMAs over the keys in order, a chunk of
  // columns at a time against v_j's broadcast, stored from the registers
  if (live && i < lq) {
    float* oi = o + qoff + size_t(i) * stride;
#pragma unroll 1
    for (int c0 = 0; c0 < cols; c0 += CW) {
      float acc[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < L; j0 += G) {
        if (!SKIP || j0 < lk) {
#pragma unroll
          for (int j = j0; j < j0 + G; ++j) {
            float y[CW];
            fa::load_row<CW>(y, vs + j * s + c0);
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[c] = fmaf(e[j], y[c], acc[c]);
          }
        }
      }
      fa::wide_store(oi, acc, c0, dh, 1.f, vec);
    }
  }
}

// ---- field_attn_fwd: one block a (b, h) ----

__global__ void __launch_bounds__(fa::THREADS)
    field_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          float* __restrict__ o, float scale, int lq, int lk, int nh, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, stride = nh * dh;
  float* s = smem;                    // (lq, lk) scores, then weights
  float* xs = s + lq * lk;            // q row tile
  float* ys = xs + (lq < fa::TILE ? lq : fa::TILE) * (dh + 1);  // k row tile
  const size_t qoff = (size_t(b) * lq * nh + h) * dh;
  const size_t koff = (size_t(b) * lk * nh + h) * dh;

  fa::gram<true>(q + qoff, lq, k + koff, lk, dh, stride, xs, ys, s, scale,
                 bias + size_t(b) * lk);
  fa::softmax_rows(s, lq, lk);
  fa::apply<false>(s, lk, lq, lk, v + koff, o + qoff, dh, stride, 1.f);
}

size_t smem_bytes(int lq, int lk, int dh) {
  return (size_t(lq) * lk + fa::tile_floats(lq, lk, dh)) * sizeof(float);
}

}  // namespace

extern "C" {

// q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), bias (B, Lk) f32 -> o (B, Lq, H, Dh)
// f32, all contiguous on the current device; Lq * Lk <= 4096, Dh <= 64.
// Returns the CUDA error code of the launch (0 on success).
int field_attn_fwd(const float* q, const float* k, const float* v, const float* bias, float* o,
                   float scale, int b, int lq, int lk, int h, int dh, void* stream) {
  const size_t smem = smem_bytes(lq, lk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      field_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  field_attn_fwd_kernel<<<dim3(b, h), fa::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, o, scale, lq, lk, h, dh);
  return static_cast<int>(cudaGetLastError());
}

// The same contract for Lq, Lk <= 32, Dh <= 16 and H <= 8 (the wrapper's
// choice); anything else returns cudaErrorInvalidValue and launches nothing.
int field_attn_fwd_warp(const float* q, const float* k, const float* v, const float* bias,
                        float* o, float scale, int b, int lq, int lk, int h, int dh,
                        void* stream) {
  if (!fa::warp_fits(lq, lk, h, dh)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores where every row starts 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = dh % 4 == 0 && bases % 16 == 0;
  const int rows = fa::warp_rows(h);
  const dim3 grid((b + rows - 1) / rows), block(32 * rows * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // shared memory up to the largest shape the instance takes, set once
  const int most =
      static_cast<int>(warp_smem_floats(fa::WARP_L, fa::WARP_L, fa::WARP_MAX_H, 16) * 4);
#define LAUNCH(DP)                                                                            \
  {                                                                                           \
    static bool ready = false;                                                                \
    if (!ready) {                                                                             \
      const cudaError_t e = cudaFuncSetAttribute(                                             \
          field_attn_fwd_warp_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, most); \
      if (e != cudaSuccess) return static_cast<int>(e);                                       \
      ready = true;                                                                           \
    }                                                                                         \
    const size_t smem = warp_smem_floats(lq, lk, h, DP) * sizeof(float);                      \
    field_attn_fwd_warp_kernel<DP>                                                            \
        <<<grid, block, smem, st>>>(q, k, v, bias, o, scale, b, lq, lk, h, dh, vec);         \
  }
  if (dh <= 8)
    LAUNCH(8)
  else
    LAUNCH(16)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The same contract for Lq, Lk <= 64, Dh <= 16 and H <= 8 (the wrapper
// gives it those shapes past the warp instance's 32 positions); anything
// else returns cudaErrorInvalidValue and launches nothing.
int field_attn_fwd_l64(const float* q, const float* k, const float* v, const float* bias,
                       float* o, float scale, int b, int lq, int lk, int h, int dh,
                       void* stream) {
  if (!fa::l64_fits(lq, lk, h, dh)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores where every row starts 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = dh % 4 == 0 && bases % 16 == 0;
  const int rows = fa::warp_rows(h);
  const dim3 grid((b + rows - 1) / rows), block(32 * rows * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // shared memory up to the largest shape the instance takes, set once
  const int most = static_cast<int>(l64_smem_floats(fa::L64, fa::WARP_MAX_H, 16) * 4);
#define LAUNCH(DP)                                                                           \
  {                                                                                          \
    static bool ready = false;                                                               \
    if (!ready) {                                                                            \
      const cudaError_t e = cudaFuncSetAttribute(                                            \
          field_attn_fwd_l64_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, most); \
      if (e != cudaSuccess) return static_cast<int>(e);                                      \
      ready = true;                                                                          \
    }                                                                                        \
    const size_t smem = l64_smem_floats(lq, h, DP) * sizeof(float);                          \
    field_attn_fwd_l64_kernel<DP>                                                            \
        <<<grid, block, smem, st>>>(q, k, v, bias, o, scale, b, lq, lk, h, dh, vec);        \
  }
  if (dh <= 8)
    LAUNCH(8)
  else
    LAUNCH(16)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The same contract for Lq, Lk <= 64 at any H and Dh of the gate (the
// wrapper gives it those shapes past the warp and L-64 instances' Dh 16
// and H 8); anything else returns cudaErrorInvalidValue and launches
// nothing.
int field_attn_fwd_wide(const float* q, const float* k, const float* v, const float* bias,
                        float* o, float scale, int b, int lq, int lk, int h, int dh,
                        void* stream) {
  if (!fa::wide_fits(lq, lk, h, dh)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies and stores where every row starts 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = dh % 4 == 0 && bases % 16 == 0;
  const long long pairs = static_cast<long long>(b) * h;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // shared memory up to the largest shape the instance takes (the same for
  // both L: 64 / L pairs of L rows), set once
  const int most = static_cast<int>(wide_pair_floats(fa::L64, fa::WIDE_MAX_DH) * 4);
#define LAUNCH(L, SKIP)                                                                       \
  {                                                                                           \
    static bool ready = false;                                                                \
    if (!ready) {                                                                             \
      const cudaError_t e = cudaFuncSetAttribute(                                             \
          field_attn_fwd_wide_kernel<L, SKIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
          most);                                                                              \
      if (e != cudaSuccess) return static_cast<int>(e);                                       \
      ready = true;                                                                           \
    }                                                                                         \
    constexpr int per = fa::WIDE_THREADS / L;                                                 \
    const size_t smem = per * wide_pair_floats(L, dh) * sizeof(float);                        \
    field_attn_fwd_wide_kernel<L, SKIP><<<static_cast<unsigned>((pairs + per - 1) / per),     \
                                    fa::WIDE_THREADS, smem, st>>>(q, k, v, bias, o, scale, b, \
                                                                  lq, lk, h, dh, vec);        \
  }
  // the instance that skips groups of keys past lk only where a whole
  // group is padding: the skips' branches cost the others 5-6% (the header)
  constexpr int G = fa::WIDE_GROUP;
  const int top = lq <= fa::WARP_L && lk <= fa::WARP_L ? fa::WARP_L : fa::L64;
  const bool skip = (lk + G - 1) / G * G < top;
  if (top == fa::WARP_L) {
    if (skip)
      LAUNCH(32, true)
    else
      LAUNCH(32, false)
  } else {
    if (skip)
      LAUNCH(64, true)
    else
      LAUNCH(64, false)
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
