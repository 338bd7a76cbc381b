// Field-attention backward for Hopper (sm_90a), with a plain C interface for
// ctypes: four instances of one contract, chosen by the wrapper from the
// shape (kernels/field_attention.py).
//
// Replaces ml_function_tpu/ops/kernels/field_attention.py::_bwd_kernel
// (launched there by _call with three outputs, from the custom vjp). For each
// batch row b and head h it recomputes the softmax weights a of the forward
// (field_attn_fwd.cu) from q, k and bias, then, with dO the cotangent of o:
//
//   dV = a^T dO,  dA = dO V^T,  dS = a * (dA - rowsum(a * dA)),
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// all f32 FMAs on the CUDA cores, as the reference. a is formed as the plain
// version forms it: the logit times scale, then plus the bias (two
// roundings), expf(s - max) and a division by the sum. The bias gets no
// gradient.
//
// What bounds it on the H100: at AutoInt's shape (B 4096, L 27, H 2, Dh 16)
// it does about 10 * B * H * Lq * Lk * Dh = 955 MFLOP (14 us at 67 TFLOP/s)
// for 99 MB in and out (30 us at 3.35 TB/s): memory bounds it. There the
// warp instance takes 0.103-0.108 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py), against 0.358-0.365 ms for the block instance (the
// kernel it replaced on that shape) and 0.48-0.55 ms for SDPA's f32
// backward, in the same call: 3.5x its bound. What holds it there, by
// inference: a block copies in, computes and copies out with nothing
// overlapped inside it, and shared memory (55 KB a block) keeps 16 warps an
// SM; about 3,700 instructions a (b, h) pair, 30 M in all, would take some
// 30 us at full issue.
//
// field_attn_bwd_warp, for Lq, Lk <= 32, Dh <= 16 and H <= 8 (AutoInt's
// layers, SIM's top-8 ESU): one warp a (b, h). A block takes max(1, 4 / H)
// whole batch rows, all their heads, so that q, k, v and dO of the block are
// contiguous: it copies them into shared memory with coalesced loads (16
// bytes a lane where Dh is a multiple of 4), each (b, l) row padded so that
// lanes reading neighbouring rows hit distinct banks, and Dh padded with
// zeros to DP (8 or 16). In a first pass lane i owns query i: it forms its
// logits with k_j broadcast from shared memory into its own column of a
// (Lk, Lq) matrix a^T, so the row's max, sum and rowsum(a * dA) are sums in
// one lane, in key order, with no shuffles; then dA_i, dS_i (in a second
// matrix) and dQ_i = scale * sum_j dS_ij k_j. In a second pass lane j owns
// key j and forms dV_j and dK_j from row j of a^T and dS^T, with q_i and
// dO_i broadcast. dQ, dK and dV are written into the slots of
// q, k and v and copied out by the block with coalesced stores. Nothing
// depends on another warp between the copies: the serial phases of the
// block kernel are gone.
//
// field_attn_bwd_l64, for the shapes past the warp instance's 32 positions
// up to 64 queries and keys (Dh <= 16, H <= 8: DMIN's refiner, (B 4096,
// L 64, H 2, Dh 8)): one warp a (b, h) in the warp instance's blocks and
// slabs, the key slabs padded to 64 rows as the forward's. At DMIN's shape
// the work is 2.68 GFLOP (40 us at 67 TFLOP/s) for 118 MB (35 us at 3.35
// TB/s); the block instance took 24x that, five phases a block behind
// barriers, two (64, 64) matrices in shared memory and three products each
// making two loads an FMA. Here no (Lq, Lk) matrix exists, as in the flash
// kernels' backward: in pass 1 a lane on query i (then i + 32) keeps its
// 64 logits, then weights, in registers, forms rowsum(a * dA) and dQ_i =
// scale * sum_j a_ij (dA_ij - rowsum) k_j, and leaves three statistics of
// the query (max, 1 / sum, rowsum) in shared memory; in pass 2 a lane on
// key j (then j + 32) recomputes a_ij and dS_ij from q_i, dO_i and those
// statistics with the same operations (so the same bits as pass 1) and
// sums dV_j and dK_j over the queries. The weights are e * (1 / sum): the
// backward is held to the plain version's tolerance, not its bits. A warp
// waits on no other warp between the block's two barriers (copy-in,
// copy-out). Registers bound it: pass 1 holds 64 weights and the rows in
// flight around them, so a thread may take 255 registers and an SM holds
// two 128-thread blocks at DMIN's shape; under a cap of 128 the compiler
// spilled kilobytes a thread.
//
// field_attn_bwd_wide, for every other shape up to 64 queries and keys (Dh
// 17 to 64, or H past 8): the wide forward's pairs, staged rows (q, dO, k,
// v) and 16-column chunks, and the L-64 backward's two passes. In pass 1 a
// lane on query i keeps its L logits (then weights) and dA_ij (then dS_ij)
// in registers, forms dQ_i and leaves (max, 1 / sum, rowsum) in shared
// memory; after the block's one barrier a lane on key j recomputes a_ij
// and dS_ij for every query with the same operations (so the same bits)
// and forms dV_j and then dK_j. Each loop over d forms one product, so a
// lane holds L sums and one chunk at a time (no spill at L 64); a second
// template instance skips the groups of 8 padded keys or queries, as the
// forward's, whose branches cost 3-5% where nothing is skipped (at
// AutoInt's shape 0.2312-0.2321 against 0.2220-0.2237 ms on the device, at
// the gate's edge 0.3766-0.3773 against 0.3573-0.3586, in turns on one
// NVIDIA H100 80GB HBM3 at 700 W). At AutoInt's (4096, 27, 27, 2, 32) the work is 1.9 GFLOP for
// 199 MB (59 us at 3.35 TB/s); it takes 0.217-0.224 ms on the device
// (0.231-0.239 by events) on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/field_attn_instances.py, chip_smoke.py), against 0.55 for the
// block instance and 0.54-0.74 for SDPA's f32 backward: 3.7x its bound.
// What holds it, by inference (no hardware counter was read): 141
// registers a thread and 38 KB of shared memory a block of two pairs keep
// 10 warps an SM, each lane's sums chains of dependent FMAs, about a third
// of the issue rate. At the gate's (512, 64, 64, 2, 64) a thread takes 254
// registers and a pair 71 KB: 6 warps an SM, 0.33-0.36 ms on the device,
// 8-9x its 0.0401 ms bound.
//
// field_attn_bwd, for every other shape inside the gate (Lq * Lk <= 4096,
// Dh <= 64): one block of 128 threads per (b, h). The weights a and the
// cotangent dA (then dS, in place) are two (Lq, Lk) matrices held whole in
// shared memory, 32 KB at most under the gate; row tiles of q and k, then of
// dO and v, are staged for the two Gram products, and the three products
// with a or dS read their right-hand rows through L1. It runs five serial
// phases a block, each issue-bound on loads and index arithmetic around its
// FMAs.
//
// Neither a nor dS reaches device memory in any instance; each block
// writes its own rows of dQ, dK and dV: no atomics, and the same inputs give
// the same bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "field_attn.cuh"

namespace {

// ---- field_attn_bwd_warp: one warp a (b, h) ----

using fa::load_row;
using fa::mat_ld;
using fa::slab_out;
using fa::slab_stride;
using fa::slabs_in;
using fa::store_row;
using fa::warp_rows;
using fa::WARP_L;
using fa::WARP_MAX_H;

// Floats of shared memory: the slabs of q and dO (Lq rows), k and v (Lk
// rows), the bias (rounded up to 4 floats) and each warp's a^T and dS^T.
size_t warp_smem_floats(int lq, int lk, int h, int dp) {
  const size_t nb = warp_rows(h), s = slab_stride(h, dp);
  return nb * (2 * lq + 2 * lk) * s + (nb * lk + 3) / 4 * 4 + nb * h * 2 * lk * mat_ld(lq);
}

template <int DP>
__global__ void __launch_bounds__(32 * WARP_MAX_H, 2)
    field_attn_bwd_warp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const float* __restrict__ dout, float* __restrict__ dq,
                               float* __restrict__ dk, float* __restrict__ dv, float scale,
                               int nbatch, int lq, int lk, int h, int dh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int rows = warp_rows(h), s = slab_stride(h, DP), ld = mat_ld(lq);
  const int b0 = blockIdx.x * rows, nb = min(rows, nbatch - b0);
  float* qs = smem;                    // (rows, lq) rows of H heads: q, then dQ
  float* dos = qs + rows * lq * s;     // dO
  float* ks = dos + rows * lq * s;     // (rows, lk): k, then dK
  float* vs = ks + rows * lk * s;      // v, then dV
  float* bs = vs + rows * lk * s;      // (rows, lk) bias
  float* mats = bs + (rows * lk + 3) / 4 * 4;   // a^T and dS^T of each warp, (lk, ld)
  const size_t qoff = size_t(b0) * lq * h * dh, koff = size_t(b0) * lk * h * dh;
  if (vec) {
    slabs_in<DP, true>(qs, dos, q + qoff, dout + qoff, nb, lq, h, dh);
    slabs_in<DP, true>(ks, vs, k + koff, v + koff, nb, lk, h, dh);
  } else {
    slabs_in<DP, false>(qs, dos, q + qoff, dout + qoff, nb, lq, h, dh);
    slabs_in<DP, false>(ks, vs, k + koff, v + koff, nb, lk, h, dh);
  }
  for (int e = threadIdx.x; e < nb * lk; e += blockDim.x) bs[e] = bias[size_t(b0) * lk + e];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bl = warp / h, hh = warp % h;
  if (bl < nb) {
    float* qh = qs + bl * lq * s + hh * DP;    // query i at qh + i * s
    const float* doh = dos + bl * lq * s + hh * DP;
    float* kh = ks + bl * lk * s + hh * DP;    // key j at kh + j * s
    float* vh = vs + bl * lk * s + hh * DP;
    const float* bh = bs + bl * lk;
    float* at = mats + warp * 2 * lk * ld;     // a^T: (key j, query i) at j * ld + i
    float* dst = at + lk * ld;                 // dA^T, then dS^T
    const bool query = lane < lq, key = lane < lk;

    // pass 1, lane i on query i: its softmax row in a^T's column i, so the
    // row's max, sum and rowsum(a * dA) are sums in one lane, in key order,
    // with no shuffles; then dA_i, dS_i and dQ_i
    float dqa[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) dqa[c] = 0.f;
    if (query) {
      float x[DP], y[DP];
      float* ai = at + lane;     // a_ij at ai[j * ld]
      float* di = dst + lane;    // dA_ij, then dS_ij
      load_row<DP>(x, qh + lane * s);
      float m = -CUDART_INF_F;
#pragma unroll 4
      for (int j = 0; j < lk; ++j) {
        load_row<DP>(y, kh + j * s);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(x[c], y[c], d);
        const float lg = __fadd_rn(__fmul_rn(d, scale), bh[j]);
        ai[j * ld] = lg;
        m = fmaxf(m, lg);
      }
      float sum = 0.f;
#pragma unroll 4
      for (int j = 0; j < lk; ++j) {
        const float e = expf(ai[j * ld] - m);
        ai[j * ld] = e;
        sum += e;
      }
      float rs = 0.f;
      load_row<DP>(x, doh + lane * s);
#pragma unroll 4
      for (int j = 0; j < lk; ++j) {
        const float a = ai[j * ld] / sum;
        load_row<DP>(y, vh + j * s);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(x[c], y[c], d);
        ai[j * ld] = a;
        di[j * ld] = d;
        rs += a * d;
      }
#pragma unroll 4
      for (int j = 0; j < lk; ++j) {
        const float ds = ai[j * ld] * (di[j * ld] - rs);
        di[j * ld] = ds;
        load_row<DP>(y, kh + j * s);
#pragma unroll
        for (int c = 0; c < DP; ++c) dqa[c] = fmaf(ds, y[c], dqa[c]);
      }
    }
    __syncwarp();

    // pass 2, lane j on key j: dV_j = sum_i a_ij dO_i, dK_j = scale sum_i dS_ij q_i
    float dka[DP], dva[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) dka[c] = dva[c] = 0.f;
    for (int i = 0; i < lq; ++i) {
      const float wa = key ? at[lane * ld + i] : 0.f, wd = key ? dst[lane * ld + i] : 0.f;
      float qi[DP], di[DP];
      load_row<DP>(qi, qh + i * s);
      load_row<DP>(di, doh + i * s);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dva[c] = fmaf(wa, di[c], dva[c]);
        dka[c] = fmaf(wd, qi[c], dka[c]);
      }
    }
    __syncwarp();   // every lane has read the q rows that dQ replaces
    if (query) store_row<DP>(qh + lane * s, dqa, scale);
    if (key) {
      store_row<DP>(kh + lane * s, dka, scale);
      store_row<DP>(vh + lane * s, dva, 1.f);
    }
  }
  __syncthreads();
  if (vec) {
    slab_out<DP, true>(dq + qoff, qs, nb, lq, h, dh);
    slab_out<DP, true>(dk + koff, ks, nb, lk, h, dh);
    slab_out<DP, true>(dv + koff, vs, nb, lk, h, dh);
  } else {
    slab_out<DP, false>(dq + qoff, qs, nb, lq, h, dh);
    slab_out<DP, false>(dk + koff, ks, nb, lk, h, dh);
    slab_out<DP, false>(dv + koff, vs, nb, lk, h, dh);
  }
}

// ---- field_attn_bwd_l64: one warp a (b, h), up to 64 queries and keys ----

// Floats of shared memory: the slabs of q, dO and dQ (Lq rows), the padded
// slabs of k and v (L64 rows a batch row), the padded bias and each warp's
// per-query statistics (max, 1 / sum, rowsum(a * dA), one float4 a query).
size_t l64_smem_floats(int lq, int h, int dp) {
  const size_t nb = warp_rows(h), s = slab_stride(h, dp);
  return nb * (3 * lq + 2 * fa::L64) * s + nb * fa::L64 + nb * h * lq * 4;
}

// Up to 255 registers a thread: pass 1's 64 weights and the rows in flight
// around them spilled kilobytes under the 128 of two 256-thread blocks.
template <int DP>
__global__ void __launch_bounds__(32 * WARP_MAX_H, 1)
    field_attn_bwd_l64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              const float* __restrict__ dout, float* __restrict__ dq,
                              float* __restrict__ dk, float* __restrict__ dv, float scale,
                              int nbatch, int lq, int lk, int h, int dh, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int rows = warp_rows(h), s = slab_stride(h, DP);
  const int b0 = blockIdx.x * rows, nb = min(rows, nbatch - b0);
  float* qs = smem;                      // (rows, lq) rows of H heads: q
  float* dos = qs + rows * lq * s;       // dO
  float* dqs = dos + rows * lq * s;      // dQ
  float* ks = dqs + rows * lq * s;       // (rows, L64): k, zero past lk, then dK
  float* vs = ks + rows * fa::L64 * s;   // v, then dV
  float* bs = vs + rows * fa::L64 * s;   // (rows, L64) bias, -inf past lk
  float4* stats = reinterpret_cast<float4*>(bs + rows * fa::L64);   // (warps, lq)
  const size_t qoff = size_t(b0) * lq * h * dh, koff = size_t(b0) * lk * h * dh;
  if (vec) {
    slabs_in<DP, true>(qs, dos, q + qoff, dout + qoff, nb, lq, h, dh);
    fa::l64_keys_in<DP, true>(ks, vs, bs, k + koff, v + koff, bias + size_t(b0) * lk, nb, lk,
                              h, dh);
  } else {
    slabs_in<DP, false>(qs, dos, q + qoff, dout + qoff, nb, lq, h, dh);
    fa::l64_keys_in<DP, false>(ks, vs, bs, k + koff, v + koff, bias + size_t(b0) * lk, nb, lk,
                               h, dh);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bl = warp / h, hh = warp % h;
  if (bl < nb) {
    const float* qh = qs + bl * lq * s + hh * DP;   // query i at qh + i * s
    const float* doh = dos + bl * lq * s + hh * DP;
    float* dqh = dqs + bl * lq * s + hh * DP;
    float* kh = ks + bl * fa::L64 * s + hh * DP;    // key j at kh + j * s
    float* vh = vs + bl * fa::L64 * s + hh * DP;
    const float* bh = bs + bl * fa::L64;
    float4* st = stats + warp * lq;                 // query i's statistics at st[i]

    // pass 1, lane on query i (then i + 32): its weights a_ij in registers,
    // rowsum(a * dA) and dQ_i = scale * sum_j a_ij (dA_ij - rowsum) k_j;
    // the max, 1 / sum and the rowsum to st[i] for pass 2
#pragma unroll 1
    for (int i = lane; i < lq; i += 32) {
      float a[fa::L64];   // the exponentials, then the weights
      float x[DP], y[DP];
      load_row<DP>(x, qh + i * s);
      const float m = fa::exps64<DP>(a, x, kh, s, bh, scale);
      const float inv = __frcp_rn(fa::softmax_sum64(a));
#pragma unroll
      for (int j = 0; j < fa::L64; ++j) a[j] *= inv;
      load_row<DP>(x, doh + i * s);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < fa::L64; ++j) {
        load_row<DP>(y, vh + j * s);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(x[c], y[c], d);
        rs = fmaf(a[j], d, rs);
      }
      // the loop below reads the rows of v again rather than keep its 64
      // dA_ij live from the loop above (the compiler would, and spill them)
      asm volatile("" ::: "memory");
      float dqa[DP];
#pragma unroll
      for (int c = 0; c < DP; ++c) dqa[c] = 0.f;
#pragma unroll
      for (int j = 0; j < fa::L64; ++j) {   // dA_ij again, with the same bits
        load_row<DP>(y, vh + j * s);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(x[c], y[c], d);
        const float ds = a[j] * (d - rs);
        load_row<DP>(y, kh + j * s);
#pragma unroll
        for (int c = 0; c < DP; ++c) dqa[c] = fmaf(ds, y[c], dqa[c]);
      }
      store_row<DP>(dqh + i * s, dqa, scale);
      st[i] = make_float4(m, inv, rs, 0.f);
    }
    __syncwarp();

    // pass 2, lane on key j (then j + 32): a_ij and dS_ij recomputed from
    // q_i, dO_i and st[i] (the same operations as pass 1, so the same bits),
    // dV_j = sum_i a_ij dO_i and dK_j = scale * sum_i dS_ij q_i
#pragma unroll 1
    for (int j = lane; j < lk; j += 32) {
      float kj[DP], vj[DP], dka[DP], dva[DP];
      load_row<DP>(kj, kh + j * s);
      load_row<DP>(vj, vh + j * s);
      const float bj = bh[j];
#pragma unroll
      for (int c = 0; c < DP; ++c) dka[c] = dva[c] = 0.f;
#pragma unroll 2
      for (int i = 0; i < lq; ++i) {
        const float4 sti = st[i];
        float x[DP], y[DP];
        load_row<DP>(x, qh + i * s);
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(x[c], kj[c], d);
        const float a = expf(__fadd_rn(__fmul_rn(d, scale), bj) - sti.x) * sti.y;
        load_row<DP>(y, doh + i * s);
        d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) d = fmaf(y[c], vj[c], d);
        const float ds = a * (d - sti.z);
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          dva[c] = fmaf(a, y[c], dva[c]);
          dka[c] = fmaf(ds, x[c], dka[c]);
        }
      }
      store_row<DP>(kh + j * s, dka, scale);   // only this lane reads k_j, v_j in pass 2
      store_row<DP>(vh + j * s, dva, 1.f);
    }
  }
  __syncthreads();
  if (vec) {
    slab_out<DP, true>(dq + qoff, dqs, nb, lq, h, dh);
    fa::l64_keys_out<DP, true>(dk + koff, ks, nb, lk, h, dh);
    fa::l64_keys_out<DP, true>(dv + koff, vs, nb, lk, h, dh);
  } else {
    slab_out<DP, false>(dq + qoff, dqs, nb, lq, h, dh);
    fa::l64_keys_out<DP, false>(dk + koff, ks, nb, lk, h, dh);
    fa::l64_keys_out<DP, false>(dv + koff, vs, nb, lk, h, dh);
  }
}

// ---- field_attn_bwd_wide: one warp a (b, h) and 32 queries or keys, any H and Dh ----

// Floats of shared memory of one (b, h): L staged rows each of q, dO, k and
// v, the bias (L floats, -inf past lk) and each query's statistics (max,
// 1 / sum, rowsum(a * dA), one float4 a query).
__host__ __device__ size_t wide_pair_floats(int l, int dh) {
  return size_t(4 * l) * fa::wide_stride(dh) + l + 4 * l;
}

template <int L, bool SKIP>
__global__ void __launch_bounds__(fa::WIDE_THREADS)
    field_attn_bwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const float* __restrict__ dout, float* __restrict__ dq,
                               float* __restrict__ dk, float* __restrict__ dv, float scale,
                               int nbatch, int lq, int lk, int h, int dh, bool vec) {
  constexpr int PAIRS = fa::WIDE_THREADS / L;   // (b, h) pairs a block, L threads each
  constexpr int CW = fa::WIDE_CHUNK, G = fa::WIDE_GROUP;
  extern __shared__ __align__(16) float smem[];
  const int s = fa::wide_stride(dh), cols = s - 4, stride = h * dh;
  const int slot = threadIdx.x / L, t = threadIdx.x % L;
  const long long pair = static_cast<long long>(blockIdx.x) * PAIRS + slot;
  const bool live = pair < static_cast<long long>(nbatch) * h;
  const int b = live ? static_cast<int>(pair / h) : 0, hh = live ? static_cast<int>(pair % h) : 0;
  float* qs = smem + slot * wide_pair_floats(L, dh);   // L rows: q, zero past lq
  float* dos = qs + L * s;                             // dO, zero past lq
  float* ks = dos + L * s;                             // k, zero past lk
  float* vs = ks + L * s;                              // v, zero past lk
  float* bs = vs + L * s;                              // bias, -inf past lk
  float4* st = reinterpret_cast<float4*>(bs + L);      // query i's statistics at st[i]
  const size_t qoff = (size_t(b) * lq * h + hh) * dh, koff = (size_t(b) * lk * h + hh) * dh;
  if (live) {
    fa::wide_rows_in<L>(qs, q + qoff, lq, stride, dh, s, t, vec);
    fa::wide_rows_in<L>(dos, dout + qoff, lq, stride, dh, s, t, vec);
    fa::wide_rows_in<L>(ks, k + koff, lk, stride, dh, s, t, vec);
    fa::wide_rows_in<L>(vs, v + koff, lk, stride, dh, s, t, vec);
    bs[t] = t < lk ? bias[size_t(b) * lk + t] : -CUDART_INF_F;
  }
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  // pass 1, lane on query i (a zero row past lq): its logits, then dA_ij =
  // dO_i . v_j, in registers, each the FMAs over d in order, a chunk of q_i
  // (then dO_i) at a time against k_j (then v_j) broadcast; the weights a =
  // e * (1 / sum), rowsum(a * dA), dS_ij = a_ij (dA_ij - rowsum) in place of
  // dA, dQ_i = scale * sum_j dS_ij k_j, and the statistics to st[i]. Keys
  // past lk, a group of G at a time, add nothing and are skipped.
  {
    const int i = t;
    float a[L], d[L];   // the logits, exponentials, then weights; dA, then dS
#pragma unroll
    for (int j = 0; j < L; ++j) a[j] = d[j] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < cols; c0 += CW) {
      float x[CW];
      fa::load_row<CW>(x, qs + i * s + c0);
#pragma unroll
      for (int j0 = 0; j0 < L; j0 += G)
        if (!SKIP || j0 < lk) fa::wide_dots<L>(a, j0, x, ks + c0, s);
    }
#pragma unroll 1
    for (int c0 = 0; c0 < cols; c0 += CW) {
      float y[CW];
      fa::load_row<CW>(y, dos + i * s + c0);
#pragma unroll
      for (int j0 = 0; j0 < L; j0 += G)
        if (!SKIP || j0 < lk) fa::wide_dots<L>(d, j0, y, vs + c0, s);
    }
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      a[j] = __fadd_rn(__fmul_rn(a[j], scale), bs[j]);
      m = fmaxf(m, a[j]);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) a[j] = expf(a[j] - m);
    const float inv = __frcp_rn(fa::wide_sum<L>(a));
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      a[j] *= inv;
      rs = fmaf(a[j], d[j], rs);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) d[j] = a[j] * (d[j] - rs);
    if (live && i < lq) {
      float* dqi = dq + qoff + size_t(i) * stride;
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
              float r[CW];
              fa::load_row<CW>(r, ks + j * s + c0);
#pragma unroll
              for (int c = 0; c < CW; ++c) acc[c] = fmaf(d[j], r[c], acc[c]);
            }
          }
        }
        fa::wide_store(dqi, acc, c0, dh, scale, vec);
      }
    }
    st[i] = make_float4(m, inv, rs, 0.f);
  }
  __syncthreads();

  // pass 2, lane on key j (a zero row past lk, whose bias is -inf): a_ij
  // and dS_ij recomputed for every query from q_i, dO_i and st[i] with the
  // same operations as pass 1 (so the same bits), in registers; dV_j =
  // sum_i a_ij dO_i and dK_j = scale * sum_i dS_ij q_i, a chunk of columns
  // at a time. Queries past lq (zero rows, which would add exact zeros), a
  // group of G at a time, are skipped.
  {
    const int j = t;
    float a[L], d[L];   // the logits, then weights; dA, then dS (by query)
#pragma unroll
    for (int i = 0; i < L; ++i) a[i] = d[i] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < cols; c0 += CW) {
      float kj[CW];
      fa::load_row<CW>(kj, ks + j * s + c0);
#pragma unroll
      for (int i0 = 0; i0 < L; i0 += G)
        if (!SKIP || i0 < lq) fa::wide_dots<L>(a, i0, kj, qs + c0, s);   // fmaf(k, q) = fmaf(q, k)
    }
#pragma unroll 1
    for (int c0 = 0; c0 < cols; c0 += CW) {
      float vj[CW];
      fa::load_row<CW>(vj, vs + j * s + c0);
#pragma unroll
      for (int i0 = 0; i0 < L; i0 += G)
        if (!SKIP || i0 < lq) fa::wide_dots<L>(d, i0, vj, dos + c0, s);
    }
    const float bj = bs[j];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float4 sti = st[i];
      a[i] = expf(__fadd_rn(__fmul_rn(a[i], scale), bj) - sti.x) * sti.y;
      d[i] = a[i] * (d[i] - sti.z);
    }
    if (live && j < lk) {
      float* dkj = dk + koff + size_t(j) * stride;
      float* dvj = dv + koff + size_t(j) * stride;
#pragma unroll 1
      for (int c0 = 0; c0 < cols; c0 += CW) {
        float acc[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[c] = 0.f;
#pragma unroll
        for (int i0 = 0; i0 < L; i0 += G) {
          if (!SKIP || i0 < lq) {
#pragma unroll
            for (int i = i0; i < i0 + G; ++i) {
              float r[CW];
              fa::load_row<CW>(r, dos + i * s + c0);
#pragma unroll
              for (int c = 0; c < CW; ++c) acc[c] = fmaf(a[i], r[c], acc[c]);
            }
          }
        }
        fa::wide_store(dvj, acc, c0, dh, 1.f, vec);
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[c] = 0.f;
#pragma unroll
        for (int i0 = 0; i0 < L; i0 += G) {
          if (!SKIP || i0 < lq) {
#pragma unroll
            for (int i = i0; i < i0 + G; ++i) {
              float r[CW];
              fa::load_row<CW>(r, qs + i * s + c0);
#pragma unroll
              for (int c = 0; c < CW; ++c) acc[c] = fmaf(d[i], r[c], acc[c]);
            }
          }
        }
        fa::wide_store(dkj, acc, c0, dh, scale, vec);
      }
    }
  }
}

// ---- field_attn_bwd: one block a (b, h) ----

// dS = a * (dA - rowsum(a * dA)) in place of dA, one warp a row.
__device__ void ds_rows(const float* a, float* da, int nr, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nr; r += fa::WARPS) {
    const float* ar = a + size_t(r) * nc;
    float* dr = da + size_t(r) * nc;
    float dot = 0.f;
    for (int j = lane; j < nc; j += 32) dot += ar[j] * dr[j];
    dot = fa::warp_sum(dot);
    for (int j = lane; j < nc; j += 32) dr[j] = ar[j] * (dr[j] - dot);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(fa::THREADS)
    field_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ dout, float* __restrict__ dq,
                          float* __restrict__ dk, float* __restrict__ dv, float scale, int lq,
                          int lk, int nh, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, stride = nh * dh;
  float* a = smem;                    // (lq, lk) weights
  float* ds = a + lq * lk;            // (lq, lk) dA, then dS
  float* xs = ds + lq * lk;           // query-side row tile
  float* ys = xs + (lq < fa::TILE ? lq : fa::TILE) * (dh + 1);  // key-side row tile
  const size_t qoff = (size_t(b) * lq * nh + h) * dh;
  const size_t koff = (size_t(b) * lk * nh + h) * dh;

  fa::gram<true>(q + qoff, lq, k + koff, lk, dh, stride, xs, ys, a, scale,
                 bias + size_t(b) * lk);
  fa::softmax_rows(a, lq, lk);
  fa::gram<false>(dout + qoff, lq, v + koff, lk, dh, stride, xs, ys, ds, 1.f, nullptr);
  ds_rows(a, ds, lq, lk);
  fa::apply<true>(a, lk, lk, lq, dout + qoff, dv + koff, dh, stride, 1.f);
  fa::apply<false>(ds, lk, lq, lk, k + koff, dq + qoff, dh, stride, scale);
  fa::apply<true>(ds, lk, lk, lq, q + qoff, dk + koff, dh, stride, scale);
}

size_t smem_bytes(int lq, int lk, int dh) {
  return (2 * size_t(lq) * lk + fa::tile_floats(lq, lk, dh)) * sizeof(float);
}

}  // namespace

extern "C" {

// q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), bias (B, Lk), dout (B, Lq, H, Dh) f32
// -> dq, dk, dv in the layouts of q, k, v, f32, all contiguous on the current
// device; Lq * Lk <= 4096, Dh <= 64. Returns the CUDA error code of the
// launch (0 on success).
int field_attn_bwd(const float* q, const float* k, const float* v, const float* bias,
                   const float* dout, float* dq, float* dk, float* dv, float scale, int b, int lq,
                   int lk, int h, int dh, void* stream) {
  const size_t smem = smem_bytes(lq, lk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      field_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  field_attn_bwd_kernel<<<dim3(b, h), fa::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, dout, dq, dk, dv, scale, lq, lk, h, dh);
  return static_cast<int>(cudaGetLastError());
}

// The same contract for Lq, Lk <= 32, Dh <= 16 and H <= 8 (the wrapper's
// choice); anything else returns cudaErrorInvalidValue and launches nothing.
int field_attn_bwd_warp(const float* q, const float* k, const float* v, const float* bias,
                        const float* dout, float* dq, float* dk, float* dv, float scale, int b,
                        int lq, int lk, int h, int dh, void* stream) {
  if (!fa::warp_fits(lq, lk, h, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores where every row starts 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                          reinterpret_cast<uintptr_t>(dv);
  const bool vec = dh % 4 == 0 && bases % 16 == 0;
  const int rows = warp_rows(h);
  const dim3 grid((b + rows - 1) / rows), block(32 * rows * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // shared memory up to the largest shape the instance takes, set once
  const int most = static_cast<int>(warp_smem_floats(WARP_L, WARP_L, WARP_MAX_H, 16) * 4);
#define LAUNCH(DP)                                                                            \
  {                                                                                           \
    static bool ready = false;                                                                \
    if (!ready) {                                                                             \
      const cudaError_t e = cudaFuncSetAttribute(                                             \
          field_attn_bwd_warp_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, most); \
      if (e != cudaSuccess) return static_cast<int>(e);                                       \
      ready = true;                                                                           \
    }                                                                                         \
    const size_t smem = warp_smem_floats(lq, lk, h, DP) * sizeof(float);                      \
    field_attn_bwd_warp_kernel<DP><<<grid, block, smem, st>>>(q, k, v, bias, dout, dq, dk,    \
                                                              dv, scale, b, lq, lk, h, dh,    \
                                                              vec);                           \
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
int field_attn_bwd_l64(const float* q, const float* k, const float* v, const float* bias,
                       const float* dout, float* dq, float* dk, float* dv, float scale, int b,
                       int lq, int lk, int h, int dh, void* stream) {
  if (!fa::l64_fits(lq, lk, h, dh)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores where every row starts 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                          reinterpret_cast<uintptr_t>(dv);
  const bool vec = dh % 4 == 0 && bases % 16 == 0;
  const int rows = warp_rows(h);
  const dim3 grid((b + rows - 1) / rows), block(32 * rows * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // shared memory up to the largest shape the instance takes, set once
  const int most = static_cast<int>(l64_smem_floats(fa::L64, WARP_MAX_H, 16) * 4);
#define LAUNCH(DP)                                                                           \
  {                                                                                          \
    static bool ready = false;                                                               \
    if (!ready) {                                                                            \
      const cudaError_t e = cudaFuncSetAttribute(                                            \
          field_attn_bwd_l64_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, most); \
      if (e != cudaSuccess) return static_cast<int>(e);                                      \
      ready = true;                                                                          \
    }                                                                                        \
    const size_t smem = l64_smem_floats(lq, h, DP) * sizeof(float);                          \
    field_attn_bwd_l64_kernel<DP><<<grid, block, smem, st>>>(q, k, v, bias, dout, dq, dk,    \
                                                             dv, scale, b, lq, lk, h, dh,    \
                                                             vec);                           \
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
int field_attn_bwd_wide(const float* q, const float* k, const float* v, const float* bias,
                        const float* dout, float* dq, float* dk, float* dv, float scale, int b,
                        int lq, int lk, int h, int dh, void* stream) {
  if (!fa::wide_fits(lq, lk, h, dh)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies and stores where every row starts 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                          reinterpret_cast<uintptr_t>(dv);
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
          field_attn_bwd_wide_kernel<L, SKIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
          most);                                                                              \
      if (e != cudaSuccess) return static_cast<int>(e);                                       \
      ready = true;                                                                           \
    }                                                                                         \
    constexpr int per = fa::WIDE_THREADS / L;                                                 \
    const size_t smem = per * wide_pair_floats(L, dh) * sizeof(float);                        \
    field_attn_bwd_wide_kernel<L, SKIP><<<static_cast<unsigned>((pairs + per - 1) / per),     \
                                    fa::WIDE_THREADS, smem, st>>>(                            \
        q, k, v, bias, dout, dq, dk, dv, scale, b, lq, lk, h, dh, vec);                       \
  }
  // the instance that skips groups of keys (queries) past lk (lq) only
  // where a whole group is padding: the skips' branches cost the others 3-5%
  // (the header)
  constexpr int G = fa::WIDE_GROUP;
  const int top = lq <= fa::WARP_L && lk <= fa::WARP_L ? fa::WARP_L : fa::L64;
  const bool skip = (lk + G - 1) / G * G < top || (lq + G - 1) / G * G < top;
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
