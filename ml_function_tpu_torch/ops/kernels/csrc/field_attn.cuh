// Pieces shared by the field-attention kernels (field_attn_fwd.cu,
// field_attn_bwd.cu): first those of the block instances, then those of the
// warp instances, then those of the L-64 instances, then those of the wide
// instances.
//
// Block instances: one block of THREADS threads works on one (batch row b,
// head h): the rows of q, k, v, dO for that pair are the Dh contiguous floats
// at ((b * L + i) * H + h) * Dh, one row every H * Dh floats (the (B, L, H, Dh)
// layout of the projections, read in place with no transpose).
//
// The (Lq, Lk) matrices (scores, weights, their cotangents) live whole in
// shared memory: the gate Lq * Lk <= 4096 bounds each at 16 KB. Rows of q, k,
// v are staged in tiles of at most TILE rows, so Lk = 4096 keys (1 MB of K and
// V at Dh = 64) stream through a fixed amount of shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace fa {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;  // rows of q, k, v or dO staged at a time

// Floats of shared memory for the staged row tiles; a tile row is Dh + 1
// floats, so threads reading one column of different rows hit distinct banks.
__host__ __device__ inline int tile_floats(int lq, int lk, int dh) {
  const int tq = lq < TILE ? lq : TILE, tk = lk < TILE ? lk : TILE;
  return (tq + tk) * (dh + 1);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[r * (dh + 1) + c] = src[r * stride + c] for r < n, c < dh.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int n,
                                           int dh, int stride) {
  for (int e = threadIdx.x; e < n * dh; e += THREADS) {
    const int r = e / dh, c = e - r * dh;
    dst[r * (dh + 1) + c] = src[size_t(r) * stride + c];
  }
}

// out[i * ny + j] = sum_d x[i, d] * y[j, d] for i < nx, j < ny; with kScores,
// then times scale, then plus bias[j], two roundings as the reference forms
// the logits (an FMA here would round the -1e9 of a masked key differently).
// xs and ys are the tile buffers. Ends with the block synchronised.
template <bool kScores>
__device__ void gram(const float* __restrict__ x, int nx, const float* __restrict__ y, int ny,
                     int dh, int stride, float* xs, float* ys, float* out, float scale,
                     const float* __restrict__ bias) {
  const int dhp = dh + 1;
  for (int x0 = 0; x0 < nx; x0 += TILE) {
    const int mx = min(TILE, nx - x0);
    for (int y0 = 0; y0 < ny; y0 += TILE) {
      const int my = min(TILE, ny - y0);
      __syncthreads();  // every read of the tiles' last contents is done
      if (y0 == 0) stage_rows(xs, x + size_t(x0) * stride, mx, dh, stride);
      stage_rows(ys, y + size_t(y0) * stride, my, dh, stride);
      __syncthreads();
      for (int e = threadIdx.x; e < mx * my; e += THREADS) {
        const int i = e / my, j = e - i * my;
        const float* xr = xs + i * dhp;
        const float* yr = ys + j * dhp;
        float s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(xr[d], yr[d], s);
        if (kScores) s = __fadd_rn(__fmul_rn(s, scale), bias[y0 + j]);
        out[size_t(x0 + i) * ny + y0 + j] = s;
      }
    }
  }
  __syncthreads();
}

// Each row of p (nr rows of nc) becomes its softmax, max subtracted: one warp
// a row. Ends with the block synchronised.
__device__ void softmax_rows(float* p, int nr, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nr; r += WARPS) {
    float* row = p + size_t(r) * nc;
    float m = -CUDART_INF_F;
    for (int j = lane; j < nc; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nc; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < nc; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();
}

// out[r, d] = scale * sum_c M(r, c) * y[c, d] for r < nr, d < dh, where
// M(r, c) = m[r * ld + c], or m[c * ld + r] with kTrans. M is in shared
// memory; the rows of y are read from device memory (and L1), neighbouring
// threads on neighbouring d; out is written in the (B, L, H, Dh) layout.
template <bool kTrans>
__device__ void apply(const float* m, int ld, int nr, int nc, const float* __restrict__ y,
                      float* __restrict__ out, int dh, int stride, float scale) {
  for (int e = threadIdx.x; e < nr * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh;
    const float* yc = y + d;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const float w = kTrans ? m[size_t(c) * ld + r] : m[size_t(r) * ld + c];
      acc = fmaf(w, __ldg(yc + size_t(c) * stride), acc);
    }
    out[size_t(r) * stride + d] = acc * scale;
  }
}

// ---- warp instances: one warp a (b, h) ----
//
// A block takes warp_rows(h) whole batch rows with all their heads, so that
// its rows of q, k, v (and dO) are contiguous: it copies them into shared
// memory with coalesced loads (slabs_in), each (b, l) row padded to
// slab_stride(h, DP) floats and each head's row to DP (8 or 16) floats with
// zeros; a warp then works on one (b, h) with a lane a query (or a key), rows
// read as 16-byte broadcasts (load_row), and writes its results into the
// slots of its inputs for the block to copy out (slab_out).

constexpr int WARP_L = 32;       // queries or keys a warp takes, one a lane
constexpr int WARP_PAIRS = 4;    // (b, h) pairs a block takes where H < 4
constexpr int WARP_MAX_H = 8;    // so a block has at most 8 warps
constexpr int WARP_MAX_DH = 16;  // a row of q, k or v in a lane's registers

// The shapes the warp instances take (the wrappers choose by the same
// limits: field_attention.py).
__host__ __device__ inline bool warp_fits(int lq, int lk, int h, int dh) {
  return lq <= WARP_L && lk <= WARP_L && dh <= WARP_MAX_DH && h <= WARP_MAX_H;
}

// Floats of one (b, l) row of a staged slab: H heads of DP floats and 4
// more, so that the 16-byte loads of 8 lanes reading 8 neighbouring rows hit
// 32 distinct banks (DP is a multiple of 8, so the stride / 4 is odd).
__host__ __device__ inline int slab_stride(int h, int dp) { return h * dp + 4; }

// Batch rows of one block.
__host__ __device__ inline int warp_rows(int h) { return h < WARP_PAIRS ? WARP_PAIRS / h : 1; }

// Row stride of a warp's (Lk, Lq) matrices (the forward's logits, the
// backward's a^T and dS^T): odd, so that lanes reading one column each
// (lane j, row j) hit distinct banks.
__host__ __device__ inline int mat_ld(int lq) { return lq | 1; }

// The column of a slab that thread threadIdx.x copies, at every step of
// rows: 16 bytes (VEC) or 4 of one head's row. blockDim.x, 32 * H times
// the batch rows, is a multiple of a row's units (H * DP / 4 or H * DP), so
// the column stays the same and the loops divide nothing.
template <int DP, bool VEC>
struct SlabCol {
  static constexpr int W = VEC ? 4 : 1;   // floats a unit
  int per, step, rl0, off, src;           // units a row, rows a step, first row, offsets
  bool live;                              // the column lies inside dh
  __device__ __forceinline__ SlabCol(int h, int dh) {
    per = h * DP / W;
    step = blockDim.x / per;
    rl0 = threadIdx.x / per;
    const int rem = threadIdx.x % per, hh = rem / (DP / W), c = W * (rem % (DP / W));
    off = W * rem;
    src = hh * dh + c;
    live = c < dh;
  }
};

// The slabs of nb batch rows of N (1 or 2) (B, L, H, dh) tensors, from sa
// and sb (their first rows) into da and db, each head's row padded with
// zeros to DP; unrolled, so that several loads of each thread are in flight.
// With N = 1, sb and db are not touched.
template <int DP, bool VEC, int N = 2>
__device__ __forceinline__ void slabs_in(float* da, float* db, const float* __restrict__ sa,
                                         const float* __restrict__ sb, int nb, int l, int h,
                                         int dh) {
  static_assert(N == 1 || N == 2, "one or two tensors");
  using T = typename std::conditional<VEC, float4, float>::type;
  const SlabCol<DP, VEC> col(h, dh);
  const int s = slab_stride(h, DP);
#pragma unroll 4
  for (int rl = col.rl0; rl < nb * l; rl += col.step) {
    T x{}, y{};
    if (col.live) {
      const size_t g = size_t(rl) * h * dh + col.src;
      x = __ldg(reinterpret_cast<const T*>(sa + g));
      if (N == 2) y = __ldg(reinterpret_cast<const T*>(sb + g));
    }
    *reinterpret_cast<T*>(da + rl * s + col.off) = x;
    if (N == 2) *reinterpret_cast<T*>(db + rl * s + col.off) = y;
  }
}

// The reverse of slabs_in for one tensor: the first dh floats of each
// head's row to dst.
template <int DP, bool VEC>
__device__ __forceinline__ void slab_out(float* __restrict__ dst, const float* src, int nb, int l,
                                         int h, int dh) {
  using T = typename std::conditional<VEC, float4, float>::type;
  const SlabCol<DP, VEC> col(h, dh);
  if (!col.live) return;
  const int s = slab_stride(h, DP);
#pragma unroll 4
  for (int rl = col.rl0; rl < nb * l; rl += col.step)
    *reinterpret_cast<T*>(dst + size_t(rl) * h * dh + col.src) =
        *reinterpret_cast<const T*>(src + rl * s + col.off);
}

// x[0..DP) = the DP floats at p (16-byte aligned), as float4s.
template <int DP>
__device__ __forceinline__ void load_row(float (&x)[DP], const float* p) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + c);
    x[c] = f.x;
    x[c + 1] = f.y;
    x[c + 2] = f.z;
    x[c + 3] = f.w;
  }
}

// The DP floats x * scale to p (16-byte aligned), as float4s.
template <int DP>
__device__ __forceinline__ void store_row(float* p, const float (&x)[DP], float scale) {
#pragma unroll
  for (int c = 0; c < DP; c += 4)
    *reinterpret_cast<float4*>(p + c) =
        make_float4(x[c] * scale, x[c + 1] * scale, x[c + 2] * scale, x[c + 3] * scale);
}

// ---- L-64 instances: one warp a (b, h), up to 64 queries and keys ----
//
// The warp instances' blocks and slabs (warp_rows, slabs_in, slab_out), with
// a lane on a query (or a key) and, past 32, on a second one in a second
// turn of the same warp. A query's 64 logits stay in the lane's registers
// (L64 of them, the loops over keys unrolled so that every index is a
// constant): no (Lq, Lk) matrix in shared memory. The key slabs hold L64
// rows a batch row, those past lk zero with a bias of -inf, so the loops
// over keys have no bound to test: a padded key's logit is -inf, its
// exponential 0, and it adds exact zeros to every sum.

constexpr int L64 = 64;   // queries or keys a warp takes, two turns of 32 lanes

// The shapes the L-64 instances take (the wrappers give them those the
// warp instances do not: field_attention.py).
__host__ __device__ inline bool l64_fits(int lq, int lk, int h, int dh) {
  return lq <= L64 && lk <= L64 && dh <= WARP_MAX_DH && h <= WARP_MAX_H;
}

// k and v of nb batch rows (from k, v: their first rows) into the padded
// key slabs ks and vs (L64 rows of slab_stride(h, DP) floats a batch row),
// rows lk to L64 zero, and the bias into bs (L64 a batch row), -inf past lk.
template <int DP, bool VEC>
__device__ __forceinline__ void l64_keys_in(float* ks, float* vs, float* bs,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ bias, int nb, int lk, int h,
                                            int dh) {
  const int s = slab_stride(h, DP);
  for (int bl = 0; bl < nb; ++bl) {
    const size_t g = size_t(bl) * lk * h * dh;
    slabs_in<DP, VEC>(ks + bl * L64 * s, vs + bl * L64 * s, k + g, v + g, 1, lk, h, dh);
    float* zk = ks + (bl * L64 + lk) * s;
    float* zv = vs + (bl * L64 + lk) * s;
    for (int e = threadIdx.x; e < (L64 - lk) * s; e += blockDim.x) zk[e] = zv[e] = 0.f;
    for (int j = threadIdx.x; j < L64; j += blockDim.x)
      bs[bl * L64 + j] = j < lk ? bias[size_t(bl) * lk + j] : -CUDART_INF_F;
  }
}

// The reverse of l64_keys_in for one padded slab: its first lk rows of each
// batch row to dst.
template <int DP, bool VEC>
__device__ __forceinline__ void l64_keys_out(float* __restrict__ dst, const float* src, int nb,
                                             int lk, int h, int dh) {
  const int s = slab_stride(h, DP);
  for (int bl = 0; bl < nb; ++bl)
    slab_out<DP, VEC>(dst + size_t(bl) * lk * h * dh, src + bl * L64 * s, 1, lk, h, dh);
}

// The sum of e[0..L64) (zeros past the row's keys) in torch.softmax's order
// for 33 to 64 columns, formed in one thread: its warp butterfly starts with
// lane l holding 0 + e[l] + e[l + 32], then adds pairs 16 lanes apart, then
// 8, 4, 2, 1. With 32 keys or fewer the zeros leave that order's sums
// exact, so it is also the order for those.
__device__ __forceinline__ float softmax_sum64(const float (&e)[L64]) {
  float t[16];
#pragma unroll
  for (int l = 0; l < 16; ++l) t[l] = (e[l] + e[l + 32]) + (e[l + 16] + e[l + 48]);
#pragma unroll
  for (int l = 0; l < 8; ++l) t[l] += t[l + 8];
#pragma unroll
  for (int l = 0; l < 4; ++l) t[l] += t[l + 4];
  t[0] += t[2];
  t[1] += t[3];
  return t[0] + t[1];
}

// The lane's query x against the L64 keys of a padded slab (key j's row at
// kh + j * s, broadcast from shared memory): e[j] = (x . k_j) * scale +
// bias[j], the FMAs over d in order, then two roundings, as the plain
// version forms them, then e[j] = expf(e[j] - max). Returns the max.
template <int DP>
__device__ __forceinline__ float exps64(float (&e)[L64], const float (&x)[DP], const float* kh,
                                        int s, const float* bh, float scale) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < L64; ++j) {
    float y[DP];
    load_row<DP>(y, kh + j * s);
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < DP; ++c) d = fmaf(x[c], y[c], d);
    e[j] = __fadd_rn(__fmul_rn(d, scale), bh[j]);
    m = fmaxf(m, e[j]);
  }
#pragma unroll
  for (int j = 0; j < L64; ++j) e[j] = expf(e[j] - m);
  return m;
}

// e / sum rounded to nearest, as the IEEE division gives it, from r =
// __frcp_rn(sum) in three operations (Markstein's correction: the quotient
// e * r, its exact remainder, one FMA), for 2^-64 <= e <= 1 <= sum <= 64,
// where neither the remainder nor the quotient underflows; and e = 0.
__device__ __forceinline__ float div_rn(float e, float sum, float r) {
  const float q = __fmul_rn(e, r);
  return fmaf(fmaf(-sum, q, e), r, q);
}

// ---- wide instances: one warp a (b, h) and 32 queries (or keys), any H ----
//
// For up to 64 queries and keys at any head width of the gate (Dh <= 64) and
// any H. The rows of one (b, h) are staged into shared memory apart from
// every other pair's, so a block holds no batch row whole: WIDE_THREADS
// threads take 64 / L pairs, where L (32 or 64, a template parameter) is
// max(Lq, Lk) rounded up, and each pair's L threads (L / 32 warps) copy its
// rows with cp.async (16 bytes a copy where Dh is a multiple of 4 and the
// rows are 16-byte aligned, else 4), L rows of wide_stride(dh) floats: the
// columns past Dh and the rows past Lq or Lk are zero-filled by the copy
// itself (a source size of 0), and the bias is -inf past Lk, so the loops
// over keys and queries run over L with constant indices and test no bound
// (a second template instance tests one a group of WIDE_GROUP, to skip the
// groups that are padding). A lane works through the head
// dimension WIDE_CHUNK columns at a time, so its registers hold L sums and
// one chunk of a row, whatever Dh.

constexpr int WIDE_THREADS = 64;   // two warps a block
constexpr int WIDE_CHUNK = 16;     // columns of a row a lane holds at a time
constexpr int WIDE_GROUP = 8;      // keys (queries) skipped at a time past lk (lq)
constexpr int WIDE_MAX_DH = 64;    // the gate's head width

// The shapes the wide instances take (the wrappers give them those past the
// warp and L-64 instances' Dh 16 and H 8 up to 64 positions:
// field_attention.py).
__host__ __device__ inline bool wide_fits(int lq, int lk, int h, int dh) {
  return lq <= L64 && lk <= L64 && dh <= WIDE_MAX_DH;
}

// Floats of one staged row: Dh rounded up to a chunk, and 4 more, so that
// the 16-byte loads of 8 lanes reading 8 neighbouring rows (a lane's own
// row) hit 32 distinct banks (the stride / 4 is odd).
__host__ __device__ inline int wide_stride(int dh) {
  return (dh + WIDE_CHUNK - 1) / WIDE_CHUNK * WIDE_CHUNK + 4;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of one (b, h) of a (B, n, H, dh) tensor (src: its row 0, rows
// stride floats apart) into L rows of s floats at dst, by the pair's L
// threads (t its thread), as cp.async copies in flight until the caller
// waits for them: the columns [dh, s - 4) and the rows [n, L) zero.
template <int L, bool VEC>
__device__ __forceinline__ void wide_rows_in(float* dst, const float* __restrict__ src, int n,
                                             int stride, int dh, int s, int t) {
  constexpr int W = VEC ? 4 : 1;   // floats a copy
  const int per = (s - 4) / W;     // copies a row
  for (int u = t; u < L * per; u += L) {
    const int r = u / per, c = W * (u - r * per);
    const bool ok = r < n && c < dh;
    const float* g = ok ? src + size_t(r) * stride + c : src;
    if (VEC)
      cp_async16(dst + r * s + c, g, ok ? 16 : 0);
    else
      cp_async4(dst + r * s + c, g, ok ? 4 : 0);
  }
}

template <int L>
__device__ __forceinline__ void wide_rows_in(float* dst, const float* __restrict__ src, int n,
                                             int stride, int dh, int s, int t, bool vec) {
  if (vec)
    wide_rows_in<L, true>(dst, src, n, stride, dh, s, t);
  else
    wide_rows_in<L, false>(dst, src, n, stride, dh, s, t);
}

// The sum of e[0..L) (zeros past the row's keys) in torch.softmax's order:
// for L 64 fa::softmax_sum64; for L 32 its warp butterfly over 32 slots,
// a key a slot (pairs 16 apart, then 8, 4, 2, 1), which with zeros past the
// keys is also its order for 16 keys or fewer.
template <int L>
__device__ __forceinline__ float wide_sum(const float (&e)[L]) {
  if constexpr (L == L64) {
    return softmax_sum64(e);
  } else {
    static_assert(L == WARP_L, "32 or 64 positions");
    float t[16];
#pragma unroll
    for (int l = 0; l < 16; ++l) t[l] = e[l] + e[l + 16];
#pragma unroll
    for (int l = 0; l < 8; ++l) t[l] += t[l + 8];
#pragma unroll
    for (int l = 0; l < 4; ++l) t[l] += t[l + 4];
    t[0] += t[2];
    t[1] += t[3];
    return t[0] + t[1];
  }
}

// e[j] += x . (row j of m), for the WIDE_GROUP rows from j0 (row j at m +
// j * s, a chunk of WIDE_CHUNK columns broadcast from shared memory as
// 16-byte loads): each row's FMAs in order over the columns, the rows
// unrolled for the compiler to interleave.
template <int L>
__device__ __forceinline__ void wide_dots(float (&e)[L], int j0, const float (&x)[WIDE_CHUNK],
                                          const float* m, int s) {
#pragma unroll
  for (int j = j0; j < j0 + WIDE_GROUP; ++j) {
    float y[WIDE_CHUNK];
    load_row<WIDE_CHUNK>(y, m + j * s);
#pragma unroll
    for (int c = 0; c < WIDE_CHUNK; ++c) e[j] = fmaf(x[c], y[c], e[j]);
  }
}

// The WIDE_CHUNK floats x * scale to row p's columns [c0, c0 + WIDE_CHUNK)
// in device memory, those below dh: 16-byte stores with vec.
__device__ __forceinline__ void wide_store(float* __restrict__ p, const float (&x)[WIDE_CHUNK],
                                           int c0, int dh, float scale, bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < WIDE_CHUNK; c += 4)
      if (c0 + c < dh)
        *reinterpret_cast<float4*>(p + c0 + c) =
            make_float4(x[c] * scale, x[c + 1] * scale, x[c + 2] * scale, x[c + 3] * scale);
  } else {
#pragma unroll
    for (int c = 0; c < WIDE_CHUNK; ++c)
      if (c0 + c < dh) p[c0 + c] = x[c] * scale;
  }
}

}  // namespace fa
