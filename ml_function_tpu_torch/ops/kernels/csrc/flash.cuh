// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu), which replace the three Pallas kernels
// of ml_function_tpu/ops/kernels/flash_attention.py.
//
// Layouts: q, o, dO (B, H, Lq, Dh), k, v (B, H, Lk, Dh), all contiguous f32,
// so the rows of one (b, h) pair are Dh contiguous floats each; the key bias
// is (B, Lk) (0 for a valid key, NEG_INF for a masked one), shared by the H
// heads of a batch row; lse and delta are (B, H, Lq). Dh is padded with zeros
// to DP, a compile-time width (8, 16, 32 or 64).
//
// Split-TF32 products on the tensor cores (all three kernels). The products
// run as mma.sync m16n8k8 in TF32, whose 10-bit mantissa alone would put an
// error of about 5e-4 into every logit. So each operand x is
// split into hi = tf32(x) and lo = x - hi (which the tensor cores read as
// tf32(lo), truncated), and a product is formed as lo*hi + hi*lo + hi*hi
// in f32 (lo*lo, below 2^-22 of the product, is dropped): about 21 bits,
// close to f32, for three tensor-core passes that still cost far less than
// the CUDA cores' scalar FMAs. The rounding is two integer instructions, not
// cvt.rna.tf32, which runs at a quarter of the rate on the conversion pipe.
// An operand is split once where it is loaded: the streamed tiles when they
// are staged into shared memory, each element as one float4 per pair of
// neighbouring columns, {hi(c), hi(c + 1), lo(c), lo(c + 1)}, so that one
// 16-byte load gives a lane both halves of its fragment; P and dS are split
// once a pair, as they leave the C fragment.
//
// No bias. The tensor cores truncate: they read only the top bits of a TF32
// operand and round their f32 sums toward zero. An error that always has
// the sign of the value shrinks every output by the same share, and a long
// sum downstream (a mean over 16,384 queries, a gradient over a batch)
// keeps that share where it would average out rounding to nearest. So hi
// is rounded to nearest (lo then takes either sign and its truncation
// cancels on average), and the long sums over keys or queries add each
// k-step's product in f32 (mma3_add) rather than chaining them through
// the tensor cores' accumulator. Each kernel's note says what bounds it on
// the H100.
//
// The key permutation. mma.sync's fragments give lane (g = lane / 4,
// t = lane % 4) the columns 2t and 2t + 1 of its C tile, but columns t and
// t + 4 of its A tile. A product's result (the probabilities P) feeds the
// next product as A, contracted over those same columns, and a sum over them
// does not care about their order. So the kernels let the mma's k index t
// stand for column 2t and t + 4 for column 2t + 1, in every product, and
// give the B operand's rows the same order: a C fragment is then an A
// fragment as it stands, with no shuffle. The same order over Dh makes
// every fragment load of a row-major tile one 16-byte load.
//
// The layouts of a staged, split tile of rows (keys, or queries):
// - "rows": row r at r * row_stride<DP>(), pair of columns c / 2 at 4 * (c / 2);
//   the A or B operand that is contracted over Dh (q·kᵀ in the forward);
// - "pairs": the rows 2p and 2p + 1 together at p * pair_stride<DP>(), column c
//   at 4 * c; the B operand that is contracted over the rows (P·V).
// The pads (16 and 8 floats) keep each quarter-warp's 16-byte loads on 32
// distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e9f;     // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;

// exp(x): the card's fast exponential (ex2.approx of x * log2 e), or expf
// where the build defines FLASH_ACCURATE_EXP (tools/flash_numerics.py).
__device__ __forceinline__ float fast_exp(float x) {
#ifdef FLASH_ACCURATE_EXP
  return expf(x);
#else
  return __expf(x);
#endif
}

// A row max m (or an lse) below this lies in the masked regime: every key of
// the row is masked, so s and m are both near NEG_INF, where only s - m
// formed first is exact (exp_minus<false>'s FMA would err by up to 64 in the
// exponent).
constexpr float MASKED = 0.5f * NEG_INF;

// exp(s - m), given ml = m * LOG2E. EXACT false: one FMA and one ex2.approx
// a pair (the FMA rounds once where __expf(s - m) rounds s - m and then the
// product); EXACT true, for the masked regime: s - m first, as the
// reference forms it.
template <bool EXACT>
__device__ __forceinline__ float exp_minus(float s, float m, float ml) {
#ifdef FLASH_ACCURATE_EXP
  return expf(s - m);
#else
  if (EXACT) return __expf(s - m);
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(s, LOG2E, -ml)));
  return r;
#endif
}

// The logit of one (query, key) pair from its dot product: times the scale,
// then plus the bias, two roundings as the reference forms it (an FMA would
// round the -1e9 of a masked key differently); NEG_INF in its place for a
// key after its query under the causal mask (a runtime flag, so one
// instance serves both).
__device__ __forceinline__ float logit(float qk, float scale, float bias, int row, int col,
                                       bool causal) {
  if (causal && col > row) return NEG_INF;
  return __fadd_rn(__fmul_rn(qk, scale), bias);
}

// The width the kernels are instantiated at for a head dim dh <= 64.
inline int padded_dim(int dh) { return dh <= 8 ? 8 : dh <= 16 ? 16 : dh <= 32 ? 32 : 64; }

// ---- split TF32 on the tensor cores ----

template <int DP>
__host__ __device__ constexpr int row_stride() { return 2 * DP + (DP >= 16 ? 16 : 0); }
template <int DP>
__host__ __device__ constexpr int pair_stride() { return 4 * DP + 8; }

// x rounded to TF32, to nearest with ties away from zero (what cvt.rna.tf32
// gives), by two integer instructions: cvt runs on the conversion pipe at a
// quarter of the rate, and two conversions a pair made it the bottleneck.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// {hi(a), hi(b), lo(a), lo(b)}: hi = tf32(x), lo = x - hi, exact in f32.
// lo is not rounded: the tensor cores read a TF32 operand's top 19 bits
// and drop the rest, an error below 2^-21 of x.
__device__ __forceinline__ float4 split2(float a, float b) {
  const float ha = tf32(a), hb = tf32(b);
  return make_float4(ha, hb, a - ha, b - hb);
}

// An A fragment (16 x 8, rows x k) and a B fragment (8 x 8, k x cols), each
// split into its hi and lo parts.
struct FragA {
  float hi[4], lo[4];
};
struct FragB {
  float hi[2], lo[2];
};

// d += a * b in TF32, one m16n8k8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// d += a * b in split TF32: the two small terms first, then hi * hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc += a * b in split TF32, the product formed from zero and added with
// f32 adds. The tensor cores' f32 accumulation truncates: chained over the
// thousands of mma of a 16,384-long sum, its bias reaches about 1e-5 of the
// sum, and chained over even a few k-steps it still shrinks the sum
// measurably. Formed a k-step at a time, each product is three mma from
// zero, and the long sum rounds to nearest. It also frees the mma of a long
// dependency chain through one accumulator.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const FragA& a, const FragB& b) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(__float_as_uint(a.lo[0])), "r"(__float_as_uint(a.lo[1])),
        "r"(__float_as_uint(a.lo[2])), "r"(__float_as_uint(a.lo[3])),
        "r"(__float_as_uint(b.hi[0])), "r"(__float_as_uint(b.hi[1])), "f"(0.f));
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// d += a * b for k-step kk of a sum over Dh, d zero before k-step 0: the
// first k-step accumulates into d itself (it starts from zero), the later
// ones are formed from zero and added in f32 (mma3_add), so that a head of
// 64 does not chain 8 k-steps through the truncating accumulator.
__device__ __forceinline__ void mma3_sum(float (&d)[4], int kk, const FragA& a, const FragB& b) {
  if (kk == 0)
    mma3(d, a, b);
  else
    mma3_add(d, a, b);
}

// The A fragment of rows r0.. r0 + 15 and k-step kk (columns 8kk..8kk + 7) of
// a "rows" tile: lane (g, t) takes columns 2t and 2t + 1 of rows g and g + 8.
template <int DP>
__device__ __forceinline__ FragA a_rows(const float* tile, int r0, int kk, int g, int t) {
  const float4 x = *reinterpret_cast<const float4*>(tile + (r0 + g) * row_stride<DP>() + kk * 16 + 4 * t);
  const float4 y =
      *reinterpret_cast<const float4*>(tile + (r0 + g + 8) * row_stride<DP>() + kk * 16 + 4 * t);
  return {{x.x, y.x, x.y, y.y}, {x.z, y.z, x.w, y.w}};
}

// The same A fragment of an (n, dh) matrix in device memory, split as it is
// loaded (a warp's own rows, kept in registers); rows at and past n, and
// columns at and past dh, are zero.
__device__ __forceinline__ FragA a_global(const float* __restrict__ src, int r0, int kk, int n,
                                          int dh, int g, int t) {
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + g + 8 * (e & 1), c = kk * 8 + 2 * t + (e >> 1);
    x[e] = (row < n && c < dh) ? src[size_t(row) * dh + c] : 0.f;
  }
  // x[0], x[1]: rows g, g + 8 at column 2t; x[2], x[3]: at column 2t + 1
  const float4 c0 = split2(x[0], x[1]), c1 = split2(x[2], x[3]);
  return {{c0.x, c0.y, c1.x, c1.y}, {c0.z, c0.w, c1.z, c1.w}};
}

// The A fragment of a C fragment c (16 x 8), contracted next over its 8
// columns: with the key permutation it is c itself, split. hi is rounded to
// nearest. Truncating it would save an instruction a pair, but then lo has
// the sign of x and the tensor cores' truncation of lo always shrinks it:
// P, never negative, would come out short on average, and with it o, dk
// and dv (see "No bias" above).
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  float hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32(c[e]);
    lo[e] = c[e] - hi[e];
  }
  return {{hi[0], hi[2], hi[1], hi[3]}, {lo[0], lo[2], lo[1], lo[3]}};
}

// The B fragment (k = Dh columns 8kk.., n = rows r0.. r0 + 7) of a "rows"
// tile, for a product contracted over Dh: lane (g, t) reads row r0 + g.
template <int DP>
__device__ __forceinline__ FragB b_rows(const float* tile, int r0, int kk, int g, int t) {
  const float4 x = *reinterpret_cast<const float4*>(tile + (r0 + g) * row_stride<DP>() + kk * 16 + 4 * t);
  return {{x.x, x.y}, {x.z, x.w}};
}

// The B fragment (k = rows 8j.. 8j + 7, n = columns 8nd..) of a "pairs"
// tile, for a product contracted over the rows: lane (g, t) reads rows
// 8j + 2t and 8j + 2t + 1 of column 8nd + g.
template <int DP>
__device__ __forceinline__ FragB b_pairs(const float* tile, int j, int nd, int g, int t) {
  const float4 x =
      *reinterpret_cast<const float4*>(tile + (4 * j + t) * pair_stride<DP>() + 4 * (nd * 8 + g));
  return {{x.x, x.y}, {x.z, x.w}};
}

// A tile of ROWS rows of a (L, dh) matrix on its way into shared memory,
// NT threads together: fetch() loads the raw floats into registers (rows at
// and past n, and columns at and past dh, are zero), store_*() splits them
// into one of the two layouts. Fetching one tile while the block computes on
// the other is the double buffer.
template <int DP, int ROWS, int NT>
struct Stager {
  static constexpr int UNITS = ROWS * DP / 2;   // float4s of either layout
  static constexpr int PER = UNITS / NT;
  static_assert(UNITS % NT == 0, "a tile's units must spread evenly over the threads");
  float2 x[PER];

  // "rows" units: row u / (DP / 2), columns 2 (u % (DP / 2)) and the next
  __device__ __forceinline__ void fetch_rows(const float* __restrict__ src, int n, int dh) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * NT, r = u / (DP / 2), c = 2 * (u % (DP / 2));
      const float* p = src + size_t(r) * dh + c;
      x[i].x = (r < n && c < dh) ? p[0] : 0.f;
      x[i].y = (r < n && c + 1 < dh) ? p[1] : 0.f;
    }
  }
  __device__ __forceinline__ void store_rows(float* tile) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * NT, r = u / (DP / 2), c = u % (DP / 2);
      *reinterpret_cast<float4*>(tile + r * row_stride<DP>() + 4 * c) = split2(x[i].x, x[i].y);
    }
  }
  // "pairs" units: rows 2 (u / DP) and the next, column u % DP
  __device__ __forceinline__ void fetch_pairs(const float* __restrict__ src, int n, int dh) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * NT, r = 2 * (u / DP), c = u % DP;
      const float* p = src + size_t(r) * dh + c;
      x[i].x = (r < n && c < dh) ? p[0] : 0.f;
      x[i].y = (r + 1 < n && c < dh) ? p[dh] : 0.f;
    }
  }
  __device__ __forceinline__ void store_pairs(float* tile) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * NT, p = u / DP, c = u % DP;
      *reinterpret_cast<float4*>(tile + p * pair_stride<DP>() + 4 * c) = split2(x[i].x, x[i].y);
    }
  }
};

// The largest of two values across the quad of lanes that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sets kernel's dynamic shared memory limit to bytes once per process;
// returns the CUDA error code (0 on success).
template <typename K>
inline int allow_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

}  // namespace flash

// Launches LAUNCH(DP) at the padded width of dh.
#define FLASH_DISPATCH(dh, LAUNCH)           \
  switch (flash::padded_dim(dh)) {           \
    case 8: LAUNCH(8); break;                \
    case 16: LAUNCH(16); break;              \
    case 32: LAUNCH(32); break;              \
    default: LAUNCH(64); break;              \
  }
