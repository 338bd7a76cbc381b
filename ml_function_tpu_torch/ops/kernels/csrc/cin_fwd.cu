// CIN layer forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces ml_function_tpu/ops/kernels/cin.py::_fwd_kernel (launched there by
// _fwd_call). On activations in the (D, B, .) layout it computes
//
//   y[d,b,o] = sum_f x0[d,b,f] * sum_h bf16(xk[d,b,h]) * bf16(w1[h, f*O + o])
//
// with f32 products and sums. Only xk and w1 are rounded to bf16; x0 stays f32,
// as in the TPU kernel.
//
// What bounds it on the H100: at the second CIN layer of xDeepFM (H = 128,
// F = 26, O = 128) the product xk @ w1 does 2*D*B*H*F*O flops for about
// 4*D*B*(H + F + O) bytes of input and output, some 700 flops a byte: the
// tensor cores bound it. The first layer (H = 26) is bound by memory. The TPU
// kernel held the whole (H, F*O) weight in VMEM; at H = 128 that is 852 KB in
// bf16, far above the 227 KB of shared memory a block may use, and the
// (rows, F*O) product U does not fit either.
//
// Design: one block per (64-row batch tile, 128-wide O tile, d). The block
// rounds its (64, H) slice of xk to bf16 into shared memory once and reuses it
// for all F fields. For each field f it streams the (H, 128) slice
// w1[:, f*O + o-tile] through shared memory (double buffered with cp.async;
// a small prep kernel first rounds w1 to bf16 and transposes it, so the
// stream is plain 16-byte copies), forms U_f = xk @ w1_f with mma.sync
// m16n8k16 (bf16 in, f32 accumulate) in registers, and folds x0[:, f] * U_f
// into the f32 output accumulator. Neither U nor the interaction tensor Z
// reaches device memory. The kernel masks the ragged edges of B and O and
// zero-pads H to a multiple of 16.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates:
// the caller passes y and the (F*O, pad16(H)) bf16 scratch for the weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TB = 64;          // batch rows per block
constexpr int TO = 128;         // output columns per block
constexpr int THREADS = 256;    // 8 warps: 4 along the rows x 2 along the columns
constexpr int WARP_N = 64;      // output columns per warp
constexpr int NT = WARP_N / 8;  // 8-wide mma tiles per warp

__host__ __device__ inline int pad16(int h) { return (h + 15) / 16 * 16; }

// Row stride in shared memory, in bf16 elements. The extra 8 puts the eight
// rows a fragment load touches on distinct banks.
__host__ __device__ inline int smem_stride(int h) { return pad16(h) + 8; }

size_t smem_bytes(int h, int f) {
  const size_t ks = smem_stride(h);
  return TB * ks * sizeof(bf16)         // xk tile
         + 2 * TO * ks * sizeof(bf16)   // two weight tiles
         + size_t(TB) * f * sizeof(float);  // x0 tile
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a @ b for one 16x8x16 tile: a row-major bf16, b column-major bf16, c f32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wt[r, k] = bf16(w1[k, r]) for k < H, 0 for H <= k < Hp; r < F*O.
__global__ void w_prep_kernel(const float* __restrict__ w1, bf16* __restrict__ wt,
                              int h, int hp, int fo) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, r = r0 + tx;
    tile[i][tx] = (k < h && r < fo) ? w1[size_t(k) * fo + r] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, k = k0 + tx;
    if (r < fo && k < hp) wt[size_t(r) * hp + k] = __float2bfloat16_rn(tile[tx][i]);
  }
}

// Starts the copy of field f's (TO, Hp) weight tile into ws; rows past O are zeroed.
__device__ __forceinline__ void load_w_tile(bf16* ws, const bf16* __restrict__ wt, int f,
                                            int o0, int o, int hp, int ks) {
  const int chunks = hp / 8;  // 16-byte chunks in a row
  for (int i = threadIdx.x; i < TO * chunks; i += THREADS) {
    const int n = i / chunks, c = i - n * chunks;
    bf16* dst = ws + n * ks + c * 8;
    if (o0 + n < o) {
      cp_async16(dst, wt + size_t(f * o + o0 + n) * hp + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    cin_fwd_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                   const bf16* __restrict__ wt, float* __restrict__ y, int b_total, int h,
                   int f_total, int o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = pad16(h), ks = hp + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws0 = xs + TB * ks;
  bf16* ws1 = ws0 + TO * ks;
  float* x0s = reinterpret_cast<float*>(ws1 + TO * ks);

  const int b0 = blockIdx.x * TB, o0 = blockIdx.y * TO, d = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = (warp & 3) * 16 + g;       // this thread's rows: row_a, row_a + 8
  const int col_b = (warp >> 2) * WARP_N + g;  // this thread's B column, + 8 * j

  // the first weight tile streams in while the activations are staged
  load_w_tile(ws0, wt, 0, o0, o, hp, ks);
  cp_async_commit();

  const float* xk_d = xk + size_t(d) * b_total * h;
  const int half = hp / 2;
  for (int i = tid; i < TB * half; i += THREADS) {
    const int r = i / half, k = (i - r * half) * 2, b = b0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (b < b_total) {
      const float* row = xk_d + size_t(b) * h;
      if (k < h) v0 = row[k];
      if (k + 1 < h) v1 = row[k + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(xs + r * ks + k) = __floats2bfloat162_rn(v0, v1);
  }
  const float* x0_d = x0 + size_t(d) * b_total * f_total;
  for (int i = tid; i < TB * f_total; i += THREADS) {
    const int b = b0 + i / f_total;
    x0s[i] = b < b_total ? x0_d[size_t(b0) * f_total + i] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int f = 0; f < f_total; ++f) {
    const bf16* ws = (f & 1) ? ws1 : ws0;
    if (f + 1 < f_total) {
      // the other buffer was last read before the barrier closing field f - 1
      load_w_tile((f & 1) ? ws0 : ws1, wt, f + 1, o0, o, hp, ks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float u[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
    for (int k = 0; k < hp; k += 16) {
      const bf16* pa = xs + row_a * ks + k + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * ks);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * ks + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* pb = ws + (col_b + 8 * j) * ks + k + 2 * t;
        uint32_t bb[2];
        bb[0] = *reinterpret_cast<const uint32_t*>(pb);
        bb[1] = *reinterpret_cast<const uint32_t*>(pb + 8);
        mma_bf16(u[j], a, bb);
      }
    }
    const float xa = x0s[row_a * f_total + f], xb = x0s[(row_a + 8) * f_total + f];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] += xa * u[j][0];
      acc[j][1] += xa * u[j][1];
      acc[j][2] += xb * u[j][2];
      acc[j][3] += xb * u[j][3];
    }
    __syncthreads();
  }

  float* y_d = y + size_t(d) * b_total * o;
  const bool pairs = (o & 1) == 0;  // then (row * o + even col) is 8-byte aligned
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = o0 + (warp >> 2) * WARP_N + 8 * j + 2 * t;
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row) {
      const int b = b0 + row_a + 8 * half_row;
      if (b >= b_total) continue;
      float* dst = y_d + size_t(b) * o + col;
      const float v0 = acc[j][2 * half_row], v1 = acc[j][2 * half_row + 1];
      if (pairs && col + 1 < o) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col < o) dst[0] = v0;
        if (col + 1 < o) dst[1] = v1;
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the caller refuses shapes above the card's limit.
size_t cin_fwd_smem_bytes(int h, int f) { return smem_bytes(h, f); }

// Columns of the bf16 weight scratch: H rounded up to a multiple of 16.
int cin_fwd_scratch_cols(int h) { return pad16(h); }

// xk (D, B, H), x0 (D, B, F), w1 (H, F*O) f32 -> y (D, B, O) f32, all contiguous on
// the current device; wt is (F*O, pad16(H)) bf16 scratch. Returns the CUDA error
// code of the launches (0 on success).
int cin_fwd(const float* xk, const float* x0, const float* w1, float* y, void* wt, int d,
            int b, int h, int f, int o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = pad16(h), fo = f * o;
  const size_t smem = smem_bytes(h, f);
  cudaError_t err = cudaFuncSetAttribute(
      cin_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 prep_grid((fo + 31) / 32, (hp + 31) / 32), prep_block(32, 8);
  w_prep_kernel<<<prep_grid, prep_block, 0, s>>>(w1, static_cast<bf16*>(wt), h, hp, fo);
  const dim3 grid((b + TB - 1) / TB, (o + TO - 1) / TO, d);
  cin_fwd_kernel<<<grid, THREADS, smem, s>>>(xk, x0, static_cast<const bf16*>(wt), y, b, h,
                                             f, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
