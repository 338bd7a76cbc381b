// CIN layer backward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces ml_function_tpu/ops/kernels/cin.py::_bwd_kernel (line 62, launched
// there by _bwd_call). With the rows of the (D, B, .) activations flattened to
// m = d*B + b, and for the cotangent dy of y = cin_fwd(xk, x0, w1):
//
//   u[m, f*O+o]  = sum_h bf16(xk[m,h]) * bf16(w1[h, f*O+o])      (f32 sums)
//   dx0[m,f]     = sum_o u[m, f*O+o] * dy[m,o]
//   du[m, f*O+o] = x0[m,f] * dy[m,o]                               (f32)
//   dxk[m,h]     = sum_{f,o} bf16(du[m, f*O+o]) * bf16(w1[h, f*O+o])
//   dW[h, f*O+o] = sum_m bf16(xk[m,h]) * bf16(du[m, f*O+o])
//
// These are the TPU kernel's rounding sites: only xk, w1 and du are rounded to
// bf16; every product and sum is f32.
//
// What bounds it on the H100: 6*D*B*H*F*O flops (three products of the
// forward's size) against about 4*D*B*(2H + 2F + O) + 8*H*F*O bytes. At
// xDeepFM's second CIN layer (D 8, B 4096, H 128, F 26, O 128) that is
// 84 GFLOP for 61 MB, some 1,400 flops a byte: the tensor cores bound it. The
// TPU kernel held the whole (H, F*O) weight in VMEM and summed dW over its
// sequential grid into one revisited output block. Neither carries over: the
// weight (852 KB in bf16 at H 128) is far above the 227 KB of shared memory
// of a block, and Hopper blocks run in parallel in no fixed order.
//
// Design: three kernels after a prep kernel that rounds w1 to bf16 and
// transposes it to (F*O, pad16(H)), as the forward's does.
//   1. cin_bwd_rows_kernel: one block per 64-row tile (and 128-wide slice of
//      H for dxk). For each (O tile, field f) it streams the (128, H) slice
//      of the weight through a double buffer in shared memory (cp.async),
//      recomputes U_f = xk @ w1_f with mma.sync m16n8k16 (bf16 in, f32
//      accumulate), reduces U_f * dy over O into dx0, forms the du_f tile in
//      shared memory (bf16) and accumulates dxk += du_f @ w1_f^T in registers,
//      reading the same weight tile transposed with ldmatrix.trans. U and du
//      never reach device memory.
//   2. cin_bwd_dw_kernel: dW as a split-K product over the rows. One block
//      per (64-row slice of H, field f and O tile, split s of the rows) forms
//      bf16(xk)^T @ bf16(du_f) for its rows (du_f recomputed from x0 and dy,
//      which needs no U) and writes a fixed partial.
//   3. cin_bwd_reduce_kernel: dW = sum of the partials over s, in order.
// No atomics: the same inputs give the same bits on every run. Every kernel
// masks the ragged edges of the rows, H and O.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates:
// the caller passes the outputs, the bf16 weight scratch and the f32 partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TB = 64;          // rows per block (rows kernel)
constexpr int TO = 128;         // O columns per weight tile
constexpr int THREADS = 256;    // 8 warps
constexpr int WARP_N = 64;      // U columns per warp: 4 warps along rows x 2 along O
constexpr int NT = WARP_N / 8;  // 8-wide mma tiles per warp in U
constexpr int HC = 128;         // dxk columns (of H) per block
constexpr int NP = HC / 32;     // 16-wide column pairs per warp in dxk (2 warps along H)
constexpr int TS = TO + 8;      // row stride of the du tile, in bf16
constexpr int WH = 64;          // dW rows (of H) per block
constexpr int KC = 64;          // rows per stage of the dW kernel
constexpr int XS = WH + 8;      // row stride of the dW kernel's xk stage
constexpr int TARGET_BLOCKS = 528;  // dW blocks to aim for: 4 on each of 132 SMs

__host__ __device__ inline int pad16(int h) { return (h + 15) / 16 * 16; }

size_t rows_smem_bytes(int h, int f) {
  const size_t ks = pad16(h) + 8;
  return TB * ks * sizeof(bf16)           // xk tile
         + 2 * TO * ks * sizeof(bf16)     // two weight tiles
         + size_t(TB) * TS * sizeof(bf16) // du tile
         + size_t(TB) * f * sizeof(float) // x0 tile
         + 2 * TB * sizeof(float);        // dx0 halves
}

// Rows per split of the dW product (a multiple of KC) and the number of splits.
void dw_splits(int m, int h, int f, int o, int* rows_per_split, int* splits) {
  const int base = (pad16(h) + WH - 1) / WH * f * ((o + TO - 1) / TO);
  const int chunks = (m + KC - 1) / KC;
  int s = (TARGET_BLOCKS + base - 1) / base;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  const int rps = (chunks + s - 1) / s * KC;
  *rows_per_split = rps;
  *splits = (m + rps - 1) / rps;
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

// Four 8x8 bf16 matrices from shared memory, each transposed: lane l gives the
// row address of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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

// Starts the copy of the (TO, Hp) weight tile of field f, O columns o0.., into
// ws (row n = column o0 + n of the field); rows past O are zeroed.
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

__global__ void __launch_bounds__(THREADS)
    cin_bwd_rows_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                        const bf16* __restrict__ wt, const float* __restrict__ dy,
                        float* __restrict__ dxk, float* __restrict__ dx0, int m_total,
                        int h, int f_total, int o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = pad16(h), ks = hp + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws0 = xs + TB * ks;
  bf16* ws1 = ws0 + TO * ks;
  bf16* dus = ws1 + TO * ks;
  float* x0s = reinterpret_cast<float*>(dus + TB * TS);
  float* red = x0s + TB * f_total;

  const int r0 = blockIdx.x * TB, c0 = blockIdx.y * HC;
  const bool lead = blockIdx.y == 0;  // the blocks of the first H slice give dx0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, lr = lane & 7;
  const int wm = warp & 3, wn = warp >> 2;
  const int row_a = wm * 16 + g;  // this thread's rows in the tile: row_a, row_a + 8
  const int n_ot = (o + TO - 1) / TO, steps = n_ot * f_total;

  load_w_tile(ws0, wt, 0, 0, o, hp, ks);
  cp_async_commit();

  const int half = hp / 2;
  for (int i = tid; i < TB * half; i += THREADS) {
    const int r = i / half, k = (i - r * half) * 2, m = r0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (m < m_total) {
      const float* row = xk + size_t(m) * h;
      if (k < h) v0 = row[k];
      if (k + 1 < h) v1 = row[k + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(xs + r * ks + k) = __floats2bfloat162_rn(v0, v1);
  }
  for (int i = tid; i < TB * f_total; i += THREADS) {
    const int m = r0 + i / f_total;
    x0s[i] = m < m_total ? x0[size_t(r0) * f_total + i] : 0.f;
  }

  float acc[2 * NP][4];  // dxk: rows row_a (+8), columns of the pairs this warp owns
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float dyr[NT][4];  // dy at this thread's rows and U columns of the current O tile

  for (int step = 0; step < steps; ++step) {
    const int ot = step / f_total, f = step - ot * f_total, o0 = ot * TO;
    const bf16* ws = (step & 1) ? ws1 : ws0;
    if (f == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = o0 + wn * WARP_N + 8 * j + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = r0 + row_a + 8 * hr;
          const float* src = dy + size_t(m) * o + col;
          dyr[j][2 * hr] = (m < m_total && col < o) ? src[0] : 0.f;
          dyr[j][2 * hr + 1] = (m < m_total && col + 1 < o) ? src[1] : 0.f;
        }
      }
    }
    if (step + 1 < steps) {
      // the other buffer was last read before the barrier closing step - 1
      const int nt = (step + 1) / f_total, nf = step + 1 - nt * f_total;
      load_w_tile((step & 1) ? ws0 : ws1, wt, nf, nt * TO, o, hp, ks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float xa = x0s[row_a * f_total + f], xb = x0s[(row_a + 8) * f_total + f];
    if (lead) {
      // U_f for this thread's rows and columns, then its share of dx0
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
          const bf16* pb = ws + (wn * WARP_N + 8 * j + g) * ks + k + 2 * t;
          uint32_t bb[2];
          bb[0] = *reinterpret_cast<const uint32_t*>(pb);
          bb[1] = *reinterpret_cast<const uint32_t*>(pb + 8);
          mma_bf16(u[j], a, bb);
        }
      }
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sa += u[j][0] * dyr[j][0] + u[j][1] * dyr[j][1];
        sb += u[j][2] * dyr[j][2] + u[j][3] * dyr[j][3];
      }
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      if (t == 0) {
        red[wn * TB + row_a] = sa;
        red[wn * TB + row_a + 8] = sb;
      }
    }
    // du_f = x0[:, f] * dy, rounded to bf16, into shared memory
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn * WARP_N + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dus + row_a * TS + col) =
          __floats2bfloat162_rn(xa * dyr[j][0], xa * dyr[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dus + (row_a + 8) * TS + col) =
          __floats2bfloat162_rn(xb * dyr[j][2], xb * dyr[j][3]);
    }
    __syncthreads();

    if (lead && tid < TB) {
      // one thread per row adds the two column halves, in the same order on every run
      const int m = r0 + tid;
      if (m < m_total) {
        float* p = dx0 + size_t(m) * f_total + f;
        const float v = red[tid] + red[TB + tid];
        *p = ot ? *p + v : v;
      }
    }

    // dxk += du_f @ w1_f^T: A = du rows (K = O), B = the weight tile read transposed
    for (int k = 0; k < TO; k += 16) {
      const bf16* pa = dus + row_a * TS + k + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * TS);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * TS + 8);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int n0 = c0 + (2 * i + wn) * 16;
        if (n0 < hp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ws + (k + lr + 8 * (q & 1)) * ks + n0 + 8 * (q >> 1));
          mma_bf16(acc[2 * i], a, b);
          mma_bf16(acc[2 * i + 1], a, b + 2);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = c0 + (2 * i + wn) * 16 + 8 * jj + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = r0 + row_a + 8 * hr;
        if (m >= m_total) continue;
        float* dst = dxk + size_t(m) * h + col;
        if (col < h) dst[0] = acc[2 * i + jj][2 * hr];
        if (col + 1 < h) dst[1] = acc[2 * i + jj][2 * hr + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    cin_bwd_dw_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                      const float* __restrict__ dy, float* __restrict__ part, int m_total,
                      int h, int f_total, int o, int rows_per_split) {
  __shared__ __align__(16) bf16 xs[KC * XS];  // [row][h]: bf16(xk)
  __shared__ __align__(16) bf16 ds[KC * TS];  // [row][o]: bf16(du)
  const int n_ot = (o + TO - 1) / TO;
  const int h0 = blockIdx.x * WH, f = blockIdx.y / n_ot, o0 = (blockIdx.y % n_ot) * TO;
  const int rb = blockIdx.z * rows_per_split;
  const int re = min(rb + rows_per_split, m_total);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, lr = lane & 7;
  const int wm = warp & 1, wn = warp >> 1;  // 2 warps along H (32 each) x 4 along O (32 each)
  const bool busy = h0 + wm * 32 < pad16(h);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int base = rb; base < re; base += KC) {
    for (int i = tid; i < KC * (WH / 2); i += THREADS) {
      const int r = i / (WH / 2), c = (i - r * (WH / 2)) * 2, m = base + r, k = h0 + c;
      float v0 = 0.f, v1 = 0.f;
      if (m < re) {
        const float* row = xk + size_t(m) * h;
        if (k < h) v0 = row[k];
        if (k + 1 < h) v1 = row[k + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(xs + r * XS + c) = __floats2bfloat162_rn(v0, v1);
    }
    for (int i = tid; i < KC * (TO / 2); i += THREADS) {
      const int r = i / (TO / 2), c = (i - r * (TO / 2)) * 2, m = base + r, col = o0 + c;
      float v0 = 0.f, v1 = 0.f;
      if (m < re) {
        const float a = x0[size_t(m) * f_total + f];
        const float* row = dy + size_t(m) * o;
        if (col < o) v0 = a * row[col];
        if (col + 1 < o) v1 = a * row[col + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(ds + r * TS + c) = __floats2bfloat162_rn(v0, v1);
    }
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int k = 0; k < KC; k += 16) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)  // A = xk^T: the [row][h] stage read transposed
          ldmatrix_x4_trans(a[mi], xs + (k + lr + 8 * (q >> 1)) * XS + wm * 32 + mi * 16 +
                                       8 * (q & 1));
#pragma unroll
        for (int pi = 0; pi < 2; ++pi)  // B = du: the [row][o] stage read transposed
          ldmatrix_x4_trans(b[pi], ds + (k + lr + 8 * (q & 1)) * TS + wn * 32 + pi * 16 +
                                       8 * (q >> 1));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int pi = 0; pi < 2; ++pi) {
            mma_bf16(acc[mi][2 * pi], a[mi], b[pi]);
            mma_bf16(acc[mi][2 * pi + 1], a[mi], b[pi] + 2);
          }
      }
    }
    __syncthreads();
  }

  const int fo = f_total * o;
  float* out = part + size_t(blockIdx.z) * h * fo;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int hh = h0 + wm * 32 + mi * 16 + g + 8 * hr;
        const int col = o0 + wn * 32 + nj * 8 + 2 * t;
        if (hh >= h) continue;
        float* dst = out + size_t(hh) * fo + f * o + col;
        if (col < o) dst[0] = acc[mi][nj][2 * hr];
        if (col + 1 < o) dst[1] = acc[mi][nj][2 * hr + 1];
      }
}

// dw[i] = sum over s of part[s][i], s = 0, 1, ... in order.
__global__ void cin_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                      size_t n, int splits) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * n + i];
    dw[i] = s;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the rows kernel; the caller refuses
// shapes above the card's limit.
size_t cin_bwd_smem_bytes(int h, int f) { return rows_smem_bytes(h, f); }

// Columns of the bf16 weight scratch: H rounded up to a multiple of 16.
int cin_bwd_scratch_cols(int h) { return pad16(h); }

// Splits of the dW product over the rows: the caller allocates (splits, H, F*O)
// f32 partials when this is above 1.
int cin_bwd_splits(int m, int h, int f, int o) {
  int rps, s;
  dw_splits(m, h, f, o, &rps, &s);
  return s;
}

// xk (D, B, H), x0 (D, B, F), w1 (H, F*O), dy (D, B, O) f32 -> dxk (D, B, H),
// dx0 (D, B, F), dw (H, F*O) f32, all contiguous on the current device; wt is
// (F*O, pad16(H)) bf16 scratch, part (cin_bwd_splits(D*B, H, F, O), H, F*O) f32
// scratch (unused when there is one split). Returns the CUDA error code of the
// launches (0 on success).
int cin_bwd(const float* xk, const float* x0, const float* w1, const float* dy, float* dxk,
            float* dx0, float* dw, void* wt, float* part, int d, int b, int h, int f, int o,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = pad16(h), fo = f * o, m = d * b;
  const size_t smem = rows_smem_bytes(h, f);
  cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 prep_grid((fo + 31) / 32, (hp + 31) / 32), prep_block(32, 8);
  w_prep_kernel<<<prep_grid, prep_block, 0, s>>>(w1, static_cast<bf16*>(wt), h, hp, fo);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 rows_grid((m + TB - 1) / TB, (hp + HC - 1) / HC);
  cin_bwd_rows_kernel<<<rows_grid, THREADS, smem, s>>>(
      xk, x0, static_cast<const bf16*>(wt), dy, dxk, dx0, m, h, f, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int rps, splits;
  dw_splits(m, h, f, o, &rps, &splits);
  const dim3 dw_grid((hp + WH - 1) / WH, f * ((o + TO - 1) / TO), splits);
  cin_bwd_dw_kernel<<<dw_grid, THREADS, 0, s>>>(xk, x0, dy, splits > 1 ? part : dw, m, h, f,
                                                o, rps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t n = size_t(h) * fo;
    const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    cin_bwd_reduce_kernel<<<blocks, 256, 0, s>>>(part, dw, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
