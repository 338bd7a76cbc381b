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
// What held the first design back (NVIDIA H100 80GB HBM3, 700 W, CUDA
// events, both layers at D 8, B 4096, F 26, O 128): 1.72 ms against 0.70-0.80
// for three library calls (two bf16 GEMMs on a du already in memory and an
// einsum). Its dW kernel (0.97-1.00 of it) ran one block per (64 columns of H,
// field, split of the rows), so across the grid dy was read F*ceil(H/64)
// times (52 at H 128, about 0.87 GB) and xk F times, with synchronous scalar
// 4-byte staging; its rows kernel (0.67) ran 64-row blocks of 8 warps (169
// registers, one block an SM) that each streamed the whole weight from L2
// (0.44 GB in all) through a 2-deep ring with three barriers a field.
//
// This design, on the same card: 0.74-0.75 ms for the two layers, in the
// spread of the library calls (0.69-0.90 in the same runs); rows 0.17 + 0.30
// ms, dW 0.074 + 0.155, prep and reduce 0.022. What bounds it now is the rows
// kernel's shared-memory traffic: mma.sync makes each of its 16 warps load
// its own A and B fragments, about 2.5 wavefronts an mma, so it runs at about
// 190 TFLOP/s where the tensor cores give 989; wgmma, which reads B from
// shared memory once a warpgroup, is the lever left.
//
// Design: four launches.
//   0. prep_kernel rounds w1 to bf16 and transposes it to wt (F*O, Hp), Hp =
//      pad16(H), as the forward does, and rounds xk once to xb (M, Hp) bf16,
//      which both passes read with 16-byte copies.
//   1. cin_bwd_rows_kernel: one block of 16 warps per 128-row tile (and
//      128-wide slice of H for dxk), twice the rows of the first design, so
//      the weight is streamed from L2 half as often; cin_bwd takes only the
//      shapes whose 128-row tiles fit (Hp <= 176 at F 26). For each (O tile,
//      field f) it streams the (128, Hp) slice of wt through a 2-deep
//      cp.async ring, recomputes U_f = xb @ w1_f with mma.sync m16n8k16
//      (bf16 in, f32 accumulate), reduces U_f * dy over O into dx0, forms the du_f tile
//      (bf16) in one of two shared buffers and accumulates dxk += du_f @
//      w1_f^T in registers, reading the same weight tile transposed with
//      ldmatrix.trans. Two barriers a field. U and du never reach device
//      memory.
//   2. cin_bwd_dw_kernel<HB>: dW as a split-K product over the rows. One
//      block of 16 warps owns HB rows of H and 256 / HB fields of one
//      128-wide O tile (HB 32, 64 or 128 by H: 32 x 1024, 64 x 512 or
//      128 x 256 outputs), so dy is read F*HB/256 times, not F*H/64 times.
//      Stages of 64 rows (32 at HB 32) of xb, dy and x0 come through a
//      3-deep (4-deep) cp.async ring; du for the block's fields is formed
//      once a stage in shared memory, each load of dy serving every field
//      (no U is needed), and each warp multiplies a 32 x 64 tile with
//      ldmatrix-fed mma.sync. The rows are split so that the grid fills the
//      card once (SMs x blocks an SM), and each split writes a fixed partial.
//   3. cin_bwd_reduce_kernel: dW = sum of the partials over the splits, in
//      order.
// No atomics: the same inputs give the same bits on every run. Every kernel
// masks the ragged edges of the rows, H, F and O.
//
// cin_bwd_wide, the second instance of the same contract, takes the shapes
// whose rows pass above does not fit with 128-row tiles (Hp > 176 at F 26;
// kernels/cin.py: backward_instance). The block rows pass has no 64-row
// form: on an NVIDIA H100 80GB HBM3 at 700 W the wide instance took 5-18%
// less time than one at Hp 192 to 288 (F 26 and 39), and 12-43% more than
// the 128-row one at H 26 to 176 (tools/cin_instances.py, PERF.md).
// Only its rows pass differs (cin_bwd_rows_wide_kernel): nothing of width
// Hp is held whole. A block walks a fixed list of items through a 2-deep
// cp.async ring of (128, 128) k-chunks: for each (O tile, field) the blocks
// of the first H slice recompute U_f = xb @ w1_f over the k-chunks of xb and
// wt, in k order (the same mma chain as above, so the two instances give the
// same U), then every block forms du_f and adds du_f @ w1_f^T into its
// 128-wide HC slice of dxk from that slice's chunk of wt. One barrier an
// item and one more for du. prep, dW and the reduce are the ones above, so
// the instance takes every H at F <= 112 (128-row tiles) or F <= 429 (64).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md) the
// backward takes 1.63-1.64 ms at H 384 and 2.14-2.19 at H 512 (F 26, B 4096,
// O 128), 6.4x its bound, against 0.60-0.64 for three library calls: the
// first H slice's blocks walk every k-chunk of U while the others wait on
// one chunk a field, on mma.sync.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates:
// the caller passes the outputs, the bf16 scratch of w1 and xk, and the f32
// partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TO = 128;          // O columns per weight tile or dW tile
// the rows kernel
// rows a block: 128 (16 warps, 8 along the rows x 2 along O for U or H for
// dxk); the wide rows pass takes 64 (8 warps) where F leaves no room for 128
constexpr int TB_MAX = 128;
constexpr int WARP_N = 64;       // U columns per warp
constexpr int NT = WARP_N / 8;   // 8-wide mma tiles per warp in U
constexpr int HC = 128;          // dxk columns (of H) per block
constexpr int NP = HC / 32;      // 16-wide column pairs per warp in dxk (2 warps along H)
constexpr int TS = TO + 8;       // row stride of the du tile, in bf16
// the dW kernel
constexpr int DTHREADS = 512;    // 16 warps, each 32 of H x 64 of O of one field
constexpr int PTHREADS = 256;    // the prep kernel

__host__ __device__ inline int pad16(int h) { return (h + 15) / 16 * 16; }

constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use on the H100

size_t rows_smem_bytes(int tb, int h, int f) {
  const size_t ks = pad16(h) + 8;
  return tb * ks * sizeof(bf16)                // xk tile
         + 2 * TO * ks * sizeof(bf16)          // two weight tiles
         + 2 * size_t(tb) * TS * sizeof(bf16)  // two du tiles
         + size_t(tb) * f * sizeof(float)      // x0 tile
         + 2 * tb * sizeof(float);             // dx0 halves
}

// The wide rows pass: k-chunks of WK columns of H, stored WKS apart.
constexpr int WK = HC;
constexpr int WKS = WK + 8;

size_t rows_wide_smem_bytes(int tb, int f) {
  return 2 * size_t(tb + TO) * WKS * sizeof(bf16)  // two slots: an xb chunk and a wt chunk
         + size_t(tb) * TS * sizeof(bf16)          // the du tile
         + size_t(tb) * f * sizeof(float)          // x0 tile
         + 2 * tb * sizeof(float);                 // dx0 halves
}

int rows_wide_tb(int f) { return rows_wide_smem_bytes(TB_MAX, f) <= SMEM_MAX ? TB_MAX : 64; }

// The dW kernel's layout for HB rows of H a block: G fields, KC rows a stage,
// NS stages in the ring (as many rows in flight as the shared memory holds
// beside the du tile, whose width grows as HB shrinks), stage strides.
template <int HB>
struct DwShape {
  static constexpr int G = 256 / HB;         // fields a block
  static constexpr int KC = HB == 32 ? 32 : 64;
  static constexpr int NS = HB == 32 ? 4 : 3;
  static constexpr int XS = HB + 8;          // row stride of the xb stage, in bf16
  static constexpr int DS = G * TO + 8;      // row stride of the du tile, in bf16
  static constexpr size_t XB = size_t(KC) * XS * sizeof(bf16);
  static constexpr size_t YB = size_t(KC) * TO * sizeof(float);
  static constexpr size_t ZB = size_t(KC) * G * sizeof(float);
  static constexpr size_t STAGE = XB + YB + ZB;
  static constexpr size_t SMEM = NS * STAGE + size_t(KC) * DS * sizeof(bf16);
};

int dw_hb(int h) {
  const int hp = pad16(h);
  return hp <= 32 ? 32 : hp <= 64 ? 64 : 128;
}

size_t dw_smem_bytes(int h) {
  switch (dw_hb(h)) {
    case 32: return DwShape<32>::SMEM;
    case 64: return DwShape<64>::SMEM;
    default: return DwShape<128>::SMEM;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
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

// The first wblocks blocks: wt[r, k] = bf16(w1[k, r]) for k < H, 0 for
// H <= k < Hp, r < F*O, in 32x32 tiles. The rest: xb[m, k] = bf16(xk[m, k])
// for k < H, 0 for H <= k < Hp, eight columns a thread.
__global__ void __launch_bounds__(PTHREADS)
    prep_kernel(const float* __restrict__ w1, bf16* __restrict__ wt, const float* __restrict__ xk,
                bf16* __restrict__ xb, int h, int hp, int fo, int m_total, int wblocks_x,
                int wblocks) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < wblocks) {
    __shared__ float tile[32][33];
    const int r0 = (blockIdx.x % wblocks_x) * 32, k0 = (blockIdx.x / wblocks_x) * 32;
    const int tx = tid & 31, ty = tid >> 5;
    for (int i = ty; i < 32; i += PTHREADS / 32) {
      const int k = k0 + i, r = r0 + tx;
      tile[i][tx] = (k < h && r < fo) ? w1[size_t(k) * fo + r] : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += PTHREADS / 32) {
      const int r = r0 + i, k = k0 + tx;
      if (r < fo && k < hp) wt[size_t(r) * hp + k] = __float2bfloat16_rn(tile[tx][i]);
    }
    return;
  }
  const int per_row = hp / 8;
  const int64_t idx = int64_t(blockIdx.x - wblocks) * PTHREADS + tid;
  const int64_t m = idx / per_row;
  if (m >= m_total) return;
  const int k0 = static_cast<int>(idx - m * per_row) * 8;
  const float* src = xk + m * h;
  __align__(16) __nv_bfloat162 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 2 * j;
    v[j] = __floats2bfloat162_rn(k < h ? src[k] : 0.f, k + 1 < h ? src[k + 1] : 0.f);
  }
  *reinterpret_cast<uint4*>(xb + m * hp + k0) = *reinterpret_cast<const uint4*>(v);
}

// Starts the copy of the (TO, Hp) weight tile of field f, O columns o0.., into
// ws (row n = column o0 + n of the field); rows past O are zeroed.
template <int THREADS>
__device__ __forceinline__ void load_w_tile(bf16* ws, const bf16* __restrict__ wt, int f,
                                            int o0, int o, int hp, int ks) {
  const int chunks = hp / 8;  // 16-byte chunks in a row
  for (int i = threadIdx.x; i < TO * chunks; i += THREADS) {
    const int n = i / chunks, c = i - n * chunks;
    const bool ok = o0 + n < o;
    cp_async16(ws + n * ks + c * 8, ok ? wt + size_t(f * o + o0 + n) * hp + c * 8 : wt,
               ok ? 16 : 0);
  }
}

template <int TB>
__global__ void __launch_bounds__(TB * 4, 1)
    cin_bwd_rows_kernel(const bf16* __restrict__ xb, const float* __restrict__ x0,
                        const bf16* __restrict__ wt, const float* __restrict__ dy,
                        float* __restrict__ dxk, float* __restrict__ dx0, int m_total,
                        int h, int f_total, int o) {
  constexpr int RTHREADS = TB * 4, ROW_WARPS = TB / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = pad16(h), ks = hp + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ring = xs + TB * ks;           // two (TO, ks) weight tiles
  bf16* dus = ring + 2 * TO * ks;      // two (TB, TS) du tiles
  float* x0s = reinterpret_cast<float*>(dus + 2 * TB * TS);
  float* red = x0s + TB * f_total;

  const int r0 = blockIdx.x * TB, c0 = blockIdx.y * HC;
  const bool lead = blockIdx.y == 0;  // the blocks of the first H slice give dx0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, lr = lane & 7;
  const int wm = warp % ROW_WARPS, wn = warp / ROW_WARPS;
  const int row_a = wm * 16 + g;  // this thread's rows in the tile: row_a, row_a + 8
  const int n_ot = (o + TO - 1) / TO, steps = n_ot * f_total;

  // the bf16 rows of xk and the first weight tile, in one group
  const int xchunks = hp / 8;
  for (int i = tid; i < TB * xchunks; i += RTHREADS) {
    const int r = i / xchunks, c = i - r * xchunks;
    const bool ok = r0 + r < m_total;
    cp_async16(xs + r * ks + c * 8, ok ? xb + size_t(r0 + r) * hp + c * 8 : xb, ok ? 16 : 0);
  }
  load_w_tile<RTHREADS>(ring, wt, 0, 0, o, hp, ks);
  cp_async_commit();
  for (int i = tid; i < TB * f_total; i += RTHREADS) {
    const int m = r0 + i / f_total;
    x0s[i] = m < m_total ? x0[size_t(r0) * f_total + i] : 0.f;
  }

  float acc[2 * NP][4];  // dxk: rows row_a (+8), columns of the pairs this warp owns
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float dyr[NT][4];  // dy at this thread's rows and U columns of the current O tile

  for (int step = 0; step < steps; ++step) {
    const int ot = step / f_total, f = step - ot * f_total, o0 = ot * TO;
    const bf16* ws = ring + (step & 1) * TO * ks;
    bf16* du = dus + (step & 1) * TB * TS;
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
    cp_async_wait<0>();
    // the weight tile of this step is in; every warp is done with step - 1,
    // so the other ring slot and the du tile of step - 2 are free
    __syncthreads();
    if (step + 1 < steps) {
      const int nt = (step + 1) / f_total, nf = step + 1 - nt * f_total;
      load_w_tile<RTHREADS>(ring + ((step + 1) & 1) * TO * ks, wt, nf, nt * TO, o, hp, ks);
      cp_async_commit();
    }

    const float xa = x0s[row_a * f_total + f], xc = x0s[(row_a + 8) * f_total + f];
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
      *reinterpret_cast<__nv_bfloat162*>(du + row_a * TS + col) =
          __floats2bfloat162_rn(xa * dyr[j][0], xa * dyr[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(du + (row_a + 8) * TS + col) =
          __floats2bfloat162_rn(xc * dyr[j][2], xc * dyr[j][3]);
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
      const bf16* pa = du + row_a * TS + k + 2 * t;
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

// Starts the copy of rows row0 .. row0 + ROWS of a (., hp) bf16 matrix,
// columns col0 .. col0 + WK, into dst (stride WKS); zero past `valid` rows
// and past hp.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ src, size_t row0,
                                           int valid, int hp, int col0) {
  constexpr int CH = WK / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < valid && col0 + c < hp;
    cp_async16(dst + r * WKS + c, ok ? src + (row0 + r) * hp + col0 + c : src, ok ? 16 : 0);
  }
}

// The rows pass of cin_bwd_wide. Item i of a block: with per = n_c + 1 items
// a step in the first H slice (n_c U chunks, then the dxk chunk) and 1
// elsewhere, step i / per = (O tile, field) and chunk i % per.
template <int TB>
__global__ void __launch_bounds__(TB * 4, 1)
    cin_bwd_rows_wide_kernel(const bf16* __restrict__ xb, const float* __restrict__ x0,
                             const bf16* __restrict__ wt, const float* __restrict__ dy,
                             float* __restrict__ dxk, float* __restrict__ dx0, int m_total,
                             int h, int f_total, int o) {
  constexpr int RTHREADS = TB * 4, ROW_WARPS = TB / 16;
  constexpr int SLOT = (TB + TO) * WKS;  // bf16 elements of a ring slot
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = pad16(h);
  bf16* ring = reinterpret_cast<bf16*>(smem);  // slot: xb chunk (TB rows), then wt chunk (TO)
  bf16* du = ring + 2 * SLOT;
  float* x0s = reinterpret_cast<float*>(du + TB * TS);
  float* red = x0s + TB * f_total;

  const int r0 = blockIdx.x * TB, c0 = blockIdx.y * HC;
  const bool lead = blockIdx.y == 0;  // the blocks of the first H slice give dx0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, lr = lane & 7;
  const int wm = warp % ROW_WARPS, wn = warp / ROW_WARPS;
  const int row_a = wm * 16 + g;  // this thread's rows in the tile: row_a, row_a + 8
  const int n_ot = (o + TO - 1) / TO, steps = n_ot * f_total;
  const int n_c = (hp + WK - 1) / WK, per = lead ? n_c + 1 : 1, items = steps * per;

  // item i's chunks into ring slot i & 1
  auto load_item = [&](int i) {
    const int step = i / per, c = i - step * per;
    const int ot = step / f_total, f = step - ot * f_total, o0 = ot * TO;
    bf16* slot = ring + (i & 1) * SLOT;
    const size_t wrow = size_t(f) * o + o0;
    if (c < per - 1) {  // a U chunk: xb and wt at columns c * WK
      load_chunk<TB, RTHREADS>(slot, xb, r0, m_total - r0, hp, c * WK);
      load_chunk<TO, RTHREADS>(slot + TB * WKS, wt, wrow, o - o0, hp, c * WK);
    } else {  // the dxk chunk: wt at this block's H slice
      load_chunk<TO, RTHREADS>(slot + TB * WKS, wt, wrow, o - o0, hp, c0);
    }
    cp_async_commit();
  };

  load_item(0);
  for (int i = tid; i < TB * f_total; i += RTHREADS) {
    const int m = r0 + i / f_total;
    x0s[i] = m < m_total ? x0[size_t(r0) * f_total + i] : 0.f;
  }

  float acc[2 * NP][4];  // dxk: rows row_a (+8), columns of the pairs this warp owns
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float dyr[NT][4];  // dy at this thread's rows and U columns of the current O tile
  float u[NT][4];    // U_f at this thread's rows and columns, over the U chunks

  for (int it = 0; it < items; ++it) {
    const int step = it / per, c = it - step * per;
    const int ot = step / f_total, f = step - ot * f_total, o0 = ot * TO;
    if (f == 0 && c == 0) {
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
    cp_async_wait<0>();
    // item it is in; every warp is done with item it - 1, whose slot is free
    __syncthreads();
    if (it + 1 < items) load_item(it + 1);
    const bf16* xs = ring + (it & 1) * SLOT;
    const bf16* ws = xs + TB * WKS;

    if (c < per - 1) {
      // U_f over this chunk's k, continuing the chain of the earlier chunks
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j) u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
      }
      const int kw = min(WK, hp - c * WK);
      for (int k = 0; k < kw; k += 16) {
        const bf16* pa = xs + row_a * WKS + k + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(pa);
        a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * WKS);
        a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * WKS + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const bf16* pb = ws + (wn * WARP_N + 8 * j + g) * WKS + k + 2 * t;
          uint32_t bb[2];
          bb[0] = *reinterpret_cast<const uint32_t*>(pb);
          bb[1] = *reinterpret_cast<const uint32_t*>(pb + 8);
          mma_bf16(u[j], a, bb);
        }
      }
      if (c == per - 2) {  // U_f is whole: this thread's share of dx0
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
      continue;
    }

    // du_f = x0[:, f] * dy, rounded to bf16, into shared memory
    const float xa = x0s[row_a * f_total + f], xc = x0s[(row_a + 8) * f_total + f];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn * WARP_N + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(du + row_a * TS + col) =
          __floats2bfloat162_rn(xa * dyr[j][0], xa * dyr[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(du + (row_a + 8) * TS + col) =
          __floats2bfloat162_rn(xc * dyr[j][2], xc * dyr[j][3]);
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

    // dxk += du_f @ w1_f^T over this block's H slice, the chunk read transposed
    for (int k = 0; k < TO; k += 16) {
      const bf16* pa = du + row_a * TS + k + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(pa);
      a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * TS);
      a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * TS + 8);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int n0 = (2 * i + wn) * 16;  // in the slice
        if (c0 + n0 < hp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, ws + (k + lr + 8 * (q & 1)) * WKS + n0 + 8 * (q >> 1));
          mma_bf16(acc[2 * i], a, b);
          mma_bf16(acc[2 * i + 1], a, b + 2);
        }
      }
    }
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

// Starts the copies of one stage: rows [m0, m0 + KC) of xb (columns h0..h0+HB),
// dy (columns o0..o0+TO) and x0 (the block's fields f0..f0+G), zero past the
// split's end re, past Hp, O and F.
template <int HB, bool DY16>
__device__ __forceinline__ void load_dw_stage(unsigned char* st, const bf16* __restrict__ xb,
                                              const float* __restrict__ x0,
                                              const float* __restrict__ dy, int m0, int re,
                                              int hp, int h0, int f_total, int f0, int o,
                                              int o0) {
  using S = DwShape<HB>;
  bf16* xs = reinterpret_cast<bf16*>(st);
  float* ys = reinterpret_cast<float*>(st + S::XB);
  float* zs = reinterpret_cast<float*>(st + S::XB + S::YB);
  const int tid = threadIdx.x;
  constexpr int KC = S::KC;
  for (int i = tid; i < KC * (HB / 8); i += DTHREADS) {
    const int r = i / (HB / 8), c = (i - r * (HB / 8)) * 8;
    const bool ok = m0 + r < re && h0 + c < hp;
    cp_async16(xs + r * S::XS + c, ok ? xb + size_t(m0 + r) * hp + h0 + c : xb, ok ? 16 : 0);
  }
  if (DY16) {
    for (int i = tid; i < KC * (TO / 4); i += DTHREADS) {
      const int r = i / (TO / 4), c = (i - r * (TO / 4)) * 4;
      const bool ok = m0 + r < re && o0 + c < o;
      cp_async16(ys + r * TO + c, ok ? dy + size_t(m0 + r) * o + o0 + c : dy, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < KC * TO; i += DTHREADS) {
      const int r = i / TO, c = i - r * TO;
      const bool ok = m0 + r < re && o0 + c < o;
      cp_async4(ys + i, ok ? dy + size_t(m0 + r) * o + o0 + c : dy, ok ? 4 : 0);
    }
  }
  for (int i = tid; i < KC * S::G; i += DTHREADS) {
    const int r = i / S::G, j = i - r * S::G;
    const bool ok = m0 + r < re && f0 + j < f_total;
    cp_async4(zs + i, ok ? x0 + size_t(m0 + r) * f_total + f0 + j : x0, ok ? 4 : 0);
  }
}

// One block: dW[h0 + (0..HB), (f0 + (0..G)) * O + o0 + (0..TO)] summed over the
// rows of split blockIdx.z, into part[blockIdx.z] (or dw with one split).
template <int HB, bool DY16>
__global__ void __launch_bounds__(DTHREADS, 1)
    cin_bwd_dw_kernel(const bf16* __restrict__ xb, const float* __restrict__ x0,
                      const float* __restrict__ dy, float* __restrict__ part, int m_total, int h,
                      int f_total, int o, int rows_per_split) {
  using S = DwShape<HB>;
  constexpr int KC = S::KC, NS = S::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ds = reinterpret_cast<bf16*>(smem + NS * S::STAGE);  // [row][G * TO]: bf16(du)
  const int hp = pad16(h), n_hb = (hp + HB - 1) / HB;
  const int h0 = (blockIdx.x % n_hb) * HB, f0 = (blockIdx.x / n_hb) * S::G;
  const int o0 = blockIdx.y * TO;
  const int rb = blockIdx.z * rows_per_split;
  const int re = min(rb + rows_per_split, m_total);
  const int chunks = (re - rb + KC - 1) / KC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, lr = lane & 7;
  // this warp: field slot fs, 32 rows hs*32.. of the block's H, 64 columns oh*64.. of O
  const int fs = warp / (HB / 16), hs = (warp % (HB / 16)) >> 1, oh = warp & 1;
  const bool busy = f0 + fs < f_total && h0 + hs * 32 < hp && o0 + oh * 64 < o;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < chunks)
      load_dw_stage<HB, DY16>(smem + s * S::STAGE, xb, x0, dy, rb + s * KC, re, hp, h0, f_total,
                              f0, o, o0);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<NS - 2>();
    // stage c is in; every warp is done with chunk c - 1 (its stage and ds)
    __syncthreads();
    if (c + NS - 1 < chunks)
      load_dw_stage<HB, DY16>(smem + ((c + NS - 1) % NS) * S::STAGE, xb, x0, dy,
                              rb + (c + NS - 1) * KC, re, hp, h0, f_total, f0, o, o0);
    cp_async_commit();
    const unsigned char* st = smem + (c % NS) * S::STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const float* ys = reinterpret_cast<const float*>(st + S::XB);
    const float* zs = reinterpret_cast<const float*>(st + S::XB + S::YB);
    // du = bf16(x0[:, f] * dy) for the block's fields: four columns of dy
    // read once, then multiplied by each field's x0
    for (int i = tid; i < KC * (TO / 4); i += DTHREADS) {
      const int r = i / (TO / 4), c4 = (i - r * (TO / 4)) * 4;
      const float4 y = *reinterpret_cast<const float4*>(ys + r * TO + c4);
#pragma unroll
      for (int j = 0; j < S::G; ++j) {
        const float a = zs[r * S::G + j];
        __align__(8) __nv_bfloat162 v[2];
        v[0] = __floats2bfloat162_rn(a * y.x, a * y.y);
        v[1] = __floats2bfloat162_rn(a * y.z, a * y.w);
        *reinterpret_cast<uint2*>(ds + r * S::DS + j * TO + c4) =
            *reinterpret_cast<const uint2*>(v);
      }
    }
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int k = 0; k < KC; k += 16) {
        uint32_t a[2][4], b[4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)  // A = xb^T: the [row][h] stage read transposed
          ldmatrix_x4_trans(a[mi], xs + (k + lr + 8 * (q >> 1)) * S::XS + hs * 32 + mi * 16 +
                                       8 * (q & 1));
#pragma unroll
        for (int pi = 0; pi < 4; ++pi)  // B = du: the [row][o] tile read transposed
          ldmatrix_x4_trans(b[pi], ds + (k + lr + 8 * (q & 1)) * S::DS + fs * TO + oh * 64 +
                                       pi * 16 + 8 * (q >> 1));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int pi = 0; pi < 4; ++pi) {
            mma_bf16(acc[mi][2 * pi], a[mi], b[pi]);
            mma_bf16(acc[mi][2 * pi + 1], a[mi], b[pi] + 2);
          }
      }
    }
  }
  cp_async_wait<0>();

  if (!busy) return;
  const int fo = f_total * o, f = f0 + fs;
  float* out = part + size_t(blockIdx.z) * h * fo;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int hh = h0 + hs * 32 + mi * 16 + g + 8 * hr;
        const int col = o0 + oh * 64 + nj * 8 + 2 * t;
        if (hh >= h) continue;
        float* dst = out + size_t(hh) * fo + size_t(f) * o + col;
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

template <int TB>
cudaError_t rows_launch(const bf16* xb, const float* x0, const bf16* wt, const float* dy,
                        float* dxk, float* dx0, int m, int h, int f, int o, cudaStream_t s) {
  const size_t smem = rows_smem_bytes(TB, h, f);
  const cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_rows_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TB - 1) / TB, (pad16(h) + HC - 1) / HC);
  cin_bwd_rows_kernel<TB><<<grid, TB * 4, smem, s>>>(xb, x0, wt, dy, dxk, dx0, m, h, f, o);
  return cudaGetLastError();
}

template <int TB>
cudaError_t rows_wide_launch(const bf16* xb, const float* x0, const bf16* wt, const float* dy,
                             float* dxk, float* dx0, int m, int h, int f, int o,
                             cudaStream_t s) {
  const size_t smem = rows_wide_smem_bytes(TB, f);
  const cudaError_t err =
      cudaFuncSetAttribute(cin_bwd_rows_wide_kernel<TB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TB - 1) / TB, (pad16(h) + HC - 1) / HC);
  cin_bwd_rows_wide_kernel<TB><<<grid, TB * 4, smem, s>>>(xb, x0, wt, dy, dxk, dx0, m, h, f, o);
  return cudaGetLastError();
}

// Blocks of cin_bwd_dw_kernel<HB> an SM, with its shared memory allowed.
template <int HB>
cudaError_t dw_per_sm(int* n) {
  cudaError_t err = cudaFuncSetAttribute(cin_bwd_dw_kernel<HB, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(DwShape<HB>::SMEM));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, cin_bwd_dw_kernel<HB, true>, DTHREADS,
                                                       DwShape<HB>::SMEM);
}

// Rows per split of the dW product (a multiple of KC) and the number of
// splits: enough blocks to fill every SM of the current device once.
cudaError_t dw_splits(int m, int h, int f, int o, int* rows_per_split, int* splits) {
  const int hb = dw_hb(h), g = 256 / hb;
  const int tiles = (pad16(h) + hb - 1) / hb * ((f + g - 1) / g) * ((o + TO - 1) / TO);
  // the SM count and blocks an SM of each dW instance, asked once a device
  static int known_sms[64], known_per_sm[3][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int which = hb == 32 ? 0 : hb == 64 ? 1 : 2;
  int sms = dev < 64 ? known_sms[dev] : 0, per_sm = dev < 64 ? known_per_sm[which][dev] : 0;
  if (sms == 0 || per_sm == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = hb == 32 ? dw_per_sm<32>(&per_sm) : hb == 64 ? dw_per_sm<64>(&per_sm)
                                                          : dw_per_sm<128>(&per_sm);
    if (err != cudaSuccess) return err;
    if (dev < 64) {
      known_sms[dev] = sms;
      known_per_sm[which][dev] = per_sm;
    }
  }
  const int kc = hb == 32 ? DwShape<32>::KC : hb == 64 ? DwShape<64>::KC : DwShape<128>::KC;
  const int chunks = (m + kc - 1) / kc;
  int s = sms * (per_sm > 0 ? per_sm : 1) / tiles;
  if (s > chunks) s = chunks;
  if (s < 1) s = 1;
  const int rps = (chunks + s - 1) / s * kc;
  *rows_per_split = rps;
  *splits = (m + rps - 1) / rps;
  return cudaSuccess;
}

template <int HB, bool DY16>
cudaError_t dw_launch(const bf16* xb, const float* x0, const float* dy, float* out, int m, int h,
                      int f, int o, int rps, int splits, cudaStream_t s) {
  using S = DwShape<HB>;
  const cudaError_t err = cudaFuncSetAttribute(cin_bwd_dw_kernel<HB, DY16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(S::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((pad16(h) + HB - 1) / HB * ((f + S::G - 1) / S::G), (o + TO - 1) / TO, splits);
  cin_bwd_dw_kernel<HB, DY16><<<grid, DTHREADS, S::SMEM, s>>>(xb, x0, dy, out, m, h, f, o, rps);
  return cudaGetLastError();
}

template <int HB>
cudaError_t dw_dispatch(bool dy16, const bf16* xb, const float* x0, const float* dy, float* out,
                      int m, int h, int f, int o, int rps, int splits, cudaStream_t s) {
  return dy16 ? dw_launch<HB, true>(xb, x0, dy, out, m, h, f, o, rps, splits, s)
              : dw_launch<HB, false>(xb, x0, dy, out, m, h, f, o, rps, splits, s);
}

// prep, the rows pass (the wide one with `wide`), dW and its reduce.
int backward(bool wide, const float* xk, const float* x0, const float* w1, const float* dy,
             float* dxk, float* dx0, float* dw, void* wt, void* xb, float* part, int d, int b,
             int h, int f, int o, cudaStream_t s) {
  const int hp = pad16(h), fo = f * o, m = d * b;
  const int wbx = (fo + 31) / 32, wblocks = wbx * ((hp + 31) / 32);
  const long long xblocks = (static_cast<long long>(m) * (hp / 8) + PTHREADS - 1) / PTHREADS;
  prep_kernel<<<static_cast<unsigned>(wblocks + xblocks), PTHREADS, 0, s>>>(
      w1, static_cast<bf16*>(wt), xk, static_cast<bf16*>(xb), h, hp, fo, m, wbx, wblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* xbc = static_cast<const bf16*>(xb);
  const bf16* wtc = static_cast<const bf16*>(wt);
  if (wide) {
    err = rows_wide_tb(f) == TB_MAX
              ? rows_wide_launch<TB_MAX>(xbc, x0, wtc, dy, dxk, dx0, m, h, f, o, s)
              : rows_wide_launch<64>(xbc, x0, wtc, dy, dxk, dx0, m, h, f, o, s);
  } else {
    err = rows_launch<TB_MAX>(xbc, x0, wtc, dy, dxk, dx0, m, h, f, o, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int rps, splits;
  if ((err = dw_splits(m, h, f, o, &rps, &splits)) != cudaSuccess) return static_cast<int>(err);
  const bool dy16 = o % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  float* out = splits > 1 ? part : dw;
  const int hb = dw_hb(h);
  err = hb == 32   ? dw_dispatch<32>(dy16, xbc, x0, dy, out, m, h, f, o, rps, splits, s)
        : hb == 64 ? dw_dispatch<64>(dy16, xbc, x0, dy, out, m, h, f, o, rps, splits, s)
                   : dw_dispatch<128>(dy16, xbc, x0, dy, out, m, h, f, o, rps, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t n = size_t(h) * fo;
    const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    cin_bwd_reduce_kernel<<<blocks, 256, 0, s>>>(part, dw, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of the largest block of the backward; the caller
// refuses shapes above the card's limit.
size_t cin_bwd_smem_bytes(int h, int f) {
  const size_t rows = rows_smem_bytes(TB_MAX, h, f), dw = dw_smem_bytes(h);
  return rows > dw ? rows : dw;
}

// Columns of the bf16 scratch of w1 and xk: H rounded up to a multiple of 16.
int cin_bwd_scratch_cols(int h) { return pad16(h); }

// Splits of the dW product over the rows on the current device: the caller
// allocates (splits, H, F*O) f32 partials when this is above 1. Negative: a
// CUDA error code, negated.
int cin_bwd_splits(int m, int h, int f, int o) {
  int rps, s;
  const cudaError_t err = dw_splits(m, h, f, o, &rps, &s);
  return err == cudaSuccess ? s : -static_cast<int>(err);
}

// xk (D, B, H), x0 (D, B, F), w1 (H, F*O), dy (D, B, O) f32 -> dxk (D, B, H),
// dx0 (D, B, F), dw (H, F*O) f32, all contiguous on the current device; wt is
// (F*O, pad16(H)) and xb (D*B, pad16(H)) bf16 scratch, part
// (cin_bwd_splits(D*B, H, F, O), H, F*O) f32 scratch (unused when there is one
// split). Returns the CUDA error code of the launches (0 on success;
// cudaErrorInvalidValue, with nothing launched, where the shared memory would
// exceed the card's limit).
int cin_bwd(const float* xk, const float* x0, const float* w1, const float* dy, float* dxk,
            float* dx0, float* dw, void* wt, void* xb, float* part, int d, int b, int h, int f,
            int o, void* stream) {
  if (cin_bwd_smem_bytes(h, f) > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return backward(false, xk, x0, w1, dy, dxk, dx0, dw, wt, xb, part, d, b, h, f, o,
                  static_cast<cudaStream_t>(stream));
}

// The wide instance's dynamic shared memory of its largest block.
size_t cin_bwd_wide_smem_bytes(int h, int f) {
  const size_t rows = rows_wide_smem_bytes(rows_wide_tb(f), f), dw = dw_smem_bytes(h);
  return rows > dw ? rows : dw;
}

// The contract of cin_bwd, with the wide rows pass.
int cin_bwd_wide(const float* xk, const float* x0, const float* w1, const float* dy, float* dxk,
                 float* dx0, float* dw, void* wt, void* xb, float* part, int d, int b, int h,
                 int f, int o, void* stream) {
  if (cin_bwd_wide_smem_bytes(h, f) > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return backward(true, xk, x0, w1, dy, dxk, dx0, dw, wt, xb, part, d, b, h, f, o,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
