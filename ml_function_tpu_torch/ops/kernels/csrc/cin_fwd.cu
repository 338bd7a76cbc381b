// CIN layer forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces ml_function_tpu/ops/kernels/cin.py::_fwd_kernel (launched there by
// _fwd_call). On activations in the (D, B, .) layout it computes
//
//   y[d,b,o] = sum_f x0[d,b,f] * sum_h bf16(xk[d,b,h]) * bf16(w1[h, f*O + o])
//
// with f32 products and sums. Only xk and w1 are rounded to bf16; x0 stays f32
// and multiplies each field's product U_f after the tensor cores, as in the
// TPU kernel.
//
// What bounds it on the H100: at the second CIN layer of xDeepFM (H = 128,
// F = 26, O = 128) the product xk @ w1 does 2*D*B*H*F*O flops for about
// 4*D*B*(H + F + O) bytes of input and output, some 700 flops a byte: the
// tensor cores bound it (28 us at 989 TFLOP/s). The first layer (H = 26) is
// bound by memory (7 us). The TPU kernel held the whole (H, F*O) weight in
// VMEM; at H = 128 that is 852 KB in bf16, far above the 227 KB of shared
// memory a block may use, and the (rows, F*O) product U does not fit either.
//
// Design: a block takes 128 batch rows, one 128-wide O tile and one d, with
// two consumer warpgroups of 64 rows and one producer warp. The consumers
// round the block's (128, H) slice of xk to bf16 once, into shared memory in
// the layout wgmma reads (8 x 8 core matrices, H zero-padded to Hp, a
// multiple of 16), and stage x0's (128, F) slice in f32. A prep launch first
// rounds w1 to bf16 and writes each field's (128, Hp) weight tile, O padded
// with zeros, as one contiguous block in that same layout, so the producer
// moves a tile with one bulk copy (cp.async.bulk, the TMA's plain form) into
// a ring of 2 to 8 stages (fewer only where F is), each guarded by a full
// and an empty mbarrier: fields are in flight while earlier ones are
// multiplied, with no block-wide
// barrier in the loop. For each field f a consumer warpgroup forms
// U_f = xk @ w1_f (64 x 128, f32 in 64 registers a thread) from zero with
// Hp / 16 chained wgmma m64n128k16 (bf16 in, f32 accumulate), both operands
// read from shared memory, releases the stage, and folds x0[:, f] * U_f into
// its f32 output accumulator on the CUDA cores. Each weight tile thus serves
// 128 rows and the xk tile all F fields. Fields are not chained through the
// tensor cores' accumulator, whose f32 sums truncate: each U_f is formed from
// zero and the sum over fields is rounded to nearest. Neither U nor the
// interaction tensor Z reaches device memory. Rows past B and columns past O
// are zero in shared memory and not stored. The k-steps of a field are
// unrolled (one instance a Hp / 16 of 1 to 8, a looped one past that) and
// the accumulator's registers are fenced around each field, so the wgmma of
// a field issue back to back.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) xDeepFM's two layers take
// 0.0294 and 0.0603-0.0605 ms on the device, prep launch included, against
// 0.0769-0.0771 and 0.1903-0.1936 ms for the mma.sync kernel this replaced:
// 2.5x their bound together. What holds them: within a warpgroup a
// field's wgmma, its wait and the fold run in turn, which leaves the first
// layer (two k-steps a field) latency-bound, and each block stages its xk
// tile before its first field with nothing to overlap it (one block an SM).
//
// cin_fwd_wide, the second instance of the same contract, takes the shapes
// whose whole (128, Hp) xk tile and two (128, Hp) weight stages do not fit
// beside x0 (Hp > 272 at F 26; kernels/cin.py: forward_instance). Where one
// stage would still fit (Hp 288 to 416 at F 26) it takes 1-13% less time
// than a one-stage block instance would, whose copies and products run in
// turn; at H 26 to 256, with two stages or more, 2-52% more (F 26 and 39;
// NVIDIA H100 80GB HBM3 at 700 W; tools/cin_instances.py, PERF.md). A block
// takes 64 rows (one consumer warpgroup) and keeps their (64, Hq) bf16 xk
// tile whole, Hq = H rounded up to 64, at most 184 KB; the weight comes
// through the same kind of bulk-copy ring in (128, 64) k-chunks of 16 KB,
// each its own core-matrix block, written so by the prep launch. For each
// field U_f is formed from zero as one chain of Hq / 16 wgmma in k order,
// four a chunk, the next chunk's issued before the last one's wait, and then
// folded as above, so U and Z still never reach device memory, and at an H
// that both instances take the two give the same bits. The ring needs two
// stages, so the instance holds Hq <= 1472 at F <= 39 (the wrapper raises
// past it). On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md)
// it takes 0.22 ms at (D 8, B 4096, F 26, H 512, O 128), 2.0x its
// tensor-core bound, against 0.33-0.35 ms for a bf16 GEMM and the F-reduce.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates:
// the caller passes y and the bf16 scratch for the weight tiles
// (cin_fwd_scratch_rows x cin_fwd_scratch_cols, or cin_fwd_wide_scratch_elems).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 128;                  // batch rows a block: two warpgroups of 64
constexpr int TN = 128;                  // output columns a block (wgmma N)
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 8;
constexpr size_t SMEM_LIMIT = 232448;    // shared memory a block may use on the H100
constexpr size_t BAR_BYTES = 128;        // the full and empty mbarriers
// the wide instance
constexpr int WTM = 64;                    // batch rows a block: one warpgroup
constexpr int WCONSUMERS = 128;
constexpr int WTHREADS = WCONSUMERS + 32;  // and one producer warp
constexpr int KC = 64;                     // k of a weight chunk
constexpr int MIN_WIDE_STAGES = 2;         // a chunk is released after the next one's issue

__host__ __device__ inline int pad16(int h) { return (h + 15) / 16 * 16; }
__host__ __device__ inline int pad64(int h) { return (h + 63) / 64 * 64; }

// Offset in elements of (row, k) in a tile of rows x hp bf16 in the core-matrix
// layout wgmma reads without swizzle: 8 rows x 8 k (128 contiguous bytes) a
// core matrix, the K-adjacent core matrices 128 bytes apart (the descriptor's
// leading byte offset), 8-row groups 16 * hp bytes apart (its stride byte
// offset).
__host__ __device__ inline int core_offset(int row, int k, int hp) {
  return (row >> 3) * 8 * hp + (k >> 3) * 64 + (row & 7) * 8 + (k & 7);
}

// Shared memory of a block: mbarriers, the xk tile, the weight ring, x0.
struct Plan {
  int hp, stages;
  size_t a_off, w_off, x0_off, total;
};

Plan plan(int h, int f) {
  Plan p;
  p.hp = pad16(h);
  const size_t tile = size_t(TN) * p.hp * sizeof(bf16);
  p.a_off = BAR_BYTES;
  p.w_off = p.a_off + size_t(TM) * p.hp * sizeof(bf16);
  const size_t x0_bytes = size_t(TM) * f * sizeof(float);
  // two stages at least, so that one field's copy overlaps another's
  // product; where two do not fit, total is past the card's limit
  int s = MAX_STAGES < f ? MAX_STAGES : (f > 0 ? f : 1);
  const int least = s < 2 ? s : 2;
  while (s > least && p.w_off + s * tile + x0_bytes > SMEM_LIMIT) --s;
  p.stages = s;
  p.x0_off = p.w_off + s * tile;
  p.total = p.x0_off + x0_bytes;
  return p;
}

// The wide instance's: mbarriers, the (64, Hq) xk tile, the chunk ring, x0.
// Where two stages do not fit, total is past the card's limit.
Plan wide_plan(int h, int f) {
  Plan p;
  p.hp = pad64(h);
  const size_t chunk = size_t(TN) * KC * sizeof(bf16);
  p.a_off = BAR_BYTES;
  p.w_off = p.a_off + size_t(WTM) * p.hp * sizeof(bf16);
  const size_t x0_bytes = size_t(WTM) * f * sizeof(float);
  int s = MAX_STAGES;
  while (s > MIN_WIDE_STAGES && p.w_off + s * chunk + x0_bytes > SMEM_LIMIT) --s;
  p.stages = s;
  p.x0_off = p.w_off + s * chunk;
  p.total = p.x0_off + x0_bytes;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16) from device to shared memory,
// counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major core-matrix tile without
// swizzle: start address, leading byte offset 128 (the next 8 k), stride
// byte offset 16 * hp (the next 8 rows), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int hp) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t((16 * hp) >> 4) << 32);
}

// Keeps the compiler from moving accesses of the 64 accumulator registers
// across the wgmma sequence (it would otherwise fence each wgmma alone).
__device__ __forceinline__ void fence_operands(float* u) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(u[i])::"memory");
}

// u (+)= A (64 x 16) @ B (16 x 128) for one warpgroup, bf16 in, f32 in
// registers; with accumulate false, u = A @ B.
__device__ __forceinline__ void wgmma_128(float* u, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(u[0]), "+f"(u[1]), "+f"(u[2]), "+f"(u[3]), "+f"(u[4]), "+f"(u[5]), "+f"(u[6]),
        "+f"(u[7]), "+f"(u[8]), "+f"(u[9]), "+f"(u[10]), "+f"(u[11]), "+f"(u[12]), "+f"(u[13]),
        "+f"(u[14]), "+f"(u[15]), "+f"(u[16]), "+f"(u[17]), "+f"(u[18]), "+f"(u[19]),
        "+f"(u[20]), "+f"(u[21]), "+f"(u[22]), "+f"(u[23]), "+f"(u[24]), "+f"(u[25]),
        "+f"(u[26]), "+f"(u[27]), "+f"(u[28]), "+f"(u[29]), "+f"(u[30]), "+f"(u[31]),
        "+f"(u[32]), "+f"(u[33]), "+f"(u[34]), "+f"(u[35]), "+f"(u[36]), "+f"(u[37]),
        "+f"(u[38]), "+f"(u[39]), "+f"(u[40]), "+f"(u[41]), "+f"(u[42]), "+f"(u[43]),
        "+f"(u[44]), "+f"(u[45]), "+f"(u[46]), "+f"(u[47]), "+f"(u[48]), "+f"(u[49]),
        "+f"(u[50]), "+f"(u[51]), "+f"(u[52]), "+f"(u[53]), "+f"(u[54]), "+f"(u[55]),
        "+f"(u[56]), "+f"(u[57]), "+f"(u[58]), "+f"(u[59]), "+f"(u[60]), "+f"(u[61]),
        "+f"(u[62]), "+f"(u[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The weight tiles: tile (f, ot, c) is w1[c * kc + k, f*O + ot*128 + n] for
// n < 128, k < kc as a (128, kc) bf16 block in the core-matrix layout, zero
// for k >= H and for columns past O, stored at tile index (f * n_ot + ot) *
// n_c + c. The block instance takes one chunk of kc = Hp, the wide instance
// n_c chunks of KC. One thread a 16-byte chunk; eight consecutive threads
// write one core matrix's 128 bytes.
__global__ void w_prep_kernel(const float* __restrict__ w1, bf16* __restrict__ wt, int h,
                              int kc, int n_c, int f_total, int o, int n_ot) {
  const int chunks = TN * (kc / 8);  // a tile's 16-byte chunks
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f_total * n_ot * n_c * chunks) return;
  const int tile = i / chunks, rem = i - tile * chunks;
  const int n8 = rem & 7, kq = (rem >> 3) % (kc / 8), ng = (rem >> 3) / (kc / 8);
  const int fot = tile / n_c, c = tile - fot * n_c;
  const int fi = fot / n_ot, oc = (fot - fi * n_ot) * TN + ng * 8 + n8;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = c * kc + kq * 8 + e;
    v[e] = (k < h && oc < o) ? w1[size_t(k) * f_total * o + size_t(fi) * o + oc] : 0.f;
  }
  uint4 out;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  // rem = ng * kc + kq * 8 + n8 chunks: element ng * 8 * kc + kq * 64 + n8 * 8
  reinterpret_cast<uint4*>(wt)[size_t(tile) * chunks + rem] = out;
}

constexpr int STAGE_UNROLL = 8;  // loads each consumer thread keeps in flight while staging

// The block's (TM, H) slice of xk, rows from b0, rounded to bf16 into the
// core-matrix layout, zero past B and H. Eight consecutive threads fill one
// core matrix (rows i % 8 of a group), so a warp stores 512 contiguous bytes;
// each thread first loads STAGE_UNROLL chunks of 8 floats, then stores them.
template <int ROWS, int NT, bool VEC>
__device__ __forceinline__ void stage_xk(bf16* as, const float* __restrict__ xk_d, int b0,
                                         int b_total, int h, int hp, int tid) {
  const int kcs = hp / 8, n = ROWS * kcs;
  for (int i0 = tid; i0 < n; i0 += NT * STAGE_UNROLL) {
    float v[STAGE_UNROLL][8];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * NT;
      const int r8 = i & 7, kc = (i >> 3) % kcs, rg = (i >> 3) / kcs;
      const int b = b0 + rg * 8 + r8;
      const bool row_ok = i < n && b < b_total;
      const float* src = xk_d + size_t(row_ok ? b : 0) * h + kc * 8;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = kc * 8 + 4 * q;
        if (VEC) {  // h % 4 == 0: a group of 4 is all in or all out
          const float4 f4 = row_ok && k < h ? *reinterpret_cast<const float4*>(src + 4 * q)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
          v[u][4 * q] = f4.x;
          v[u][4 * q + 1] = f4.y;
          v[u][4 * q + 2] = f4.z;
          v[u][4 * q + 3] = f4.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][4 * q + e] = row_ok && k + e < h ? src[4 * q + e] : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * NT;
      if (i >= n) break;
      const int r8 = i & 7, kc = (i >> 3) % kcs, rg = (i >> 3) / kcs;
      uint4 out;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(v[u][2 * e], v[u][2 * e + 1]);
      *reinterpret_cast<uint4*>(as + core_offset(rg * 8 + r8, kc * 8, hp)) = out;
    }
  }
}

// The block's (ROWS, F) slice of x0, f32, zero past B.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_x0(float* x0s, const float* __restrict__ x0, int d, int b0,
                                         int b_total, int f_total, int tid) {
  const float* x0_d = x0 + size_t(d) * b_total * f_total + size_t(b0) * f_total;
  const int x0_n = min(ROWS, b_total - b0) * f_total;  // the tile's valid x0 floats
  for (int i0 = tid; i0 < ROWS * f_total; i0 += NT * STAGE_UNROLL) {
    float v[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * NT;
      v[u] = i < x0_n ? x0_d[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u)
      if (i0 + u * NT < ROWS * f_total) x0s[i0 + u * NT] = v[u];
  }
}

// y's (ROWS, 128) tile from the fold's accumulators: acc[4j .. 4j + 3] is
// (row_a, col), (row_a, col + 1), (row_a + 8, col), (row_a + 8, col + 1) with
// col = 8j + 2q of the O tile.
__device__ __forceinline__ void store_y(float* __restrict__ y, const float* acc, int d, int b0,
                                        int b_total, int o, int ot, int row_a, int q) {
  float* y_d = y + size_t(d) * b_total * o;
  const bool pairs = (o & 1) == 0;  // then (row * o + even col) is 8-byte aligned
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = ot * TN + 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + row_a + 8 * half;
      if (b >= b_total) continue;
      float* dst = y_d + size_t(b) * o + col;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (pairs && col + 1 < o) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col < o) dst[0] = v0;
        if (col + 1 < o) dst[1] = v1;
      }
    }
  }
}

// acc += x0[row_a, f] * U_f (rows row_a) and x0[row_a + 8, f] * U_f.
__device__ __forceinline__ void fold(float* acc, const float* u, float xa, float xb) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[4 * j] += xa * u[4 * j];
    acc[4 * j + 1] += xa * u[4 * j + 1];
    acc[4 * j + 2] += xb * u[4 * j + 2];
    acc[4 * j + 3] += xb * u[4 * j + 3];
  }
}

// KS: Hp / 16, the k-steps of a field, unrolled; 0 for any Hp, in a loop.
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
    cin_fwd_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                   const bf16* __restrict__ wt, float* __restrict__ y, int b_total, int h,
                   int f_total, int o, int hp, int stages, int a_off, int w_off, int x0_off) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  bf16* as = reinterpret_cast<bf16*>(smem + a_off);
  unsigned char* ws = smem + w_off;
  float* x0s = reinterpret_cast<float*>(smem + x0_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * TM, ot = blockIdx.y, n_ot = gridDim.y, d = blockIdx.z;
  const uint32_t tile_bytes = uint32_t(TN) * hp * sizeof(bf16);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer: field f's tile into stage f % stages
    if (lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wt);
      int s = 0;
      uint32_t phase = 0;  // of stage s's barriers, flipped each pass of the ring
      for (int fi = 0; fi < f_total; ++fi) {
        mbar_wait(smem_u32(empty + s), phase ^ 1);
        mbar_expect_tx(smem_u32(full + s), tile_bytes);
        bulk_copy(smem_u32(ws + size_t(s) * tile_bytes),
                  src + (size_t(fi) * n_ot + ot) * tile_bytes, tile_bytes, smem_u32(full + s));
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // stage xk (bf16, core-matrix layout) and x0 (f32) while the first tiles fly
  const float* xk_d = xk + size_t(d) * b_total * h;
  if ((h & 3) == 0 && (reinterpret_cast<uintptr_t>(xk) & 15) == 0) {
    stage_xk<TM, CONSUMERS, true>(as, xk_d, b0, b_total, h, hp, tid);
  } else {
    stage_xk<TM, CONSUMERS, false>(as, xk_d, b0, b_total, h, hp, tid);
  }
  stage_x0<TM, CONSUMERS>(x0s, x0, d, b0, b_total, f_total, tid);
  // the xk tile was written by the threads; wgmma reads it through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int row_a = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row_a, row_a + 8
  const uint32_t a_base = smem_u32(as) + uint32_t(wg) * 64 * hp * sizeof(bf16);
  const uint32_t w_base = smem_u32(ws);
  const int ksteps = KS > 0 ? KS : hp / 16;

  float acc[64], u[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = u[i] = 0.f;

  int s = 0;
  uint32_t phase = 0;
  for (int fi = 0; fi < f_total; ++fi) {
    mbar_wait(smem_u32(full + s), phase);
    const uint32_t b_base = w_base + uint32_t(s) * tile_bytes;
    fence_operands(u);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < ksteps; ++kk)  // U_f from zero: the first k-step does not accumulate
      wgmma_128(u, make_desc(a_base + kk * 256, hp), make_desc(b_base + kk * 256, hp), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    const float xa = x0s[row_a * f_total + fi], xb = x0s[(row_a + 8) * f_total + fi];
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(u);
    if (lane == 0) mbar_arrive(smem_u32(empty + s));  // this warp is done with the stage
    fold(acc, u, xa, xb);
    if (++s == stages) s = 0, phase ^= 1;
  }
  store_y(y, acc, d, b0, b_total, o, ot, row_a, q);
}

// The wide instance: 64 rows a block, the weight in (128, KC) k-chunks.
__global__ void __launch_bounds__(WTHREADS, 1)
    cin_fwd_wide_kernel(const float* __restrict__ xk, const float* __restrict__ x0,
                        const bf16* __restrict__ wt, float* __restrict__ y, int b_total, int h,
                        int f_total, int o, int hp, int stages, int a_off, int w_off,
                        int x0_off) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  bf16* as = reinterpret_cast<bf16*>(smem + a_off);
  unsigned char* ws = smem + w_off;
  float* x0s = reinterpret_cast<float*>(smem + x0_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * WTM, ot = blockIdx.y, n_ot = gridDim.y, d = blockIdx.z;
  const int n_c = hp / KC;
  const uint32_t chunk_bytes = uint32_t(TN) * KC * sizeof(bf16);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), WCONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WCONSUMERS / 32) {  // the producer: every field's chunks, in order
    if (lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wt);
      int s = 0;
      uint32_t phase = 0;
      for (int fi = 0; fi < f_total; ++fi) {
        for (int c = 0; c < n_c; ++c) {
          mbar_wait(smem_u32(empty + s), phase ^ 1);
          mbar_expect_tx(smem_u32(full + s), chunk_bytes);
          bulk_copy(smem_u32(ws + size_t(s) * chunk_bytes),
                    src + ((size_t(fi) * n_ot + ot) * n_c + c) * chunk_bytes, chunk_bytes,
                    smem_u32(full + s));
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  const float* xk_d = xk + size_t(d) * b_total * h;
  if ((h & 3) == 0 && (reinterpret_cast<uintptr_t>(xk) & 15) == 0) {
    stage_xk<WTM, WCONSUMERS, true>(as, xk_d, b0, b_total, h, hp, tid);
  } else {
    stage_xk<WTM, WCONSUMERS, false>(as, xk_d, b0, b_total, h, hp, tid);
  }
  stage_x0<WTM, WCONSUMERS>(x0s, x0, d, b0, b_total, f_total, tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(WCONSUMERS) : "memory");

  const int g = lane >> 2, q = lane & 3;
  const int row_a = warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  const uint32_t a_base = smem_u32(as), w_base = smem_u32(ws);

  float acc[64], u[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = u[i] = 0.f;

  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int fi = 0; fi < f_total; ++fi) {
    fence_operands(u);
    for (int c = 0; c < n_c; ++c) {
      mbar_wait(smem_u32(full + s), phase);
      const uint32_t b_base = w_base + uint32_t(s) * chunk_bytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)  // U_f from zero, one chain in k order
        wgmma_128(u, make_desc(a_base + (c * (KC / 16) + kk) * 256, hp),
                  make_desc(b_base + kk * 256, KC), c > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (c > 0) {  // the previous chunk's products are done: free its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(smem_u32(empty + prev));
      }
      prev = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    const float xa = x0s[row_a * f_total + fi], xb = x0s[(row_a + 8) * f_total + fi];
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(u);
    if (lane == 0) mbar_arrive(smem_u32(empty + prev));
    fold(acc, u, xa, xb);
  }
  store_y(y, acc, d, b0, b_total, o, ot, row_a, q);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the caller refuses shapes above the card's limit.
size_t cin_fwd_smem_bytes(int h, int f) { return plan(h, f).total; }

// Columns of the bf16 weight scratch: H rounded up to a multiple of 16.
int cin_fwd_scratch_cols(int h) { return pad16(h); }

// Rows of the bf16 weight scratch: F tiles of 128 rows for each 128-wide O tile.
int cin_fwd_scratch_rows(int f, int o) { return f * ((o + TN - 1) / TN) * TN; }

// xk (D, B, H), x0 (D, B, F), w1 (H, F*O) f32 -> y (D, B, O) f32, all contiguous on
// the current device; wt is (cin_fwd_scratch_rows(F, O), cin_fwd_scratch_cols(H))
// bf16 scratch, 16-byte aligned. Returns the CUDA error code of the launches (0
// on success; cudaErrorInvalidValue, with nothing launched, where the shared
// memory would exceed the card's limit).
int cin_fwd(const float* xk, const float* x0, const float* w1, float* y, void* wt, int d,
            int b, int h, int f, int o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(h, f);
  if (p.total > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int ks = p.hp / 16;
  void (*kernel)(const float*, const float*, const bf16*, float*, int, int, int, int, int, int,
                 int, int, int) = cin_fwd_kernel<0>;
  switch (ks) {
    case 1: kernel = cin_fwd_kernel<1>; break;
    case 2: kernel = cin_fwd_kernel<2>; break;
    case 3: kernel = cin_fwd_kernel<3>; break;
    case 4: kernel = cin_fwd_kernel<4>; break;
    case 5: kernel = cin_fwd_kernel<5>; break;
    case 6: kernel = cin_fwd_kernel<6>; break;
    case 7: kernel = cin_fwd_kernel<7>; break;
    case 8: kernel = cin_fwd_kernel<8>; break;
    default: break;
  }
  // each instance may take the card's whole limit, set once
  static bool ready[9] = {};
  const int slot = ks <= 8 ? ks : 0;
  if (!ready[slot]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_LIMIT));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[slot] = true;
  }
  const int n_ot = (o + TN - 1) / TN;
  const int chunks = f * n_ot * TN * (p.hp / 8);
  w_prep_kernel<<<(chunks + 255) / 256, 256, 0, s>>>(w1, static_cast<bf16*>(wt), h, p.hp, 1, f,
                                                      o, n_ot);
  const dim3 grid((b + TM - 1) / TM, n_ot, d);
  kernel<<<grid, THREADS, p.total, s>>>(
      xk, x0, static_cast<const bf16*>(wt), y, b, h, f, o, p.hp, p.stages,
      static_cast<int>(p.a_off), static_cast<int>(p.w_off), static_cast<int>(p.x0_off));
  return static_cast<int>(cudaGetLastError());
}

// The wide instance's dynamic shared memory a block; past the card's limit
// where its two-stage ring does not fit.
size_t cin_fwd_wide_smem_bytes(int h, int f) { return wide_plan(h, f).total; }

// bf16 elements of the wide instance's weight scratch: F x O tiles x
// Hq / 64 chunks of (128, 64).
size_t cin_fwd_wide_scratch_elems(int h, int f, int o) {
  return size_t(f) * ((o + TN - 1) / TN) * pad64(h) * TN;
}

// The contract of cin_fwd, with wt of cin_fwd_wide_scratch_elems(H, F, O)
// bf16 elements.
int cin_fwd_wide(const float* xk, const float* x0, const float* w1, float* y, void* wt, int d,
                 int b, int h, int f, int o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = wide_plan(h, f);
  if (p.total > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(cin_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_LIMIT));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int n_ot = (o + TN - 1) / TN, n_c = p.hp / KC;
  const long long chunks = static_cast<long long>(f) * n_ot * n_c * TN * (KC / 8);
  w_prep_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
      w1, static_cast<bf16*>(wt), h, KC, n_c, f, o, n_ot);
  const dim3 grid((b + WTM - 1) / WTM, n_ot, d);
  cin_fwd_wide_kernel<<<grid, WTHREADS, p.total, s>>>(
      xk, x0, static_cast<const bf16*>(wt), y, b, h, f, o, p.hp, p.stages,
      static_cast<int>(p.a_off), static_cast<int>(p.w_off), static_cast<int>(p.x0_off));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
