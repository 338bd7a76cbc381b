// (AU)GRU recurrence forward for Hopper (sm_90a), with a plain C interface for
// ctypes: two instances of one contract, chosen by the wrapper from H
// (kernels/gru.py: forward_instance).
//
// Replaces ml_function_tpu/ops/kernels/gru.py::_fwd_kernel (launched there by
// _pallas_fwd). One launch runs all L steps for every batch row:
//
//   hh = bf16(h) . bf16(wh)   (f32 sums)
//   u0 = sigmoid(xu + hh_u), r = sigmoid(xr + hh_r), n = tanh(xn + r * hh_n)
//   u = a * u0;  h' = m * ((1 - u) * h + u * n) + (1 - m) * h
//
// f32 everywhere else, with expf and tanhf (no fast-math intrinsics), in the
// plain version's order of operations (gru.cuh: step). Both instances sum
// h . wh over k in order, one FMA at a time (products of two bf16 values are
// exact in f32), so they give the plain version's bits and each other's.
//
// What bounds it on the H100: at DIEN's shape (B 4096, L 64, H 16) it must
// read xw (50.3 MB), mask, att and h0 and write seq (16.8 MB), about 69.5 MB
// (21 us at 3.35 TB/s), for about 0.5 GFLOP (8 us at the f32 rate), so bytes
// bound it. The recurrence makes it latency-bound instead: each of the 64
// steps depends on the last.
//
// gru_fwd_warp, for H <= 16 (DIEN's and SIM's recurrences), in the layout of
// gru_bwd_warp (gru.cuh): a warp two batch rows, a thread per (row, unit), a
// block 8 rows, so DIEN's batch is 512 blocks, 16 warps an SM, one wave.
// Each thread loads its unit's three bf16 columns of wh, 48 floats, into
// registers once, before the loop. Each step the warp publishes its rows'
// bf16 h behind one __syncwarp and every lane reads its row's 16 values as
// four 16-byte broadcasts: there is no block barrier in the loop. The next
// step's xw, mask and att are loaded while this step computes, from
// loop-invariant bases, and the L2 is asked for those of L2_AHEAD steps
// ahead. At DIEN's shape it takes 0.0363-0.0373 ms a call on the device on
// an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py), against 0.0686-0.0693
// for the block instance: 1.8x the bound, about 191 instructions a
// warp-step at four warps a scheduler. At SIM's B 512 and B 8 (one warp a
// scheduler) it takes 0.0203-0.0209 ms: 64 times a step's dependent chain
// (three 16-deep FMA chains, expf and a division, tanhf, the publish).
//
// gru_fwd, for 17 <= H <= 64: a block takes 256 / H batch rows with one
// thread per (row, hidden unit); h stays in a register, the bf16-rounded wh
// (3 KB at H 16) in shared memory, and the row's bf16 h is published in
// shared memory each step behind two block barriers. At DIEN's shape it took
// 0.082-0.087 ms a call on an H100 80GB HBM3 at 700 W (chip_smoke.py), 4x
// the bound: every step waits for the slowest of a block's 8 warps, and the
// recurrent product reads wh from shared memory every step.
//
// gru_fwd_wide, for H > 64 (gru.cuh): each step a thread forms its units'
// three products for its group's RG rows, reading each bf16 weight once
// for the RG rows and the rows' bf16 h as one 16-byte broadcast a unit k,
// with the unit's inputs (its f32 h read back from seq, the projections)
// already in flight; it writes the new h to seq and its bf16 copy to the
// other of two shared buffers, and one block barrier ends the step. At
// DIEN's batch with kd 128 (B 4096, L 64, H 128: 25.8 GFLOP of recurrent products, 0.39
// ms at the f32 rate against 0.15 ms of bytes) the f32 FMAs bound it; on an
// NVIDIA H100 80GB HBM3 at 700 W it takes about 3.5x that, faster than
// cuDNN's nn.GRU (PERF.md, chip_smoke.py): the block's warps wait on each
// step's loads and barrier.
//
// The TPU kernel put channels on sublanes and the batch on lanes
// ((L, 3H, B) after two transposes) so that small H did not pad to 128 lanes;
// here both instances read xw, mask and att in their batch-major layout with
// no transpose, and ragged B needs no padding in device memory.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "gru.cuh"

namespace {

// ---------------------------------------------------------------- gru_fwd

__global__ void __launch_bounds__(1024)
    gru_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                   const float* __restrict__ mask, const float* __restrict__ att,
                   const float* __restrict__ h0, float* __restrict__ seq, int b_total, int l,
                   int h, int rows) {
  extern __shared__ float smem[];
  const int h3 = 3 * h;
  float* whs = smem;                  // (H, 3H + 1) bf16-rounded wh
  float* hs = whs + h * (h3 + 1);     // (rows, H) bf16-rounded h
  gru::stage_wh(whs, wh, h);

  const int r = threadIdx.x / h, j = threadIdx.x - r * h;
  const int b = blockIdx.x * rows + r;
  const bool live = b < b_total;  // blockDim.x == rows * h
  const float* x = xw + size_t(live ? b : 0) * l * h3;
  const float* mrow = mask + size_t(live ? b : 0) * l;
  const float* arow = att + size_t(live ? b : 0) * l;
  float* out = seq + size_t(live ? b : 0) * l * h;
  float* hb = hs + r * h;

  float hv = live ? h0[size_t(b) * h + j] : 0.f;
  hb[j] = gru::bf16r(hv);
  float xu = 0.f, xr = 0.f, xn = 0.f, m = 0.f, a = 0.f;
  if (live) {
    xu = x[j];
    xr = x[h + j];
    xn = x[2 * h + j];
    m = mrow[0];
    a = arow[0];
  }
  __syncthreads();

  for (int t = 0; t < l; ++t) {
    float nu = 0.f, nr = 0.f, nn = 0.f, nm = 0.f, na = 0.f;
    if (live && t + 1 < l) {  // the next step's inputs, in flight during this one
      const float* xt = x + size_t(t + 1) * h3;
      nu = xt[j];
      nr = xt[h + j];
      nn = xt[2 * h + j];
      nm = mrow[t + 1];
      na = arow[t + 1];
    }
    float hu, hr, hn;
    gru::recurrent_product(hb, whs, h, j, hu, hr, hn);
    hv = gru::step(hv, xu, xr, xn, m, a, hu, hr, hn);
    if (live) out[size_t(t) * h + j] = hv;
    __syncthreads();  // every thread has read this step's hb
    hb[j] = gru::bf16r(hv);
    __syncthreads();
    xu = nu;
    xr = nr;
    xn = nn;
    m = nm;
    a = na;
  }
}

// ----------------------------------------------------------- gru_fwd_warp

using gru::L2_AHEAD;
using gru::WARPS;
using gru::WHP;
using gru::WROWS;

// One step's inputs of one (row, unit): the three projections, the mask and
// the attention gate.
struct StepIn {
  float xu, xr, xn, m, a;
};

__global__ void __launch_bounds__(WARPS * 32, 4)
    gru_fwd_warp_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                        const float* __restrict__ mask, const float* __restrict__ att,
                        const float* __restrict__ h0, float* __restrict__ seq, int b_total, int l,
                        int h) {
  // bf16 h of the warp's two rows, twice (by the step's parity: a lane that
  // runs ahead writes the other buffer, and cannot come back to this one
  // before every lane has passed the next step's __syncwarp): the rows are
  // 16 floats apart, so the two halves' broadcasts land on distinct banks.
  __shared__ __align__(16) float hbuf[WARPS][2][2 * WHP];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, j = lane & (WHP - 1);
  const int h3 = 3 * h;
  const int b = blockIdx.x * WROWS + warp * 2 + half;
  const bool ok = b < b_total && j < h;

  // this thread's bf16 wh: rows k of columns j, H + j and 2H + j, zero past H
  float wu[WHP], wr[WHP], wn[WHP];
#pragma unroll
  for (int k = 0; k < WHP; ++k) {
    const bool in = j < h && k < h;
    const float* w = wh + (in ? k * h3 + j : 0);
    wu[k] = in ? gru::bf16r(w[0]) : 0.f;
    wr[k] = in ? gru::bf16r(w[h]) : 0.f;
    wn[k] = in ? gru::bf16r(w[2 * h]) : 0.f;
  }

  // Loop-invariant bases and per-step strides (indices fit in int: the
  // wrapper refuses B * L * 3H >= 2^31). A (row, unit) outside B x H reads
  // element 0 of each input at every step (strides 0) and takes zeros, so no
  // lane branches around a load.
  const float* xp = xw + (ok ? b * l * h3 + j : 0);
  const float* mp = mask + (ok ? b * l : 0);
  const float* ap = att + (ok ? b * l : 0);
  const int xs = ok ? h3 : 0, xg = ok ? h : 0, ms = ok ? 1 : 0;
  float* op = seq + (ok ? b * l * h + j : 0);

  // This lane's L2 prefetch: one of four lines of one of the warp's rows a
  // step (xw's 3H floats from their start and 128 bytes on, mask, att), step
  // t's line at pf_base + t * pf_step, asked for at step t - L2_AHEAD.
  const float* pf = xw;
  int pf_step = 0, pf_steps = 0;
  if (lane < 8) {
    const int r = lane / 4, what = lane - 4 * r, bb = blockIdx.x * WROWS + warp * 2 + r;
    if (bb < b_total) {
      const size_t bl = size_t(bb) * l;
      const float* pf_base = what == 0   ? xw + bl * h3
                             : what == 1 ? xw + bl * h3 + min(32, h3 - 1)
                             : what == 2 ? mask + bl
                                         : att + bl;
      pf_step = what <= 1 ? h3 : 1;
      for (int t = 1; t < L2_AHEAD && t < l; ++t)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(pf_base + size_t(t) * pf_step));
      pf = pf_base + size_t(L2_AHEAD) * pf_step;
      pf_steps = l - L2_AHEAD;
    }
  }

  float hv = ok ? h0[b * h + j] : 0.f;
  StepIn cur = {xp[0], xp[xg], xp[2 * xg], mp[0], ap[0]};
  if (!ok) cur = StepIn{0.f, 0.f, 0.f, 0.f, 0.f};
  float* hb = hbuf[warp][0] + half * WHP;         // this step's buffer,
  float* hb_next = hbuf[warp][1] + half * WHP;    // and the next step's

  for (int t = 0; t < l; ++t) {
    if (t < pf_steps) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(pf));
    pf += pf_step;
    // step t + 1's inputs (the last step's own again, unused), in flight
    // during this step
    const int tn = t + 1 < l ? t + 1 : t, xo = tn * xs, mo = tn * ms;
    StepIn nxt = {xp[xo], xp[xo + xg], xp[xo + 2 * xg], mp[mo], ap[mo]};
    if (!ok) nxt = StepIn{0.f, 0.f, 0.f, 0.f, 0.f};

    hb[j] = ok ? gru::bf16r(hv) : 0.f;   // padded units and rows publish zeros
    __syncwarp();

    // hh_u, hh_r, hh_n over k in order, as gru.cuh's recurrent_product
    const float4* h4 = reinterpret_cast<const float4*>(hb);
    float hu = 0.f, hr = 0.f, hn = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < WHP / 4; ++k4) {
      const float4 v = h4[k4];
      const float x4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * k4 + i;
        hu = fmaf(x4[i], wu[k], hu);
        hr = fmaf(x4[i], wr[k], hr);
        hn = fmaf(x4[i], wn[k], hn);
      }
    }
    hv = gru::step(hv, cur.xu, cur.xr, cur.xn, cur.m, cur.a, hu, hr, hn);
    if (ok) *op = hv;
    op += xg;
    cur = nxt;
    float* const used = hb;
    hb = hb_next;
    hb_next = used;
  }
}

// ----------------------------------------------------------- gru_fwd_wide

// RG rows a group, G groups a block of G * tu threads; WS: wh in shared memory.
template <int RG, int G, bool WS>
__global__ void __launch_bounds__(gru::WIDE_THREADS, 2)
    gru_fwd_wide_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                        const float* __restrict__ mask, const float* __restrict__ att,
                        const float* __restrict__ h0, float* __restrict__ seq, int b_total, int l,
                        int h, int tu, int ldw) {
  constexpr int ROWS = G * RG;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  using bf16 = __nv_bfloat16;
  bf16* whs = reinterpret_cast<bf16*>(wide_smem);
  const size_t state_off = WS ? gru::wide_wh_bytes_dev(h, ldw) : 0;
  // bf16 h as [unit][row], twice: step t reads hb and writes hb_next, and the
  // barrier that ends the step comes before anyone writes hb again
  bf16* hb = reinterpret_cast<bf16*>(wide_smem + state_off);
  bf16* hb_next = hb + h * ROWS;
  const int h3 = 3 * h;
  const int g = threadIdx.x / tu, ju = threadIdx.x - g * tu;
  const int bb = blockIdx.x * ROWS, b0 = bb + g * RG;
  if (WS) gru::stage_wh_bf16(whs, wh, h, ldw);
  for (int e = threadIdx.x; e < h * ROWS; e += blockDim.x) {
    const int k = e / ROWS, r = e - k * ROWS, b = bb + r;
    hb[e] = __float2bfloat16_rn(b < b_total ? h0[b * h + k] : 0.f);
  }
  __syncthreads();

  for (int t = 0; t < l; ++t) {
    float m[RG], a[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const bool live = b0 + r < b_total;
      m[r] = live ? mask[(b0 + r) * l + t] : 0.f;
      a[r] = live ? att[(b0 + r) * l + t] : 0.f;
    }
    for (int j = ju; j < h; j += tu) {
      // the unit's inputs of this step, in flight during the product: h from
      // seq[t - 1] (this thread's own store) or h0, and the projections
      float hv[RG], xu[RG], xr[RG], xn[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int b = b0 + r;
        const bool live = b < b_total;
        const int bl = live ? b * l + t : 0;
        const float* xt = xw + size_t(bl) * h3;
        hv[r] = !live ? 0.f : t == 0 ? h0[b * h + j] : seq[(bl - 1) * h + j];
        xu[r] = live ? xt[j] : 0.f;
        xr[r] = live ? xt[h + j] : 0.f;
        xn[r] = live ? xt[2 * h + j] : 0.f;
      }
      float hu[RG], hr[RG], hn[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) hu[r] = hr[r] = hn[r] = 0.f;
      // over k in order, as gru.cuh's recurrent_product: the plain version's bits
#pragma unroll 4
      for (int k = 0; k < h; ++k) {
        float x[RG];
        gru::load_bf16<RG>(x, hb + k * ROWS + g * RG);
        const float wu = gru::wide_w<WS>(whs, wh, ldw, h3, k, j);
        const float wr = gru::wide_w<WS>(whs, wh, ldw, h3, k, h + j);
        const float wn = gru::wide_w<WS>(whs, wh, ldw, h3, k, 2 * h + j);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          hu[r] = fmaf(x[r], wu, hu[r]);
          hr[r] = fmaf(x[r], wr, hr[r]);
          hn[r] = fmaf(x[r], wn, hn[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int b = b0 + r;
        const float hnew = gru::step(hv[r], xu[r], xr[r], xn[r], m[r], a[r], hu[r], hr[r],
                                     hn[r]);
        if (b < b_total) seq[(b * l + t) * h + j] = hnew;
        hb_next[j * ROWS + g * RG + r] = __float2bfloat16_rn(b < b_total ? hnew : 0.f);
      }
    }
    __syncthreads();  // every thread has read hb and written hb_next
    bf16* const used = hb;
    hb = hb_next;
    hb_next = used;
  }
}

template <int RG, int G, bool WS>
int fwd_wide_launch(const float* xw, const float* wh, const float* mask, const float* att,
                    const float* h0, float* seq, int b, int l, int h, cudaStream_t s) {
  const int tu = gru::wide_unit_threads(h), ldw = gru::wide_ldw(h), rows = G * RG;
  const size_t smem = (WS ? gru::wide_wh_bytes(h) : 0) + gru::wide_fwd_state(h, rows);
  cudaError_t err = cudaFuncSetAttribute(gru_fwd_wide_kernel<RG, G, WS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gru_fwd_wide_kernel<RG, G, WS><<<(b + rows - 1) / rows, G * tu, smem, s>>>(
      xw, wh, mask, att, h0, seq, b, l, h, tu, ldw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xw (B, L, 3H), wh (H, 3H), mask and att (B, L), h0 (B, H) f32 -> seq
// (B, L, H) f32, all contiguous on the current device; 1 <= H <= 64,
// rows * H <= 1024 threads a block. Returns the CUDA error code of the launch
// (0 on success).
int gru_fwd(const float* xw, const float* wh, const float* mask, const float* att,
            const float* h0, float* seq, int b, int l, int h, int rows, void* stream) {
  const size_t smem = (size_t(h) * (3 * h + 1) + size_t(rows) * h) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b + rows - 1) / rows;
  gru_fwd_kernel<<<blocks, rows * h, smem, static_cast<cudaStream_t>(stream)>>>(
      xw, wh, mask, att, h0, seq, b, l, h, rows);
  return static_cast<int>(cudaGetLastError());
}

// The same contract for 1 <= H <= 16 with rows = 8 (the wrapper's choice);
// anything else returns cudaErrorInvalidValue and launches nothing.
int gru_fwd_warp(const float* xw, const float* wh, const float* mask, const float* att,
                 const float* h0, float* seq, int b, int l, int h, int rows, void* stream) {
  if (h < 1 || h > WHP || rows != WROWS) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (b + WROWS - 1) / WROWS;
  gru_fwd_warp_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xw, wh, mask, att, h0, seq, b, l, h);
  return static_cast<int>(cudaGetLastError());
}

// The same contract for H > 64, with no rows argument: the plan (gru.cuh)
// sets a block's rows from H. H <= 64 returns cudaErrorInvalidValue and
// launches nothing.
int gru_fwd_wide(const float* xw, const float* wh, const float* mask, const float* att,
                 const float* h0, float* seq, int b, int l, int h, void* stream) {
  if (h <= 64) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = gru::wide_groups(h), rg = gru::wide_rg(h), rows = g * rg;
  const bool ws = gru::wide_wh_bytes(h) + gru::wide_fwd_state(h, rows) <= gru::SMEM_LIMIT;
  if (rg == gru::WIDE_RG && g == 2 && ws)
    return fwd_wide_launch<gru::WIDE_RG, 2, true>(xw, wh, mask, att, h0, seq, b, l, h, s);
  if (rg == gru::WIDE_RG && g == 1)
    return ws ? fwd_wide_launch<gru::WIDE_RG, 1, true>(xw, wh, mask, att, h0, seq, b, l, h, s)
              : fwd_wide_launch<gru::WIDE_RG, 1, false>(xw, wh, mask, att, h0, seq, b, l, h, s);
  if (rg == 1 && g == 1 && !ws)
    return fwd_wide_launch<1, 1, false>(xw, wh, mask, att, h0, seq, b, l, h, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
