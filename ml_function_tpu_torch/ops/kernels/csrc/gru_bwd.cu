// (AU)GRU recurrence backward for Hopper (sm_90a), with a plain C interface
// for ctypes: two instances of one contract, chosen by the wrapper from H
// (kernels/gru.py: backward_instance).
//
// Replaces ml_function_tpu/ops/kernels/gru.py::_bwd_kernel (launched there by
// _gru_bwd_impl from the custom vjp). A reverse loop over L replays each step
// from the saved seq (h_prev = seq[t - 1], or h0 at t = 0), recomputes u0, r
// and n, and with dh the cotangent carried from step t + 1:
//
//   dh_t = dh + dseq[t];  dh_new = m * dh_t;  dh_prev = (1 - m) * dh_t
//   du = dh_new * (n - h_prev);  dn = dh_new * u;  dh_prev += dh_new * (1 - u)
//   da[t] = sum_H du * u0;  du_pre = a * du * u0 * (1 - u0)
//   dn_pre = dn * (1 - n^2);  dr_pre = dn_pre * hh_n * r * (1 - r);  dhn = dn_pre * r
//   dxw[t] = [du_pre | dr_pre | dn_pre];  dhh = [du_pre | dr_pre | dhn]
//   dh_prev += bf16(wh) . bf16(dhh);  dwh += bf16(h_prev)^T . bf16(dhh)
//
// with every other operation in f32 (expf, tanhf), in the plain version's
// order of operations (gru.cuh). dh after step 0 is dh0. Two sums feed a bf16
// rounding of a later step, the recurrent product h_prev . wh over k and
// wh . dhh over c: both instances take them in the plain version's order, one
// FMA at a time (products of two bf16 values are exact in f32). da and dwh
// feed nothing later; each instance sums them in an order of its own, fixed,
// with no atomics, so the same inputs give the same bits.
//
// What bounds it on the H100: at DIEN's shape (B 4096, L 64, H 16) it reads
// xw, seq, dseq, mask, att and h0 and writes dxw, da and dh0, about 138 MB
// (41 us at 3.35 TB/s), for about 1.5 GFLOP (22 us at the f32 rate): bytes.
// Its 64 dependent steps make it latency-bound unless each step is short and
// many rows are in flight.
//
// gru_bwd_warp, for H <= 16 (DIEN's and SIM's recurrences): the hidden units
// are padded to 16 and a warp takes two batch rows, a thread per (row,
// unit), so nothing in the step loop waits on another warp. Each step the
// warp publishes its rows' bf16 h_prev and bf16 dhh in warp-private shared
// memory behind a __syncwarp, and every lane reads its row's values as
// 16-byte broadcasts; the block's bf16 wh sits in shared memory as each
// unit's column (for the recurrent product) and row (for wh . dhh), read as
// 16-byte loads. A thread keeps its slice of dwh, rows k of columns j, H + j
// and 2H + j, summed over all L steps, in 48 registers; 122 registers in all
// keep 16 warps an SM, DIEN's whole batch in one wave. da is a fixed shuffle
// butterfly over the row's 16 lanes, off the chain of dh; the next step's
// seven inputs are loaded while this step computes, and the L2 is asked for
// those of four steps ahead. After the loop the two rows of a warp add their
// dwh slices (one shuffle), the block's four warps are summed in warp order,
// and a second launch sums the blocks' partials in block order, in eight
// fixed slices, each slice's sums then added in slice order. Rows past B and
// units past H compute on zeros, publish zeros and store nothing. At DIEN's
// shape the warp instance takes 0.108-0.109 ms on the device (0.116-0.119 ms
// a call by events) on an NVIDIA H100 80GB HBM3 at 700 W, against 0.292-0.294
// for the block instance on that shape (PERF.md): 2.8x the bound. A
// step is still some 490 instructions a thread, about 1.7 us with four warps
// a scheduler, latency and issue together, against 0.64 us for its bytes.
//
// gru_bwd, for 17 <= H <= 64: a block takes 256 / H batch rows, one thread
// per (row, hidden unit). Each step the block publishes its rows' bf16 h_prev
// and bf16 dhh in shared memory behind a block-wide barrier; a thread forms
// its unit's dh_prev from its row of wh (a column of the padded shared copy),
// and the block's threads each own fixed entries of the block's (H, 3H) dwh
// partial, also in shared memory, summing over the block's rows in a fixed
// order. The partials are summed over blocks as above.
//
// gru_bwd_wide, for H > 64 (gru.cuh): each step, behind a block barrier, a
// thread recomputes its units' three products for its group's RG rows (each
// bf16 weight read once for the RG rows), forms the gradients, writes dxw
// and publishes bf16 dhh in shared memory, keeping dh_prev's first part in
// dh0's slot (device memory, its own row and unit, the carry of dh); after a
// second barrier it adds wh . dhh (row j of wh against the rows' dhh, over c
// in order) into that carry, and the block adds h_prev^T . dhh of its rows
// into its own (H, 3H) dwh partial in device memory, each entry owned by one
// thread; a third barrier ends that. The bf16 h_prev and dhh of up to 8
// steps stay in shared memory (as many as fit: gru.cuh, wide_bwd_slots), so
// the partial is read and written once for those steps, eight entries' loads
// in flight at a time, its sums in a fixed order. Every input of a step is
// loaded before the product that hides its latency. The grid is at most as
// many blocks as the card holds at once, each taking row tiles i, i + grid,
// ... in that order into its one partial, so the partials (gru_bwd_wide_
// partials of them, 12 H^2 bytes each: 1.9 GB at H 1100 on 132 SMs) are
// bounded by the card, not by B. They are summed in block order by the same
// second launch, so the same inputs give the same bits on one card. da is each
// thread's units in order, a warp butterfly, then the warps in order. At
// DIEN's batch with kd 128 the three products (77 GFLOP, 1.17 ms at the f32
// rate) bound it; on an NVIDIA H100 80GB HBM3 at 700 W it takes several
// times that, and loses to cuDNN's nn.GRU backward past H 128 (PERF.md,
// chip_smoke.py): one block of 8 warps an SM waits on each step's loads and
// three barriers, and the dwh partial still crosses the L2 every few steps.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "gru.cuh"

namespace {

// ---------------------------------------------------------------- gru_bwd

__global__ void __launch_bounds__(1024)
    gru_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                   const float* __restrict__ mask, const float* __restrict__ att,
                   const float* __restrict__ h0, const float* __restrict__ seq,
                   const float* __restrict__ dseq, float* __restrict__ dxw,
                   float* __restrict__ da, float* __restrict__ dh0, float* __restrict__ part,
                   int b_total, int l, int h, int rows) {
  extern __shared__ float smem[];
  const int h3 = 3 * h, ldw = h3 + 1, nw = h * h3;
  float* whs = smem;                 // (H, 3H + 1) bf16-rounded wh
  float* hp = whs + h * ldw;         // (rows, H) bf16 h_prev
  float* dhh = hp + rows * h;        // (rows, 3H) bf16 dhh
  float* red = dhh + rows * h3;      // (rows, H) du * u0, for da
  float* dws = red + rows * h;       // (H, 3H) this block's dwh partial
  gru::stage_wh(whs, wh, h);
  for (int e = threadIdx.x; e < nw; e += blockDim.x) dws[e] = 0.f;

  const int r = threadIdx.x / h, j = threadIdx.x - r * h;  // blockDim.x == rows * h
  const int b = blockIdx.x * rows + r;
  const bool live = b < b_total;
  const size_t bs = live ? b : 0;
  const float* x = xw + bs * l * h3;
  float* dx = dxw + bs * l * h3;
  const float* sq = seq + bs * l * h;
  const float* dsq = dseq + bs * l * h;
  float* hpr = hp + r * h;
  float* dhr = dhh + r * h3;

  float dh = 0.f;
  for (int t = l - 1; t >= 0; --t) {
    float h_prev = 0.f, xu = 0.f, xr = 0.f, xn = 0.f, m = 0.f, a = 0.f, ds = 0.f;
    if (live) {
      h_prev = t == 0 ? h0[bs * h + j] : sq[size_t(t - 1) * h + j];
      const float* xt = x + size_t(t) * h3;
      xu = xt[j];
      xr = xt[h + j];
      xn = xt[2 * h + j];
      m = mask[bs * l + t];
      a = att[bs * l + t];
      ds = dsq[size_t(t) * h + j];
    }
    hpr[j] = gru::bf16r(h_prev);  // rows past B publish zeros
    __syncthreads();

    float hu, hr, hn;
    gru::recurrent_product(hpr, whs, h, j, hu, hr, hn);
    using gru::add;
    using gru::mul;
    using gru::sub;
    const float u0 = gru::sigmoid(add(xu, hu));
    const float rg = gru::sigmoid(add(xr, hr));
    const float n = tanhf(add(xn, mul(rg, hn)));
    const float u = mul(a, u0);

    const float dh_t = add(dh, ds);
    const float dh_new = mul(dh_t, m);
    float dh_prev = mul(dh_t, sub(1.f, m));
    const float du = mul(dh_new, sub(n, h_prev));
    const float dn = mul(dh_new, u);
    dh_prev = add(dh_prev, mul(dh_new, sub(1.f, u)));
    red[r * h + j] = mul(du, u0);
    const float du0 = mul(du, a);
    const float dn_pre = mul(dn, sub(1.f, mul(n, n)));
    const float dr = mul(dn_pre, hn);
    const float dhn = mul(dn_pre, rg);
    const float du_pre = mul(mul(du0, u0), sub(1.f, u0));
    const float dr_pre = mul(mul(dr, rg), sub(1.f, rg));
    if (live) {
      float* dxt = dx + size_t(t) * h3;
      dxt[j] = du_pre;
      dxt[h + j] = dr_pre;
      dxt[2 * h + j] = dn_pre;
    }
    dhr[j] = gru::bf16r(du_pre);
    dhr[h + j] = gru::bf16r(dr_pre);
    dhr[2 * h + j] = gru::bf16r(dhn);
    __syncthreads();

    if (live && j == 0) {  // da[t] = sum over the row's H units, in order
      float s = 0.f;
      for (int k = 0; k < h; ++k) s += red[r * h + k];
      da[bs * l + t] = s;
    }
    float acc = 0.f;  // (wh . dhh)[j]: row j of wh against the row's dhh, in order
    const float* wj = whs + j * ldw;
    for (int c = 0; c < h3; ++c) acc = fmaf(dhr[c], wj[c], acc);
    dh = add(dh_prev, acc);
    // dwh[k, c] += sum over the block's rows of h_prev[k] * dhh[c]
    for (int e = threadIdx.x; e < nw; e += blockDim.x) {
      const int k = e / h3, c = e - k * h3;
      float s = 0.f;
      for (int q = 0; q < rows; ++q) s = fmaf(hp[q * h + k], dhh[q * h3 + c], s);
      dws[e] += s;
    }
    __syncthreads();  // hp, dhh and red are rewritten by the next step
  }
  if (live) dh0[bs * h + j] = dh;
  float* pb = part + size_t(blockIdx.x) * nw;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) pb[e] = dws[e];
}

// ----------------------------------------------------------- gru_bwd_warp

using gru::L2_AHEAD;
using gru::WARPS;
using gru::WHP;
using gru::WROWS;
constexpr int WLD = 52;           // row stride (floats) of the shared weight copies

// One step's inputs of one (row, unit): h_prev, the three projections, the
// mask, the attention gate and the cotangent of seq.
struct StepIn {
  float hp, xu, xr, xn, m, a, ds;
};

// Loads with no branch: a (row, unit) outside B x H reads element 0 of each
// input and takes zeros.
__device__ __forceinline__ StepIn load_step(const float* __restrict__ xw,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ att,
                                            const float* __restrict__ h0,
                                            const float* __restrict__ seq,
                                            const float* __restrict__ dseq, bool ok, int b,
                                            int t, int l, int h, int j) {
  // indices fit in int: the wrapper refuses B * L * 3H >= 2^31
  const int bl = ok ? b * l + t : 0, jj = ok ? j : 0;
  const float* hsrc = t == 0 ? h0 + (ok ? b * h : 0) : seq + (ok ? (bl - 1) * h : 0);
  const float* xt = xw + bl * 3 * h + jj;
  StepIn s = {hsrc[jj], xt[0], xt[ok ? h : 0], xt[ok ? 2 * h : 0], mask[bl], att[bl],
              dseq[bl * h + jj]};
  if (!ok) s = StepIn{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  return s;
}

__global__ void __launch_bounds__(WARPS * 32, 4)
    gru_bwd_warp_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                        const float* __restrict__ mask, const float* __restrict__ att,
                        const float* __restrict__ h0, const float* __restrict__ seq,
                        const float* __restrict__ dseq, float* __restrict__ dxw,
                        float* __restrict__ da, float* __restrict__ dh0,
                        float* __restrict__ part, int b_total, int l, int h) {
  // bf16 h_prev of the warp's two rows, twice (by the step's parity: the dwh
  // sums of step t read it after the barrier that step t - 1's writes
  // follow), and bf16 dhh of its two rows: the rows are 16 and 48 floats
  // apart, 16 banks, so the two halves' 16-byte broadcasts and their stores
  // land on distinct banks. The block's bf16 wh: column j of each gate block
  // (wsm[0]) and row j (wsm[1]), a unit's 48 values WLD floats apart, so a
  // warp's 16-byte loads of 16 units take two wavefronts. Then the warps' dwh
  // slices.
  __shared__ __align__(16) float hbuf[WARPS][2][2 * WHP];
  __shared__ __align__(16) float dbuf[WARPS][2 * 3 * WHP];
  __shared__ __align__(16) float wsm[2][WHP * WLD];
  __shared__ float red[WARPS][WHP * 3 * WHP];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, j = lane & (WHP - 1);
  const int h3 = 3 * h;
  const int b = blockIdx.x * WROWS + warp * 2 + half;
  const bool ok = b < b_total && j < h;

  for (int e = threadIdx.x; e < WHP * 3 * WHP; e += blockDim.x) {
    const int u = e / (3 * WHP), c = e - u * 3 * WHP, g = c / WHP, k = c - g * WHP;
    const bool in = u < h && k < h;
    wsm[0][u * WLD + c] = in ? gru::bf16r(wh[k * h3 + g * h + u]) : 0.f;
    wsm[1][u * WLD + c] = in ? gru::bf16r(wh[u * h3 + g * h + k]) : 0.f;
  }
  __syncthreads();
  const float4* wcol = reinterpret_cast<const float4*>(wsm[0] + j * WLD);
  const float4* wrow = reinterpret_cast<const float4*>(wsm[1] + j * WLD);
  float* drow_w = dbuf[warp] + half * 3 * WHP;

  // This lane's L2 prefetch: one of six lines of one of the warp's rows a
  // step (xw's 3H floats from their start and 128 bytes on, h_prev, dseq,
  // mask, att), step t's line at pf_base + (t - pf_first) * pf_step; h_prev
  // of step 0 (h0) is not prefetched.
  const float* pf_base = xw;
  int pf_step = 0, pf_first = 0;
  bool pf_ok = false;
  if (lane < 12) {
    const int r = lane / 6, what = lane - 6 * r, bb = blockIdx.x * WROWS + warp * 2 + r;
    if (bb < b_total) {
      const size_t bl = size_t(bb) * l;
      pf_ok = true;
      pf_first = what == 2;
      pf_base = what == 0   ? xw + bl * h3
                : what == 1 ? xw + bl * h3 + min(32, h3 - 1)
                : what == 2 ? seq + bl * h
                : what == 3 ? dseq + bl * h
                : what == 4 ? mask + bl
                            : att + bl;
      pf_step = what <= 1 ? h3 : (what <= 3 ? h : 1);
    }
  }

  float dw[3][WHP];  // dwh[k, g*H + j] over this thread's row and all steps
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int k = 0; k < WHP; ++k) dw[g][k] = 0.f;
  }
  StepIn cur = load_step(xw, mask, att, h0, seq, dseq, ok, b, l - 1, l, h, j);
  float dh = 0.f;

  for (int t = l - 1; t >= 0; --t) {
    if (pf_ok && t >= L2_AHEAD + pf_first) {
      const float* p = pf_base + size_t(t - L2_AHEAD - pf_first) * pf_step;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
    }
    // step t - 1's inputs, in flight during this step
    const StepIn nxt = load_step(xw, mask, att, h0, seq, dseq, ok && t > 0, b, t - 1, l, h, j);

    float* hb = hbuf[warp][t & 1] + half * WHP;
    hb[j] = gru::bf16r(cur.hp);
    __syncwarp();

    const float4* h4 = reinterpret_cast<const float4*>(hb);
    float hu = 0.f, hr = 0.f, hn = 0.f;  // summed over k in order, as gru.cuh
#pragma unroll
    for (int k4 = 0; k4 < WHP / 4; ++k4) {
      const float4 v = h4[k4], cu = wcol[k4], cr = wcol[WHP / 4 + k4],
                   cn = wcol[2 * (WHP / 4) + k4];
      hu = fmaf(v.x, cu.x, hu);
      hr = fmaf(v.x, cr.x, hr);
      hn = fmaf(v.x, cn.x, hn);
      hu = fmaf(v.y, cu.y, hu);
      hr = fmaf(v.y, cr.y, hr);
      hn = fmaf(v.y, cn.y, hn);
      hu = fmaf(v.z, cu.z, hu);
      hr = fmaf(v.z, cr.z, hr);
      hn = fmaf(v.z, cn.z, hn);
      hu = fmaf(v.w, cu.w, hu);
      hr = fmaf(v.w, cr.w, hr);
      hn = fmaf(v.w, cn.w, hn);
    }
    using gru::add;
    using gru::mul;
    using gru::sub;
    const float u0 = gru::sigmoid(add(cur.xu, hu));
    const float rg = gru::sigmoid(add(cur.xr, hr));
    const float n = tanhf(add(cur.xn, mul(rg, hn)));
    const float u = mul(cur.a, u0);

    const float dh_t = add(dh, cur.ds);
    const float dh_new = mul(dh_t, cur.m);
    float dh_prev = mul(dh_t, sub(1.f, cur.m));
    const float du = mul(dh_new, sub(n, cur.hp));
    const float dn = mul(dh_new, u);
    dh_prev = add(dh_prev, mul(dh_new, sub(1.f, u)));
    const float du0 = mul(du, cur.a);
    const float dn_pre = mul(dn, sub(1.f, mul(n, n)));
    const float dr = mul(dn_pre, hn);
    const float dhn = mul(dn_pre, rg);
    const float du_pre = mul(mul(du0, u0), sub(1.f, u0));
    const float dr_pre = mul(mul(dr, rg), sub(1.f, rg));
    if (ok) {
      float* dxt = dxw + (b * l + t) * h3 + j;
      dxt[0] = du_pre;
      dxt[h] = dr_pre;
      dxt[2 * h] = dn_pre;
    }
    const float own[3] = {gru::bf16r(du_pre), gru::bf16r(dr_pre), gru::bf16r(dhn)};
#pragma unroll
    for (int g = 0; g < 3; ++g) drow_w[g * WHP + j] = own[g];
    __syncwarp();

    // (wh . dhh)[j]: row j of wh against the row's dhh, over c in order
    const float4* d4 = reinterpret_cast<const float4*>(drow_w);
    float acc = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < 3 * WHP / 4; ++c4) {
      const float4 v = d4[c4], w = wrow[c4];
      acc = fmaf(v.x, w.x, acc);
      acc = fmaf(v.y, w.y, acc);
      acc = fmaf(v.z, w.z, acc);
      acc = fmaf(v.w, w.w, acc);
    }
    dh = add(dh_prev, acc);
    // da[t], off the chain of dh: a butterfly over the row's 16 lanes (a + b
    // and b + a are the same bits, so every lane ends with the same sum)
    float s_da = mul(du, u0);
#pragma unroll
    for (int m = WHP / 2; m > 0; m >>= 1) s_da += __shfl_xor_sync(0xffffffffu, s_da, m);
    if (ok && j == 0) da[b * l + t] = s_da;
    // this thread's dwh slice: rows k of columns j, H + j, 2H + j
#pragma unroll
    for (int k4 = 0; k4 < WHP / 4; ++k4) {
      const float4 v = h4[k4];
      const float x4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int g = 0; g < 3; ++g) dw[g][4 * k4 + i] = fmaf(x4[i], own[g], dw[g][4 * k4 + i]);
      }
    }
    cur = nxt;
  }

  if (ok) dh0[b * h + j] = dh;
  // the two halves of the warp hold the same entries for different rows
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int k = 0; k < WHP; ++k) {
      dw[g][k] += __shfl_xor_sync(0xffffffffu, dw[g][k], 16);
      if (half == 0) red[warp][k * 3 * WHP + g * WHP + j] = dw[g][k];
    }
  }
  __syncthreads();
  // the block's partial: its warps' slices added in warp order
  float* pb = part + size_t(blockIdx.x) * h * h3;
  for (int e = threadIdx.x; e < WHP * 3 * WHP; e += blockDim.x) {
    const int k = e / (3 * WHP), c = e - k * 3 * WHP, g = c / WHP, jj = c - g * WHP;
    if (k < h && jj < h) {
      float s = red[0][e];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += red[w][e];
      pb[k * h3 + g * h + jj] = s;
    }
  }
}

// ----------------------------------------------------------- gru_bwd_wide

// RG rows a group, G groups a block of G * tu threads; WS: wh in shared
// memory; `slots` steps' bf16 h_prev and dhh kept for each dwh update. Block
// i takes the row tiles i, i + gridDim.x, ... in that order, all into its one
// dwh partial.
template <int RG, int G, bool WS>
__global__ void __launch_bounds__(gru::WIDE_THREADS)
    gru_bwd_wide_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                        const float* __restrict__ mask, const float* __restrict__ att,
                        const float* __restrict__ h0, const float* __restrict__ seq,
                        const float* __restrict__ dseq, float* __restrict__ dxw,
                        float* __restrict__ da, float* __restrict__ dh0,
                        float* __restrict__ part, int b_total, int l, int h, int tu, int ldw,
                        int slots) {
  constexpr int ROWS = G * RG;
  using bf16 = __nv_bfloat16;
  using gru::add;
  using gru::mul;
  using gru::sub;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  bf16* whs = reinterpret_cast<bf16*>(wide_smem);
  const size_t state_off = WS ? gru::wide_wh_bytes_dev(h, ldw) : 0;
  bf16* hp_slots = reinterpret_cast<bf16*>(wide_smem + state_off);  // [slot][H][ROWS]
  bf16* dh_slots = hp_slots + slots * h * ROWS;                     // [slot][3H][ROWS]
  float* red = reinterpret_cast<float*>(dh_slots + slots * 3 * h * ROWS);  // [warps][RG]
  const int h3 = 3 * h, nw = h * h3;
  int slot = 0;  // this step's slot; the steps since the last dwh update fill 0 .. slot
  bf16* hps = hp_slots;
  bf16* dhs = dh_slots;
  const int g = threadIdx.x / tu, ju = threadIdx.x - g * tu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pb = part + size_t(blockIdx.x) * nw;
  if (WS) gru::stage_wh_bf16(whs, wh, h, ldw);
  const int tiles = (b_total + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bb = tile * ROWS, b0 = bb + g * RG;

    // bf16 h_prev of step t as [unit][row]: h0 at t = 0, else seq[t - 1]
    auto publish_h_prev = [&](int t) {
#pragma unroll 4
      for (int e = threadIdx.x; e < h * ROWS; e += blockDim.x) {
        const int k = e / ROWS, r = e - k * ROWS, b = bb + r;
        const float v = b >= b_total ? 0.f : t == 0 ? h0[b * h + k] : seq[(b * l + t - 1) * h + k];
        hps[e] = __float2bfloat16_rn(v);
      }
    };
    publish_h_prev(l - 1);
    __syncthreads();

    for (int t = l - 1; t >= 0; --t) {
      float m[RG], a[RG], da_sum[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const bool live = b0 + r < b_total;
        m[r] = live ? mask[(b0 + r) * l + t] : 0.f;
        a[r] = live ? att[(b0 + r) * l + t] : 0.f;
        da_sum[r] = 0.f;
      }
      for (int j = ju; j < h; j += tu) {
        // the unit's inputs of this step, in flight during the product: h_prev,
        // the projections, dseq and the carry dh from step t + 1 (this
        // thread's own store in dh0's slot)
        float hp[RG], xu[RG], xr[RG], xn[RG], ds[RG], dh[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const int b = b0 + r;
          const bool live = b < b_total;
          const int bl = live ? b * l + t : 0;
          const float* xt = xw + size_t(bl) * h3;
          hp[r] = !live ? 0.f : t == 0 ? h0[b * h + j] : seq[(bl - 1) * h + j];
          xu[r] = live ? xt[j] : 0.f;
          xr[r] = live ? xt[h + j] : 0.f;
          xn[r] = live ? xt[2 * h + j] : 0.f;
          ds[r] = live ? dseq[bl * h + j] : 0.f;
          dh[r] = live && t < l - 1 ? dh0[b * h + j] : 0.f;
        }
        float hu[RG], hr[RG], hn[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) hu[r] = hr[r] = hn[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < h; ++k) {  // over k in order, as the forward
          float x[RG];
          gru::load_bf16<RG>(x, hps + k * ROWS + g * RG);
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
          float du_pre = 0.f, dr_pre = 0.f, dhn = 0.f;
          if (b < b_total) {
            const int bl = b * l + t;
            const float u0 = gru::sigmoid(add(xu[r], hu[r]));
            const float rg = gru::sigmoid(add(xr[r], hr[r]));
            const float n = tanhf(add(xn[r], mul(rg, hn[r])));
            const float u = mul(a[r], u0);
            const float dh_t = add(dh[r], ds[r]);
            const float dh_new = mul(dh_t, m[r]);
            float dh_prev = mul(dh_t, sub(1.f, m[r]));
            const float du = mul(dh_new, sub(n, hp[r]));
            const float dn = mul(dh_new, u);
            dh_prev = add(dh_prev, mul(dh_new, sub(1.f, u)));
            da_sum[r] += mul(du, u0);
            const float du0 = mul(du, a[r]);
            const float dn_pre = mul(dn, sub(1.f, mul(n, n)));
            const float dr = mul(dn_pre, hn[r]);
            dhn = mul(dn_pre, rg);
            du_pre = mul(mul(du0, u0), sub(1.f, u0));
            dr_pre = mul(mul(dr, rg), sub(1.f, rg));
            float* dxt = dxw + size_t(bl) * h3;
            dxt[j] = du_pre;
            dxt[h + j] = dr_pre;
            dxt[2 * h + j] = dn_pre;
            dh0[b * h + j] = dh_prev;
          }
          const int c = g * RG + r;
          dhs[j * ROWS + c] = __float2bfloat16_rn(du_pre);
          dhs[(h + j) * ROWS + c] = __float2bfloat16_rn(dr_pre);
          dhs[(2 * h + j) * ROWS + c] = __float2bfloat16_rn(dhn);
        }
      }
      // da of the group's rows: this thread's units, then the warp, then its warps in order
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float v = da_sum[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp * RG + r] = v;
      }
      __syncthreads();  // dhh and the da sums are in

      if (ju < RG) {
        const int b = b0 + ju;
        if (b < b_total) {
          const int w0 = g * (tu / 32);
          float v = red[w0 * RG + ju];
          for (int w = 1; w < tu / 32; ++w) v += red[(w0 + w) * RG + ju];
          da[b * l + t] = v;
        }
      }
      // dh = dh_prev + (wh . dhh)[j]: row j of wh against the row's dhh, over c in order
      for (int j = ju; j < h; j += tu) {
        float prev[RG], acc[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          prev[r] = b0 + r < b_total ? dh0[(b0 + r) * h + j] : 0.f;
          acc[r] = 0.f;
        }
#pragma unroll 4
        for (int c = 0; c < h3; ++c) {
          float d[RG];
          gru::load_bf16<RG>(d, dhs + c * ROWS + g * RG);
          const float w = gru::wide_w<WS>(whs, wh, ldw, h3, j, c);
#pragma unroll
          for (int r = 0; r < RG; ++r) acc[r] = fmaf(d[r], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          if (b0 + r < b_total) dh0[(b0 + r) * h + j] = add(prev[r], acc[r]);
        }
      }
      if (slot == slots - 1 || t == 0) {
        // the block's dwh partial: entry (k, c) += sum over the filled slots and
        // the block's rows of h_prev[k] * dhh[c], in slot then row order, KB
        // rows of k at a time so that their loads overlap
        constexpr int KB = 8;
        // the block's first update writes the partial
        const bool first = tile == blockIdx.x && t + slot == l - 1;
        for (int c = threadIdx.x; c < h3; c += blockDim.x) {
          float* pc = pb + c;
          for (int k0 = 0; k0 < h; k0 += KB) {
            float old[KB], v[KB];
#pragma unroll
            for (int i = 0; i < KB; ++i) {
              old[i] = first || k0 + i >= h ? 0.f : pc[size_t(k0 + i) * h3];
              v[i] = 0.f;
            }
            for (int sl = 0; sl <= slot; ++sl) {
              float d[ROWS];
              gru::load_bf16<ROWS>(d, dh_slots + (size_t(sl) * h3 + c) * ROWS);
#pragma unroll
              for (int i = 0; i < KB; ++i) {
                if (k0 + i >= h) break;
                float x[ROWS];
                gru::load_bf16<ROWS>(x, hp_slots + (size_t(sl) * h + k0 + i) * ROWS);
                float s = 0.f;
#pragma unroll
                for (int r = 0; r < ROWS; ++r) s = fmaf(x[r], d[r], s);
                v[i] += s;
              }
            }
#pragma unroll
            for (int i = 0; i < KB; ++i)
              if (k0 + i < h) pc[size_t(k0 + i) * h3] = first ? v[i] : old[i] + v[i];
          }
        }
        __syncthreads();  // every thread is done with the slots
        slot = 0;
      } else {
        ++slot;  // the next step fills a slot nobody reads now
      }
      hps = hp_slots + slot * h * ROWS;
      dhs = dh_slots + slot * h3 * ROWS;
      if (t > 0) {
        publish_h_prev(t - 1);
        __syncthreads();
      }
    }
  }  // the last update's barrier ends the tile: its slots are free for the next
}

// --------------------------------------------------------- the dwh sum

constexpr int SUM_SLICES = 8;     // slices of the blocks, each summed in block order
constexpr int SUM_ENTRIES = 32;   // dwh entries a block of the sum kernel

// dwh[e] = sum over slices s in order of (sum over the blocks of slice s in
// block order of part[blk, e]); slice s holds blocks [s * per, (s + 1) * per).
__global__ void __launch_bounds__(SUM_SLICES * SUM_ENTRIES)
    gru_dwh_sum_kernel(const float* __restrict__ part, float* __restrict__ dwh, int blocks,
                       int nw) {
  __shared__ float sums[SUM_SLICES][SUM_ENTRIES];
  const int el = threadIdx.x % SUM_ENTRIES, sl = threadIdx.x / SUM_ENTRIES;
  const int e = blockIdx.x * SUM_ENTRIES + el;
  const int per = (blocks + SUM_SLICES - 1) / SUM_SLICES;
  const int lo = sl * per, hi = min(blocks, lo + per);
  float s = 0.f;
  if (e < nw) {
#pragma unroll 8
    for (int blk = lo; blk < hi; ++blk) s += part[size_t(blk) * nw + e];
  }
  sums[sl][el] = s;
  __syncthreads();
  if (sl == 0 && e < nw) {
    float total = sums[0][el];
    for (int q = 1; q < SUM_SLICES; ++q) total += sums[q][el];
    dwh[e] = total;
  }
}

int sum_partials(const float* part, float* dwh, int blocks, int nw, cudaStream_t s) {
  gru_dwh_sum_kernel<<<(nw + SUM_ENTRIES - 1) / SUM_ENTRIES, SUM_SLICES * SUM_ENTRIES, 0, s>>>(
      part, dwh, blocks, nw);
  return static_cast<int>(cudaGetLastError());
}

// The wide backward at (B, H) on the current device: its grid is one block a
// row tile, at most as many as the card holds at once (SMs times the blocks
// an SM takes at this shared memory), so its dwh partials, one a block, are
// bounded by the card and not by B. With launch false it only returns the
// grid (or minus a CUDA error code); with launch true it launches the
// backward and the sum of its partials and returns the CUDA error code.
template <int RG, int G, bool WS>
int bwd_wide(bool launch, const float* xw, const float* wh, const float* mask,
             const float* att, const float* h0, const float* seq, const float* dseq,
             float* dxw, float* dwh, float* da, float* dh0, float* part, int b, int l, int h,
             cudaStream_t s) {
  const int tu = gru::wide_unit_threads(h), ldw = gru::wide_ldw(h), rows = G * RG;
  const size_t wh_bytes = WS ? gru::wide_wh_bytes(h) : 0;
  const int slots = gru::wide_bwd_slots(h, rows, wh_bytes);
  const size_t smem = wh_bytes + gru::wide_bwd_state(h, rows, slots);
  cudaError_t err = cudaFuncSetAttribute(gru_bwd_wide_kernel<RG, G, WS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_bwd_wide_kernel<RG, G, WS>,
                                                        G * tu, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return launch ? static_cast<int>(err) : -static_cast<int>(err);
  const int tiles = (b + rows - 1) / rows;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  if (!launch) return blocks;
  gru_bwd_wide_kernel<RG, G, WS><<<blocks, G * tu, smem, s>>>(
      xw, wh, mask, att, h0, seq, dseq, dxw, da, dh0, part, b, l, h, tu, ldw, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(part, dwh, blocks, h * 3 * h, s);
}

// The instance of bwd_wide that the plan (gru.cuh) names for H > 64.
int bwd_wide_plan(bool launch, const float* xw, const float* wh, const float* mask,
                  const float* att, const float* h0, const float* seq, const float* dseq,
                  float* dxw, float* dwh, float* da, float* dh0, float* part, int b, int l,
                  int h, cudaStream_t s) {
  const int g = gru::wide_groups(h), rg = gru::wide_rg(h);
  const bool ws =
      gru::wide_wh_bytes(h) + gru::wide_bwd_state(h, g * rg, 1) <= gru::SMEM_LIMIT;
  if (rg == gru::WIDE_RG && g == 2 && ws)
    return bwd_wide<gru::WIDE_RG, 2, true>(launch, xw, wh, mask, att, h0, seq, dseq, dxw, dwh,
                                           da, dh0, part, b, l, h, s);
  if (rg == gru::WIDE_RG && g == 1)
    return ws ? bwd_wide<gru::WIDE_RG, 1, true>(launch, xw, wh, mask, att, h0, seq, dseq, dxw,
                                                dwh, da, dh0, part, b, l, h, s)
              : bwd_wide<gru::WIDE_RG, 1, false>(launch, xw, wh, mask, att, h0, seq, dseq, dxw,
                                                 dwh, da, dh0, part, b, l, h, s);
  if (rg == 1 && g == 1 && !ws)
    return bwd_wide<1, 1, false>(launch, xw, wh, mask, att, h0, seq, dseq, dxw, dwh, da, dh0,
                                 part, b, l, h, s);
  const int err = static_cast<int>(cudaErrorInvalidValue);
  return launch ? err : -err;
}

}  // namespace

extern "C" {

// xw (B, L, 3H), wh (H, 3H), mask and att (B, L), h0 (B, H), seq and dseq
// (B, L, H) f32 -> dxw (B, L, 3H), dwh (H, 3H), da (B, L), dh0 (B, H) f32, with
// part a (ceil(B / rows), H, 3H) f32 workspace; all contiguous on the current
// device; 1 <= H <= 64, rows * H <= 1024 threads a block. Returns the CUDA
// error code of the launches (0 on success).
int gru_bwd(const float* xw, const float* wh, const float* mask, const float* att,
            const float* h0, const float* seq, const float* dseq, float* dxw, float* dwh,
            float* da, float* dh0, float* part, int b, int l, int h, int rows, void* stream) {
  const int h3 = 3 * h, nw = h * h3;
  const size_t smem =
      (size_t(h) * (h3 + 1) + size_t(rows) * (h + h3 + h) + size_t(nw)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (b + rows - 1) / rows;
  gru_bwd_kernel<<<blocks, rows * h, smem, s>>>(xw, wh, mask, att, h0, seq, dseq, dxw, da,
                                                 dh0, part, b, l, h, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(part, dwh, blocks, nw, s);
}

// The same contract for 1 <= H <= 16 with rows = 8 (the wrapper's choice);
// anything else returns cudaErrorInvalidValue and launches nothing.
int gru_bwd_warp(const float* xw, const float* wh, const float* mask, const float* att,
                 const float* h0, const float* seq, const float* dseq, float* dxw, float* dwh,
                 float* da, float* dh0, float* part, int b, int l, int h, int rows,
                 void* stream) {
  if (h < 1 || h > WHP || rows != WROWS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (b + WROWS - 1) / WROWS;
  gru_bwd_warp_kernel<<<blocks, WARPS * 32, 0, s>>>(xw, wh, mask, att, h0, seq, dseq, dxw, da,
                                                     dh0, part, b, l, h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(part, dwh, blocks, h * 3 * h, s);
}

// The same contract for H > 64, with no rows argument (the plan in gru.cuh
// sets a block's rows from H) and part (gru_bwd_wide_partials(B, H), H, 3H)
// f32. H <= 64 returns cudaErrorInvalidValue and launches nothing.
int gru_bwd_wide(const float* xw, const float* wh, const float* mask, const float* att,
                 const float* h0, const float* seq, const float* dseq, float* dxw, float* dwh,
                 float* da, float* dh0, float* part, int b, int l, int h, void* stream) {
  if (h <= 64) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_wide_plan(true, xw, wh, mask, att, h0, seq, dseq, dxw, dwh, da, dh0, part, b, l,
                       h, static_cast<cudaStream_t>(stream));
}

// The (H, 3H) dwh partials gru_bwd_wide writes at (B, H) on the current
// device: one a block, min(ceil(B / rows), blocks the card holds at once);
// minus a CUDA error code if H <= 64 or the runtime cannot say.
int gru_bwd_wide_partials(int b, int h) {
  if (h <= 64) return -static_cast<int>(cudaErrorInvalidValue);
  return bwd_wide_plan(false, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, nullptr, b, 0, h, nullptr);
}

}  // extern "C"
