// (AU)GRU recurrence backward for Hopper (sm_90a), with a plain C interface
// for ctypes.
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
// order of operations (gru.cuh). dh after step 0 is dh0.
//
// What bounds it on the H100: at DIEN's shape (B 4096, L 64, H 16) it reads
// xw, seq, dseq, mask, att and h0 and writes dxw, da and dh0, about 138 MB
// (41 us at 3.35 TB/s), for about 1.5 GFLOP (22 us at the f32 rate): bytes.
// As for the forward, the 64 dependent steps, each a chain of shared-memory
// products and three barriers, make it latency-bound instead.
//
// Design: the forward's layout (a block takes 256 / H batch rows, one thread
// per (row, hidden unit), batch-major tensors read and written in place).
// Each step the block publishes its rows' bf16 h_prev and bf16 dhh in shared
// memory; a thread forms its unit's dh_prev from its row of wh (a column of
// the padded shared copy), and the block's threads each own fixed entries of
// the block's (H, 3H) dwh partial, also in shared memory, summing over the
// block's rows in a fixed order. The partials go to device memory and a
// second small kernel sums them over blocks in block order: dwh is
// deterministic, as the reference sums its per-tile partials, and no atomics
// are used.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "gru.cuh"

namespace {

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

// dwh[e] = sum over blocks, in block order, of part[blk, e].
__global__ void gru_dwh_sum_kernel(const float* __restrict__ part, float* __restrict__ dwh,
                                   int blocks, int nw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nw) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += part[size_t(blk) * nw + e];
  dwh[e] = s;
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
  gru_dwh_sum_kernel<<<(nw + 255) / 256, 256, 0, s>>>(part, dwh, blocks, nw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
