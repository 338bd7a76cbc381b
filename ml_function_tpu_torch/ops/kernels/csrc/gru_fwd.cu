// (AU)GRU recurrence forward for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces ml_function_tpu/ops/kernels/gru.py::_fwd_kernel (launched there by
// _pallas_fwd). One launch runs all L steps for every batch row:
//
//   hh = bf16(h) . bf16(wh)   (f32 sums)
//   u0 = sigmoid(xu + hh_u), r = sigmoid(xr + hh_r), n = tanh(xn + r * hh_n)
//   u = a * u0;  h' = m * ((1 - u) * h + u * n) + (1 - m) * h
//
// f32 everywhere else, with expf and tanhf (no fast-math intrinsics), in the
// plain version's order of operations (gru.cuh).
//
// What bounds it on the H100: at DIEN's shape (B 4096, L 64, H 16) it must
// read xw (50.3 MB), mask, att and h0 and write seq (16.8 MB), about 69.5 MB
// (21 us at 3.35 TB/s), for about 0.5 GFLOP (8 us at the f32 rate), so bytes
// bound it. The recurrence makes it latency-bound instead: each of the 64
// steps depends on the last, and a step is a chain of H shared-memory FMAs,
// expf/tanhf and two barriers.
//
// Design: the TPU kernel put channels on sublanes and the batch on lanes
// ((L, 3H, B) after two transposes) so that small H did not pad to 128 lanes.
// Here a block takes 256 / H batch rows with one thread per (row, hidden
// unit), and reads xw, mask and att in their batch-major layout with no
// transpose; h stays in a register, the bf16-rounded wh (3 KB at H 16) in
// shared memory, and the row's bf16 h is published in shared memory each
// step. The next step's xw, mask and att are loaded before this step's
// arithmetic, so their latency overlaps it. Ragged B needs no padding: rows
// past B take part in the barriers and touch no memory.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "gru.cuh"

namespace {

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
    const float u0 = gru::sigmoid(gru::add(xu, hu));
    const float rg = gru::sigmoid(gru::add(xr, hr));
    const float n = tanhf(gru::add(xn, gru::mul(rg, hn)));
    const float u = gru::mul(a, u0);
    const float h_new = gru::add(gru::mul(gru::sub(1.f, u), hv), gru::mul(u, n));
    hv = gru::add(gru::mul(m, h_new), gru::mul(gru::sub(1.f, m), hv));
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

}  // extern "C"
