// Field-attention backward for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces ml_function_tpu/ops/kernels/field_attention.py::_bwd_kernel
// (launched there by _call with three outputs, from the custom vjp). For each
// batch row b and head h it recomputes the softmax weights a of the forward
// (field_attn_fwd.cu) from q, k and bias, then, with dO the cotangent of o:
//
//   dV = a^T dO,  dA = dO V^T,  dS = a * (dA - rowsum(a * dA)),
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// all f32 on the CUDA cores, as the reference. The bias gets no gradient.
//
// What bounds it on the H100: at AutoInt's shape (B 4096, L 27, H 2, Dh 16)
// it does about 10 * B * H * Lq * Lk * Dh = 955 MFLOP (14 us at 67 TFLOP/s)
// for 99 MB in and out (30 us at 3.35 TB/s): memory bounds it. As written it
// takes about 0.36 ms there on an H100 80GB HBM3 at 700 W (chip_smoke.py),
// 12x that bound, for the reason the forward's note gives: five serial phases
// a block, each issue-bound on loads and index arithmetic around its FMAs.
//
// Design: one block of 128 threads per (b, h), reading q, k, v, dO in their
// (B, L, H, Dh) layout and writing dQ, dK, dV in it, with no transposes. The
// weights a and the cotangent dA (then dS, in place) are two (Lq, Lk)
// matrices held whole in shared memory, 32 KB at most under the gate; row
// tiles of q and k, then of dO and v, are staged for the two Gram products,
// and the three products with a or dS read their right-hand rows through L1.
// Neither a nor dS reaches device memory. Each block writes its own rows of
// dQ, dK and dV: no atomics, and the same inputs give the same bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "field_attn.cuh"

namespace {

// dS = a * (dA - rowsum(a * dA)) in place of dA, one warp a row.
__device__ void ds_rows(const float* a, float* da, int nr, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nr; r += fa::WARPS) {
    const float* ar = a + size_t(r) * nc;
    float* dr = da + size_t(r) * nc;
    float dot = 0.f;
    for (int j = lane; j < nc; j += 32) dot += ar[j] * dr[j];
    dot = fa::warp_sum(dot);
    for (int j = lane; j < nc; j += 32) dr[j] = ar[j] * (dr[j] - dot);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(fa::THREADS)
    field_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ dout, float* __restrict__ dq,
                          float* __restrict__ dk, float* __restrict__ dv, float scale, int lq,
                          int lk, int nh, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, stride = nh * dh;
  float* a = smem;                    // (lq, lk) weights
  float* ds = a + lq * lk;            // (lq, lk) dA, then dS
  float* xs = ds + lq * lk;           // query-side row tile
  float* ys = xs + (lq < fa::TILE ? lq : fa::TILE) * (dh + 1);  // key-side row tile
  const size_t qoff = (size_t(b) * lq * nh + h) * dh;
  const size_t koff = (size_t(b) * lk * nh + h) * dh;

  fa::gram<true>(q + qoff, lq, k + koff, lk, dh, stride, xs, ys, a, scale,
                 bias + size_t(b) * lk);
  fa::softmax_rows(a, lq, lk);
  fa::gram<false>(dout + qoff, lq, v + koff, lk, dh, stride, xs, ys, ds, 1.f, nullptr);
  ds_rows(a, ds, lq, lk);
  fa::apply<true>(a, lk, lk, lq, dout + qoff, dv + koff, dh, stride, 1.f);
  fa::apply<false>(ds, lk, lq, lk, k + koff, dq + qoff, dh, stride, scale);
  fa::apply<true>(ds, lk, lk, lq, q + qoff, dk + koff, dh, stride, scale);
}

size_t smem_bytes(int lq, int lk, int dh) {
  return (2 * size_t(lq) * lk + fa::tile_floats(lq, lk, dh)) * sizeof(float);
}

}  // namespace

extern "C" {

// q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), bias (B, Lk), dout (B, Lq, H, Dh) f32
// -> dq, dk, dv in the layouts of q, k, v, f32, all contiguous on the current
// device; Lq * Lk <= 4096, Dh <= 64. Returns the CUDA error code of the
// launch (0 on success).
int field_attn_bwd(const float* q, const float* k, const float* v, const float* bias,
                   const float* dout, float* dq, float* dk, float* dv, float scale, int b, int lq,
                   int lk, int h, int dh, void* stream) {
  const size_t smem = smem_bytes(lq, lk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      field_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  field_attn_bwd_kernel<<<dim3(b, h), fa::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, dout, dq, dk, dv, scale, lq, lk, h, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
