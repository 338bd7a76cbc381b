// Field-attention forward for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces ml_function_tpu/ops/kernels/field_attention.py::_fwd_kernel
// (launched there by _call). For each batch row b and head h:
//
//   o[b, :, h] = softmax(q[b, :, h] k[b, :, h]^T * scale + bias[b]) v[b, :, h]
//
// with q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), bias (B, Lk), o (B, Lq, H, Dh),
// all f32, for Lq * Lk <= 4096 and Dh <= 64. Products and sums are f32 on the
// CUDA cores: the reference is f32 throughout, and TF32 or bf16 tensor cores
// would change the numbers.
//
// What bounds it on the H100: at AutoInt's shape (B 4096, L 27, H 2, Dh 16)
// it does 4 * B * H * Lq * Lk * Dh = 382 MFLOP (6 us at the 67 TFLOP/s of f32)
// for 57 MB in and out (17 us at 3.35 TB/s): memory bounds it. As written it
// takes about 0.14 ms there on an H100 80GB HBM3 at 700 W (chip_smoke.py),
// 8x that bound, at 4% of the f32 rate and 12% of the memory rate: by inference
// the time goes to each block's serial chain of index arithmetic, shared and L1
// loads around every FMA, and barriers, not to bytes.
//
// Design: the TPU kernel transposed q, k, v to (H, L, Dh, B) so the batch
// filled its 128 lanes. Here one block of 128 threads takes one (b, h) and
// reads the projections' (B, L, H, Dh) layout in place, with no transpose
// copies: it stages row tiles of q and k in shared memory, forms the whole
// (Lq, Lk) score matrix there (16 KB at most under the gate), takes each
// row's softmax with one warp, and multiplies by v read row by row through
// L1. Nothing but o reaches device memory. Ragged B, Lq != Lk and any
// Dh <= 64 need no padding.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include "field_attn.cuh"

namespace {

__global__ void __launch_bounds__(fa::THREADS)
    field_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          float* __restrict__ o, float scale, int lq, int lk, int nh, int dh) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, h = blockIdx.y, stride = nh * dh;
  float* s = smem;                    // (lq, lk) scores, then weights
  float* xs = s + lq * lk;            // q row tile
  float* ys = xs + (lq < fa::TILE ? lq : fa::TILE) * (dh + 1);  // k row tile
  const size_t qoff = (size_t(b) * lq * nh + h) * dh;
  const size_t koff = (size_t(b) * lk * nh + h) * dh;

  fa::gram<true>(q + qoff, lq, k + koff, lk, dh, stride, xs, ys, s, scale,
                 bias + size_t(b) * lk);
  fa::softmax_rows(s, lq, lk);
  fa::apply<false>(s, lk, lq, lk, v + koff, o + qoff, dh, stride, 1.f);
}

size_t smem_bytes(int lq, int lk, int dh) {
  return (size_t(lq) * lk + fa::tile_floats(lq, lk, dh)) * sizeof(float);
}

}  // namespace

extern "C" {

// q (B, Lq, H, Dh), k and v (B, Lk, H, Dh), bias (B, Lk) f32 -> o (B, Lq, H, Dh)
// f32, all contiguous on the current device; Lq * Lk <= 4096, Dh <= 64.
// Returns the CUDA error code of the launch (0 on success).
int field_attn_fwd(const float* q, const float* k, const float* v, const float* bias, float* o,
                   float scale, int b, int lq, int lk, int h, int dh, void* stream) {
  const size_t smem = smem_bytes(lq, lk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      field_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  field_attn_fwd_kernel<<<dim3(b, h), fa::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, o, scale, lq, lk, h, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
