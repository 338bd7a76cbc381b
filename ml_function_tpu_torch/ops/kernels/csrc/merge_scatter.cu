// Merge-scatter of an embedding gradient for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces ml_function_tpu/ops/kernels/embedding_grad.py::_merge_scatter_kernel
// together with the segmented combine before it (_combine_sorted_duplicates):
// from the ids sorted ascending s_ids (N,) int32, the stable sort's
// permutation order (N,) int64 and the cotangents ct (N, D) f32 in their
// original order, it writes the dense gradient out (V, D) f32,
//
//   out[v, :] = sum of ct[order[i], :] over the run of i with s_ids[i] == v
//
// every row exactly once, zeros where no id falls, with no atomics. The sort
// stays a library call (torch.sort on int32 keys), as the reference sorts with
// XLA outside its Pallas kernel. The cotangents are read through the
// permutation: no permuted copy of ct is made.
//
// What bounds it on the H100: at DIEN's sequence lookups (N 262,144 ids of
// width 8 into V 5,202 rows) it must read the ids and ct, about 10.5 MB, and
// write out (0.17 MB): about 3 us at 3.35 TB/s. Bytes bound it. The earlier
// design (sort, then ct[order] as a library gather, then a kernel that read
// the copy one column at a time) spent 0.159 ms a lookup on the copy alone
// and 0.29-0.31 ms on the whole backward against index_add_'s 0.12-0.13
// (NVIDIA H100 80GB HBM3, 700 W, CUDA events). This design, on the same card:
// the two kernels 0.018 ms of device time a lookup (0.04-0.07 by events,
// which see the wrapper's host time), the whole backward 0.12-0.21 ms a
// lookup, of which the int32 torch.sort takes 0.07-0.11 by events (0.05 on
// the device). The sort, not this kernel, now bounds the backward: a stable
// counting sort over the ids' 13 bits is the lever left.
//
// Design: the sorted entries are cut into fixed chunks of CHUNK, one block a
// chunk and one entry a thread. Each thread loads its row ct[order[i]] once,
// four columns to a 16-byte load. A segmented inclusive scan over the block
// (warp shuffles, then the warps' carries in warp order) gives at the last
// entry of every run segment the segment's sum. A run that starts and ends in
// the chunk is written to out at once; the chunk's first and last segments
// are also kept as head and tail. A second kernel, one warp a row of out,
// finds the row's run by binary search: no run gives zeros; a run that
// crosses chunks is tail(first chunk) + the heads of the later chunks, which
// the lanes sum in fixed contiguous pieces and then a fixed butterfly. The pad
// id (about a quarter of a history, a run of ~65k) is thus summed by 256
// blocks and then 32 lanes, not by one thread. The order of every sum is fixed
// by the data and no atomics are used: the same inputs give the same bits.
//
// Launches go on the caller's stream. Nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;  // sorted entries a chunk; also the threads of kernel 1
constexpr int WARPS = CHUNK / 32;
constexpr int ROWS_THREADS = 256;  // kernel 2: eight rows of out a block

struct F4 {
  float x[4];
};

// Columns c0..c0+3 of row r of a (., d) matrix; columns past d read as 0.
template <bool VEC>
__device__ __forceinline__ F4 load4(const float* __restrict__ m, int64_t r, int d, int c0) {
  F4 v;
  if (VEC) {
    const float4 t = *reinterpret_cast<const float4*>(m + r * d + c0);
    v.x[0] = t.x, v.x[1] = t.y, v.x[2] = t.z, v.x[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v.x[j] = c0 + j < d ? m[r * d + c0 + j] : 0.f;
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ m, int64_t r, int d, int c0,
                                       const F4& v) {
  if (VEC) {
    *reinterpret_cast<float4*>(m + r * d + c0) = make_float4(v.x[0], v.x[1], v.x[2], v.x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < d) m[r * d + c0 + j] = v.x[j];
  }
}

// Smallest i in [lo, hi) with ids[i] >= v, or hi.
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ ids, int64_t lo,
                                               int64_t hi, int64_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ids[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One block a chunk of sorted entries: out rows of the runs that lie wholly in
// the chunk; head[k] and tail[k], the sums of its first and last run segments.
template <bool VEC>
__global__ void __launch_bounds__(CHUNK)
    chunk_kernel(const int32_t* __restrict__ s_ids, const int64_t* __restrict__ order,
                 const float* __restrict__ ct, float* __restrict__ head, float* __restrict__ tail,
                 float* __restrict__ out, int64_t n, int64_t v_rows, int d) {
  __shared__ int32_t sid[CHUNK + 2];  // the chunk's ids with one neighbour each side
  __shared__ unsigned starts[WARPS];  // each warp's lanes that start a segment
  __shared__ F4 wsum[WARPS];          // each warp's last lane after the warp's scan
  const int64_t k = blockIdx.x, lo = k * CHUNK;
  const int cnt = n - lo < CHUNK ? static_cast<int>(n - lo) : CHUNK;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const bool has = i < cnt;
  if (has) sid[i + 1] = s_ids[lo + i];
  if (i == 0) {
    sid[0] = lo > 0 ? s_ids[lo - 1] : -1;
    sid[cnt + 1] = lo + cnt < n ? s_ids[lo + cnt] : -1;
  }
  const int64_t src = has ? order[lo + i] : 0;
  __syncthreads();
  const int32_t id = has ? sid[i + 1] : -1;
  // a segment starts at the chunk's first entry and wherever the id changes;
  // threads past the chunk's end each start their own (empty) segment
  const bool start = !has || i == 0 || id != sid[i];
  const unsigned ballot = __ballot_sync(0xffffffffu, start);
  if (lane == 0) starts[warp] = ballot;
  const unsigned upto = ballot & (0xffffffffu >> (31 - lane));
  // the lane where my segment starts; -1: in an earlier warp
  const int seg = upto ? 31 - __clz(upto) : -1;
  const bool last = has && (i == cnt - 1 || id != sid[i + 2]);
  const bool first_seg = has && id == sid[1];                // the chunk's first segment
  const bool cont_in = first_seg && id == sid[0];            // its run began in an earlier chunk
  const bool cont_out = i == cnt - 1 && id == sid[cnt + 1];  // its run goes on past the chunk
  __syncthreads();
  // the warps before mine whose last segment runs into my first one
  int from = warp;
  if (seg < 0)
    while (from > 0) {
      --from;
      if (starts[from]) break;
    }

  for (int c0 = 0; c0 < d; c0 += 4) {
    F4 v = has ? load4<VEC>(ct, src, d, c0) : F4{{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = __shfl_up_sync(0xffffffffu, v.x[j], off);
        if (lane - off >= seg && lane >= off) v.x[j] = t + v.x[j];
      }
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (seg < 0 && from < warp) {
      // the earlier warps' shares of my segment, in warp order, then mine
      F4 carry = wsum[from];
      for (int w = from + 1; w < warp; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) carry.x[j] += wsum[w].x[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) v.x[j] = carry.x[j] + v.x[j];
    }
    if (last) {
      if (!cont_in && !cont_out && id >= 0 && id < v_rows) store4<VEC>(out, id, d, c0, v);
      if (first_seg) store4<VEC>(head, k, d, c0, v);
      if (i == cnt - 1) store4<VEC>(tail, k, d, c0, v);
    }
    __syncthreads();
  }
}

// One warp a row of out: zeros where no id falls, the runs that cross chunks
// as tail(first chunk) + the heads of the later chunks, which the warp's lanes
// sum in fixed contiguous pieces and a fixed butterfly; rows of runs inside
// one chunk were written by chunk_kernel.
template <bool VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
    rows_kernel(const int32_t* __restrict__ s_ids, const float* __restrict__ head,
                const float* __restrict__ tail, float* __restrict__ out, int64_t n,
                int64_t v_rows, int d) {
  const int64_t v = (blockIdx.x * int64_t(ROWS_THREADS) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= v_rows) return;
  const int64_t lo = lower_bound(s_ids, 0, n, v);
  if (lo == n || s_ids[lo] != v) {
    for (int c0 = 4 * lane; c0 < d; c0 += 128)
      store4<VEC>(out, v, d, c0, F4{{0.f, 0.f, 0.f, 0.f}});
    return;
  }
  const int64_t hi = lower_bound(s_ids, lo, n, v + 1);
  const int64_t k0 = lo / CHUNK, k1 = (hi - 1) / CHUNK;
  if (k0 == k1) return;
  const int64_t per = (k1 - k0 + 31) / 32, kb = k0 + 1 + lane * per;
  const int64_t ke = kb + per < k1 + 1 ? kb + per : k1 + 1;
  for (int c0 = 0; c0 < d; c0 += 4) {
    F4 s{{0.f, 0.f, 0.f, 0.f}};
    for (int64_t k = kb; k < ke; ++k) {
      const F4 h = load4<VEC>(head, k, d, c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) s.x[j] += h.x[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) s.x[j] += __shfl_xor_sync(0xffffffffu, s.x[j], off);
    if (lane == 0) {
      F4 t = load4<VEC>(tail, k0, d, c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) t.x[j] += s.x[j];
      store4<VEC>(out, v, d, c0, t);
    }
  }
}

template <bool VEC>
int launch(const int32_t* s_ids, const int64_t* order, const float* ct, float* head,
           float* tail, float* out, long long n, long long v, int d, cudaStream_t s) {
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  if (chunks > 0) {
    chunk_kernel<VEC><<<static_cast<unsigned>(chunks), CHUNK, 0, s>>>(s_ids, order, ct, head,
                                                                       tail, out, n, v, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (v > 0) {
    const long long blocks = (v * 32 + ROWS_THREADS - 1) / ROWS_THREADS;
    rows_kernel<VEC><<<static_cast<unsigned>(blocks), ROWS_THREADS, 0, s>>>(s_ids, head, tail,
                                                                            out, n, v, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// s_ids (N,) int32 sorted ascending, order (N,) int64 with s_ids[i] ==
// ids[order[i]], ct (N, D) f32 in the ids' order -> out (V, D) f32; head and
// tail are (ceil(N / 256), D) f32 workspaces; all contiguous on the current
// device. vec != 0 asks for 16-byte loads: D a multiple of 4 and ct, head,
// tail and out 16-byte aligned. Returns the CUDA error code of the launches
// (0 on success).
int merge_scatter(const int32_t* s_ids, const int64_t* order, const float* ct, float* head,
                  float* tail, float* out, long long n, long long v, int d, int vec,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(s_ids, order, ct, head, tail, out, n, v, d, s)
             : launch<false>(s_ids, order, ct, head, tail, out, n, v, d, s);
}

}  // extern "C"
