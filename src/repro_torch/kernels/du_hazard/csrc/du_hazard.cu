// K2: DU hazard frontier merge, K independent (src, dst) stream pairs.
//
// Replaces the TPU kernel _hazard_kernel in
// src/repro/kernels/du_hazard/kernel.py (reached through
// hazard_frontier_batch and hazard_frontier there). For
// every row k and consumer lane j:
//
//   out[k][j] = |{ i < S : src[k][i] <= dst[k][j] }|    (side "right")
//   out[k][j] = |{ i < S : src[k][i] <  dst[k][j] }|    (side "left")
//
// This is a count, defined for any src row: for a non-decreasing row (the
// paper's §3.1 requirement) it equals searchsorted(src, dst, side), the
// minimal safe producer frontier of each consumer request. The kernel does
// not assert monotonicity and does not search.
//
// Design. The grid is ceil(D/256) x K blocks of 256 threads; each thread
// owns one dst lane of one row and keeps its count in a register. A block
// walks its row's src in tiles of kTile words staged through shared memory
// (every thread reads the same word, a broadcast, four words per 16-byte
// load). Bounds come from S: there are no pads, so every src word is
// counted exactly once and dst = INT32_MAX counts S under side "right"
// (the TPU kernel padded src with INT32_MAX, which a dst of INT32_MAX
// counted too).
//
// Bound. The function must move (S + 2D) * 4 bytes per row, which at the
// main path's shapes takes microseconds. This design instead does 2*K*S*D
// integer operations (a compare and an add per pair), so it is bound by the
// SMs' INT32 lanes, not by memory: the honest yardstick for it is that
// compare bound, and a binary search (against torch.searchsorted) is the
// later redesign that closes the gap for monotonic rows.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // dst lanes per block
constexpr int kTile = 2048;    // src words staged per pass (8 KB)

template <bool kStrict>
__device__ __forceinline__ int below(int s, int a) {
  return kStrict ? (s < a) : (s <= a);
}

template <bool kStrict>
__global__ void __launch_bounds__(kThreads)
hazard_frontier_kernel(const int* __restrict__ src,
                       const int* __restrict__ dst, int* __restrict__ out,
                       int s, int d) {
  __shared__ __align__(16) int tile[kTile];
  const long long k = blockIdx.y;
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int* row = src + k * s;
  const bool live = j < d;
  const int a = live ? dst[k * d + j] : 0;
  int count = 0;
  for (int base = 0; base < s; base += kTile) {
    const int n = min(kTile, s - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = row[base + i];
    __syncthreads();
    const int n4 = n & ~3;
#pragma unroll 8
    for (int i = 0; i < n4; i += 4) {
      const int4 v = *reinterpret_cast<const int4*>(tile + i);
      count += below<kStrict>(v.x, a) + below<kStrict>(v.y, a) +
               below<kStrict>(v.z, a) + below<kStrict>(v.w, a);
    }
    for (int i = n4; i < n; ++i) count += below<kStrict>(tile[i], a);
  }
  if (live) out[k * d + j] = count;
}

}  // namespace

extern "C" {

// Counts for K rows of S src and D dst words (row-major, contiguous) into
// out (K x D) on `stream`; strict != 0 is side "left". Returns a
// cudaError_t (0 = launched). The wrapper skips K = 0 or D = 0.
int hazard_frontier_launch(const int* src, const int* dst, int* out, int k,
                           int s, int d, int strict, void* stream) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)k);
  if (strict) {
    hazard_frontier_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, dst, out, s, d);
  } else {
    hazard_frontier_kernel<false>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(src, dst, out, s, d);
  }
  return (int)cudaGetLastError();
}

const char* du_hazard_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
