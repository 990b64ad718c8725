// K5: histogram of int32 bin indices (the hist+add substrate).
//
// Replaces the TPU kernel _hist_kernel in src/repro/kernels/histogram/kernel.py
// (reached through histogram there):
//
//   out[b] = float32(|{ i : data[i] == b }|)    for b in [0, n_bins)
//
// Bins outside [0, n_bins) are dropped: each index is tested before any
// atomic, so no address outside the histogram is ever written (the TPU
// kernel's compare against iota(n_bins) drops them the same way).
//
// Counting. The TPU kernel adds each block's float32 counts into the output
// across its sequential grid; its oracle adds 1.0 in float32. Both are exact
// only while a bin holds at most 2**24. This kernel counts in 64-bit
// integers and rounds each bin to float32 once, at the end, so it equals the
// plain version (ref.py, an integer bincount cast once) bit for bit at any
// size, and the reference wherever a bin holds at most 2**24.
//
// Design. A grid-stride loop over the data. Where n_bins fits the shared
// memory budget (kMaxSharedBins 32-bit counters, 224 KB), each block keeps a
// private histogram in shared memory, filled with shared atomicAdd, and adds
// its non-zero bins to the global 64-bit histogram when it is done. Above
// the budget every block adds straight to the global histogram. A last small
// kernel converts the counts to float32 (__ull2float_rn, round to nearest).
// The grid is as many blocks as fit on the card at once, no more than the
// data needs.
//
// Bound. Bytes: the data is read once (N * 4) and the histogram written
// once (n_bins * 4). With few bins, lanes of a warp hit the same shared
// counter and the atomics serialise; per-warp sub-histograms would spread
// them and are left for later.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBins = 56 * 1024;

__global__ void hist_shared_kernel(const int* __restrict__ data, long long n,
                                   int n_bins,
                                   unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int s_counts[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) s_counts[b] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int d = data[i];
    if ((unsigned)d < (unsigned)n_bins) atomicAdd(&s_counts[d], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const unsigned int c = s_counts[b];
    if (c != 0u) atomicAdd(&counts[b], (unsigned long long)c);
  }
}

__global__ void hist_global_kernel(const int* __restrict__ data, long long n,
                                   int n_bins,
                                   unsigned long long* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int d = data[i];
    if ((unsigned)d < (unsigned)n_bins) atomicAdd(&counts[d], 1ull);
  }
}

__global__ void counts_to_f32_kernel(const unsigned long long* __restrict__ c,
                                     float* __restrict__ out, int n_bins) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < n_bins) out[b] = __ull2float_rn(c[b]);
}

}  // namespace

extern "C" {

// Counts N int32 indices into n_bins bins on `stream` with `threads` threads
// a block (a multiple of 32, at most 1024): `counts` (n_bins 64-bit words,
// scratch) is zeroed here, and `out` receives the float32 histogram.
// Returns a cudaError_t (0 = launched). The wrapper skips n_bins = 0.
int histogram_launch(const int* data, long long n, int n_bins, int threads,
                     unsigned long long* counts, float* out, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(*counts) * n_bins, stream);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const bool shared = n_bins <= kMaxSharedBins;
    const size_t smem = shared ? sizeof(unsigned int) * n_bins : 0;
    if (shared) {
      e = cudaFuncSetAttribute(hist_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hist_shared_kernel, threads, smem);
    } else {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hist_global_kernel, threads, 0);
    }
    if (e != cudaSuccess) return (int)e;
    const long long need = (n + threads - 1) / threads;
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > need) grid = need;
    if (shared) {
      hist_shared_kernel<<<(unsigned)grid, threads, smem, stream>>>(
          data, n, n_bins, counts);
    } else {
      hist_global_kernel<<<(unsigned)grid, threads, 0, stream>>>(
          data, n, n_bins, counts);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  counts_to_f32_kernel<<<(unsigned)((n_bins + 255) / 256), 256, 0, stream>>>(
      counts, out, n_bins);
  return (int)cudaGetLastError();
}

const char* histogram_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
