// K1: batched wave steps as gather-before-scatter over a flat image.
//
// Replaces the TPU kernel src/repro/kernels/wave_exec/kernel.py::_wave_kernel
// (reached through wave_step and wave_loop there). Per step s of S:
//
//   vals[s][i] = mem[clip(addrs[s][i], 0, M-1)]   for every lane (pre-step)
//   mem[addrs[s][i]] = svals[s][i]                for write lanes only
//
// The image is M int64 words: f64 bit patterns moved as integers, so every
// bit (NaN payloads included) survives. The caller guarantees WavePlan
// contract 5: no two write lanes of one step share an address, but a load
// lane may share an address with a write lane of the same step (the
// batch-internal WAR) and must read the pre-step value.
//
// Ordering. With many blocks, a block that scatters could overwrite a word
// another block has not gathered yet. The kernel is therefore one
// persistent cooperative launch per segment of S steps: a grid no larger
// than the co-resident limit walks the lanes grid-stride, and a grid-wide
// barrier separates each step's gather from its scatter and the scatter
// from the next step's gather. One launch per segment is the analogue of
// the reference's fori_loop over steps.
//
// Coherence. L1 is not coherent across SMs, so the gather reads with
// __ldcg (cached in L2 only): a word scattered by another SM in an earlier
// step is never served from a stale L1 line.
//
// Bound. The kernel moves bytes and computes nothing: per step it reads
// W addresses (4 B), W write flags (1 B) and W gathered words (8 B), and
// writes W gathered words (8 B); each write lane adds its store value read
// (8 B) and its scattered word (8 B). The gathers and scatters are random 8-byte accesses, so each
// costs a whole 32-byte sector of DRAM traffic unless it hits L2, and each
// step pays two grid barriers (grid_sync_kernel below times them alone).
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
wave_loop_kernel(long long* mem, long long m, const int* __restrict__ addrs,
                 const unsigned char* __restrict__ writes,
                 const long long* __restrict__ svals,
                 long long* __restrict__ vals, int s_steps, int w) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int s = 0; s < s_steps; ++s) {
    const long long row = (long long)s * w;
    // gather against the pre-step image, clipped like the reference
    for (long long i = first; i < w; i += stride) {
      long long a = addrs[row + i];
      a = a < 0 ? 0 : (a >= m ? m - 1 : a);
      vals[row + i] = __ldcg(mem + a);
    }
    grid.sync();
    // scatter write lanes only; an out-of-range write lane is dropped
    for (long long i = first; i < w; i += stride) {
      if (writes[row + i]) {
        const long long a = addrs[row + i];
        if (a >= 0 && a < m) mem[a] = svals[row + i];
      }
    }
    grid.sync();
  }
}

// Two grid barriers per step and nothing else, at a grid the caller
// chooses: the barrier cost of wave_loop_kernel at that grid, measured
// apart from its memory traffic.
__global__ void __launch_bounds__(kThreads) grid_sync_kernel(int s_steps) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < s_steps; ++s) {
    grid.sync();
    grid.sync();
  }
}

}  // namespace

extern "C" {

// The co-resident limit of wave_loop_kernel on the current device (blocks
// per SM times SMs): the largest grid a cooperative launch accepts. The
// wrapper asks once per device and sizes each launch from it.
int wave_loop_max_grid(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_loop_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// Runs S steps of width W over mem (M words) on `stream` with `grid`
// blocks (at most wave_loop_max_grid). Returns a cudaError_t (0 =
// launched).
int wave_loop_launch(long long* mem, long long m, const int* addrs,
                     const unsigned char* writes, const long long* svals,
                     long long* vals, int s_steps, int w, int grid,
                     void* stream) {
  void* args[] = {&mem, &m, &addrs, &writes, &svals, &vals, &s_steps, &w};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)wave_loop_kernel, dim3((unsigned)grid), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Runs grid_sync_kernel: S steps of two grid barriers with `grid` blocks.
int grid_sync_launch(int grid, int s_steps, void* stream) {
  void* args[] = {&s_steps};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_kernel, dim3((unsigned)grid), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* wave_exec_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
