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
// batch-internal WAR) and must read the pre-step value. A write lane
// outside [0, M) is dropped.
//
// A segment of S steps is one launch, on one of two paths (the wrapper
// picks it from M, W and the card's limits):
//
// Resident path, where the image and the lanes fit one thread block (the
// shared-memory opt-in limit, ~227 KB, and 512 threads of up to 8 lanes).
// One non-cooperative block loads the image once into shared memory, runs
// every step's gathers and scatters there, separates gather from scatter
// and scatter from the next gather with a block barrier, and writes the
// image back once at the end. Each thread holds its lanes' (addr, write,
// sval) for P steps in registers and loads step s + P as soon as step s
// has scattered, so the table loads of later steps fly while this step's
// barriers wait. Most launches of the HLS paths are narrow (8-4096 lanes)
// over images of a few thousand words; a block barrier costs a few
// nanoseconds where a grid barrier costs ~1.1 us even at one block. (A
// cluster of blocks over distributed shared memory, for larger images,
// lost to the wide path on an H100: a cluster barrier costs ~0.4-0.7 us
// whatever the cluster's size, and remote words are slow.)
//
// Wide path, for every other launch: one persistent cooperative launch, a
// grid no larger than the co-resident limit walking the lanes grid-stride,
// one lane a thread, or four as 16-byte table loads where the wrapper asks
// for them (launches wide enough that the grid stays large) and W and the
// pointers allow, and a grid barrier after each gather and each scatter.
// The next step's first addresses are loaded before the barrier that ends
// a step. L1 is not coherent across SMs, so the gather reads with __ldcg
// (L2 only): a word scattered by another SM in an earlier step is never
// stale.
//
// Bound. The kernel moves bytes and computes nothing: per step it reads
// W addresses (4 B), W write flags (1 B) and W gathered words (8 B), and
// writes W gathered words (8 B); each write lane adds its store value read
// (8 B) and its scattered word (8 B). On the wide path with an image past
// L2 each random gather and scatter moves a whole 32-byte sector; every
// step pays two barriers of its path (grid_sync_kernel and
// resident_sync_kernel below time them alone). The resident path also
// reads the store values of non-write lanes (8 B each), so that no load
// waits for its write flag.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // wide path: threads per block
constexpr int kResidentThreads = 512;  // resident path: most per block

// ---------------------------------------------------------------- wide

template <int V>
__device__ __forceinline__ void load_addrs(const int* p, int (&a)[V]) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  } else {
    a[0] = __ldg(p);
  }
}

// V lanes a thread (4: 16-byte table loads; 1: any W or alignment).
template <int V>
__global__ void __launch_bounds__(kThreads)
wave_wide_kernel(long long* mem, long long m, const int* __restrict__ addrs,
                 const unsigned char* __restrict__ writes,
                 const long long* __restrict__ svals,
                 long long* __restrict__ vals, int s_steps, int w) {
  cg::grid_group grid = cg::this_grid();
  const long long nq = w / V;  // V divides w (the launcher checks)
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int nxt[V];  // the first group's addresses of the next step
  if (first < nq) load_addrs<V>(addrs + first * V, nxt);
  for (int s = 0; s < s_steps; ++s) {
    const long long row = (long long)s * w;
    int cur[V];
#pragma unroll
    for (int k = 0; k < V; ++k) cur[k] = nxt[k];
    // gather against the pre-step image, clipped like the reference
    for (long long q = first; q < nq; q += stride) {
      int a[V];
      if (q == first) {
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = cur[k];
      } else {
        load_addrs<V>(addrs + row + q * V, a);
      }
      long long v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const long long c = a[k] < 0 ? 0 : (a[k] >= m ? m - 1 : a[k]);
        v[k] = __ldcg(mem + c);
      }
      if constexpr (V == 4) {
        longlong2* out = reinterpret_cast<longlong2*>(vals + row + q * 4);
        out[0] = make_longlong2(v[0], v[1]);
        out[1] = make_longlong2(v[2], v[3]);
      } else {
        vals[row + q] = v[0];
      }
    }
    grid.sync();
    // scatter write lanes only; an out-of-range write lane is dropped
    for (long long q = first; q < nq; q += stride) {
      unsigned flags;
      if constexpr (V == 4) {
        flags = __ldg(reinterpret_cast<const unsigned*>(writes + row + q * 4));
      } else {
        flags = __ldg(writes + row + q);
      }
      if (flags == 0) continue;
      int a[V];
      if (q == first) {
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = cur[k];
      } else {
        load_addrs<V>(addrs + row + q * V, a);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (((flags >> (8 * k)) & 0xffu) && a[k] >= 0 && a[k] < m) {
          mem[a[k]] = __ldg(svals + row + q * V + k);
        }
      }
    }
    if (s + 1 < s_steps && first < nq) {
      load_addrs<V>(addrs + row + w + first * V, nxt);
    }
    grid.sync();
  }
}

// Two grid barriers per step and nothing else, at a grid the caller
// chooses: the barrier cost of the wide path at that grid, measured apart
// from its memory traffic.
__global__ void __launch_bounds__(kThreads) grid_sync_kernel(int s_steps) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < s_steps; ++s) {
    grid.sync();
    grid.sync();
  }
}

// ------------------------------------------------------------ resident

__device__ __forceinline__ long long load_word(uint32_t at) {
  long long v;
  asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(at) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(uint32_t at, long long v) {
  asm volatile("st.shared.b64 [%0], %1;" :: "r"(at), "l"(v) : "memory");
}

// Lane i of a step belongs to thread i mod blockDim.x, as its k-th lane
// for k = i / blockDim.x < K.
template <int K>
__device__ __forceinline__ void load_step(
    const int* __restrict__ addrs, const unsigned char* __restrict__ writes,
    const long long* __restrict__ svals, long long row, int w, int (&a)[K],
    unsigned (&wr)[K], long long (&sv)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < w) {
      a[k] = __ldg(addrs + row + i);
      wr[k] = __ldg(writes + row + i);
      sv[k] = __ldg(svals + row + i);
    }
  }
}

// One block holding the whole image; K lanes a thread, P steps of tables
// in registers.
template <int K, int P>
__global__ void __launch_bounds__(kResidentThreads)
wave_resident_kernel(long long* __restrict__ mem, int m,
                     const int* __restrict__ addrs,
                     const unsigned char* __restrict__ writes,
                     const long long* __restrict__ svals,
                     long long* __restrict__ vals, int s_steps, int w) {
  extern __shared__ __align__(16) long long img[];
  // the image in, by asynchronous 8-byte copies
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(img);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(base + 8u * i), "l"(mem + i) : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");

  int a[P][K];
  unsigned wr[P][K];
  long long sv[P][K];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < s_steps) {
      load_step<K>(addrs, writes, svals, (long long)p * w, w, a[p], wr[p],
                   sv[p]);
    }
  }
  __syncthreads();  // the whole image is in before the first gather
  for (int s0 = 0; s0 < s_steps; s0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int s = s0 + p;
      if (s >= s_steps) break;
      const long long row = (long long)s * w;
      // gather against the pre-step image, clipped like the reference
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < w) {
          const int c = a[p][k] < 0 ? 0 : (a[p][k] >= m ? m - 1 : a[p][k]);
          vals[row + i] = load_word(base + 8u * (unsigned)c);
        }
      }
      __syncthreads();
      // scatter write lanes only; an out-of-range write lane is dropped
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < w && wr[p][k] && a[p][k] >= 0 && a[p][k] < m) {
          store_word(base + 8u * (unsigned)a[p][k], sv[p][k]);
        }
      }
      if (s + P < s_steps) {
        load_step<K>(addrs, writes, svals, (long long)(s + P) * w, w, a[p],
                     wr[p], sv[p]);
      }
      __syncthreads();
    }
  }
  // the last barrier ordered every scatter before this: write back
  for (int i = threadIdx.x; i < m; i += blockDim.x) mem[i] = img[i];
}

// Two block barriers per step and nothing else.
__global__ void __launch_bounds__(kResidentThreads)
resident_sync_kernel(int s_steps) {
  for (int s = 0; s < s_steps; ++s) {
    __syncthreads();
    __syncthreads();
  }
}

template <int K, int P>
cudaError_t launch_resident(long long* mem, int m, const int* addrs,
                            const unsigned char* writes,
                            const long long* svals, long long* vals,
                            int s_steps, int w, int threads,
                            cudaStream_t stream) {
  wave_resident_kernel<K, P><<<1, threads, (size_t)m * 8, stream>>>(
      mem, m, addrs, writes, svals, vals, s_steps, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The co-resident limit of the wide kernel on the current device (blocks
// per SM times SMs): the largest grid a cooperative launch accepts. The
// wrapper asks once per device and sizes each launch from it.
int wave_loop_max_grid(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wave_wide_kernel<4>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// The int64 words one resident block's shared memory may hold on the
// current device (its opt-in limit over 8 bytes). Sets that limit on every
// resident instance first.
int wave_resident_words(int* words) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const void* fns[] = {
      (const void*)wave_resident_kernel<1, 4>,
      (const void*)wave_resident_kernel<2, 4>,
      (const void*)wave_resident_kernel<4, 2>,
      (const void*)wave_resident_kernel<8, 2>,
  };
  for (const void* fn : fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return (int)e;
  }
  *words = optin / 8;
  return 0;
}

// Wide path: S steps of width W over mem (M words) on `stream` with
// `grid` blocks (at most wave_loop_max_grid), `lanes` (1 or 4) lanes a
// thread a pass; four only where W is a multiple of 4 and the tables are
// aligned for 16-byte loads, else one. Returns a cudaError_t (0 =
// launched).
int wave_loop_launch(long long* mem, long long m, const int* addrs,
                     const unsigned char* writes, const long long* svals,
                     long long* vals, int s_steps, int w, int grid, int lanes,
                     void* stream) {
  const bool vec = lanes == 4 && w % 4 == 0 &&
                   ((uintptr_t)addrs % 16) == 0 &&
                   ((uintptr_t)vals % 16) == 0 &&
                   ((uintptr_t)writes % 4) == 0;
  void* args[] = {&mem, &m, &addrs, &writes, &svals, &vals, &s_steps, &w};
  const void* fn = vec ? (const void*)wave_wide_kernel<4>
                       : (const void*)wave_wide_kernel<1>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3((unsigned)grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Resident path: S steps of width W over mem (M words, at most
// wave_resident_words) in one block of `threads` threads (a multiple of
// 32, at most kResidentThreads), `lanes` (1, 2, 4 or 8) lanes a thread,
// threads x lanes >= W. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for sizes outside these.
int wave_resident_launch(long long* mem, int m, const int* addrs,
                         const unsigned char* writes, const long long* svals,
                         long long* vals, int s_steps, int w, int threads,
                         int lanes, void* stream) {
  if (threads < 32 || threads > kResidentThreads || threads % 32 != 0 ||
      m < 1 || (long long)threads * lanes < w) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 1:
      return (int)launch_resident<1, 4>(mem, m, addrs, writes, svals, vals,
                                        s_steps, w, threads, st);
    case 2:
      return (int)launch_resident<2, 4>(mem, m, addrs, writes, svals, vals,
                                        s_steps, w, threads, st);
    case 4:
      return (int)launch_resident<4, 2>(mem, m, addrs, writes, svals, vals,
                                        s_steps, w, threads, st);
    case 8:
      return (int)launch_resident<8, 2>(mem, m, addrs, writes, svals, vals,
                                        s_steps, w, threads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// Runs resident_sync_kernel: S steps of two block barriers in one block of
// `threads` threads.
int resident_sync_launch(int threads, int s_steps, void* stream) {
  if (threads < 32 || threads > kResidentThreads) {
    return (int)cudaErrorInvalidValue;
  }
  resident_sync_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(s_steps);
  return (int)cudaGetLastError();
}

const char* wave_exec_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
