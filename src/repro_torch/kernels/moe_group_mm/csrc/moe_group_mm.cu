// K9: the grouped expert matmul of a monotonic MoE dispatch, written by hand
// for sm_90a.
//
// Replaces the TPU kernel _gmm_kernel in src/repro/kernels/moe_group_mm/
// kernel.py (reached through group_matmul there). The rows of x_sorted
// (T_pad, d_in) are tokens sorted by expert and padded so that each row block
// of block_t rows belongs to one expert, block_expert[blk] (ops.py's
// monotonic_dispatch builds the layout):
//
//   out[t] = x_sorted[t] @ w[block_expert[t / block_t]]
//
// with w (E, d_in, d_out), every product and sum in float32 and out written in
// x's type (float32, float16 or bfloat16; x and w share it). As the TPU kernel
// does, every row block is computed, pad rows and trailing blocks included.
// Expert ids are clipped to [0, E) so that no id reads outside w (the
// dispatcher's are in range).
//
// Design. A tiled float32 GEMM on the CUDA cores, no TF32 and no tensor cores
// (the reference accumulates in float32 and its tests hold atol 1e-5). The
// TPU kernel scalar-prefetches the expert ids; here each thread block owns a
// (kBM-row x kBN-column) tile of out inside one row block, reads that block's
// expert id itself, and walks d_in in steps of kBK: the x tile (stored
// transposed, rows padded by 4 words against bank conflicts) and the expert's
// w tile go through two shared-memory buffers, the next step's loaded into
// registers while the current one is multiplied. Each of the 256 threads
// accumulates an 8 x 8 sub-tile in registers with fmaf. block_t is any
// positive size: a row block shorter than kBM, or its ragged last tile, is
// masked (the model uses 128, the reference's tests 8, 16 and 32); d_in and
// d_out are masked too.
//
// Bound. Operations: 2 * T_pad * d_in * d_out flops in float32. At
// phi3.5-moe's prefill (4 x 128 tokens, top-2: T_pad = 3072, d_in = 4096,
// d_out = 6400) that is 161 GFLOP, 2.41 ms at the H100 SXM's 67 TFLOP/s
// (132 SMs x 128 lanes x 2 x 1.98 GHz); its bytes (the experts' weights once,
// 1.68 GB, x and out) take 0.54 ms.
//
// Plain C interface (no PyTorch headers): the wrapper in ../kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // rows of a tile
constexpr int kBN = 128;  // columns of a tile
constexpr int kBK = 8;    // d_in per step
constexpr int kThreads = 256;
constexpr int kPadM = kBM + 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
group_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ block_expert, T* __restrict__ out,
                    int d_in, int d_out, int n_experts, int block_t,
                    int tiles_per_block) {
  __shared__ __align__(16) float s_a[2][kBK][kPadM];  // x tile, transposed
  __shared__ __align__(16) float s_b[2][kBK][kBN];    // w tile

  const int tid = threadIdx.x;
  const int blk = blockIdx.y / tiles_per_block;
  const int r0 = blk * block_t + (blockIdx.y % tiles_per_block) * kBM;
  const int r_end = (blk + 1) * block_t;
  const int rows = r_end - r0 < kBM ? r_end - r0 : kBM;
  const int c0 = blockIdx.x * kBN;
  int e = block_expert[blk];
  e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
  const T* __restrict__ we = w + (size_t)e * d_in * d_out;

  // loader roles: x rows ar + 32p at column ak; w row bk, columns bc + 32p
  const int ak = tid % kBK, ar = tid / kBK;
  const int bk = tid / 32, bc = tid % 32;
  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int ka = k0 + ak;
    const int kb = k0 + bk;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = ar + 32 * p;
      ra[p] = (r < rows && ka < d_in)
                  ? to_f(x[(size_t)(r0 + r) * d_in + ka]) : 0.0f;
      const int col = c0 + bc + 32 * p;
      rb[p] = (kb < d_in && col < d_out)
                  ? to_f(we[(size_t)kb * d_out + col]) : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      s_a[buf][ak][ar + 32 * p] = ra[p];
      s_b[buf][bk][bc + 32 * p] = rb[p];
    }
  };

  // compute roles: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int steps = (d_in + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) load((step + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s_a[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s_b[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s_b[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= rows) continue;
    T* __restrict__ orow = out + (size_t)(r0 + r) * d_out;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (col < d_out) orow[col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* block_expert, void* out,
           int t_pad, int d_in, int d_out, int n_experts, int block_t,
           cudaStream_t stream) {
  const int tiles_per_block = (block_t + kBM - 1) / kBM;
  const long long row_tiles = (long long)(t_pad / block_t) * tiles_per_block;
  if (row_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((d_out + kBN - 1) / kBN), (unsigned)row_tiles);
  group_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), block_expert,
      static_cast<T*>(out), d_in, d_out, n_experts, block_t, tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (T_pad, d_out) = the grouped product of contiguous x (T_pad, d_in) and
// w (E, d_in, d_out), both of type `dtype` (0 float32, 1 float16, 2
// bfloat16), with int32 block_expert (T_pad / block_t,), on `stream`. The
// wrapper asks for T_pad a positive multiple of block_t, d_in, d_out, E >= 1.
// Returns a cudaError_t (0 = launched), or cudaErrorInvalidValue for another
// dtype, cudaErrorInvalidConfiguration for more than 65535 row tiles.
int group_matmul_launch(int dtype, const void* x, const void* w,
                        const int* block_expert, void* out, int t_pad,
                        int d_in, int d_out, int n_experts, int block_t,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, w, block_expert, out, t_pad, d_in, d_out,
                           n_experts, block_t, st);
    case 1:
      return launch<__half>(x, w, block_expert, out, t_pad, d_in, d_out,
                            n_experts, block_t, st);
    case 2:
      return launch<__nv_bfloat16>(x, w, block_expert, out, t_pad, d_in,
                                   d_out, n_experts, block_t, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* group_matmul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
