// K8: the Mamba-1 selective scan, written by hand for sm_90a.
//
// Replaces the TPU kernel _scan_kernel in src/repro/kernels/ssm_scan/kernel.py
// (reached through ssm_scan there, batched by vmap in its ops.py). For every
// batch row b, channel d and state j, from h = h0 (zeros when none is given):
//
//   h[t][d][j] = exp(a_neg[d][j] * dt[t][d]) * h[t-1][d][j]
//                + (dt[t][d] * x[t][d]) * B[t][j]
//   y[t][d]    = sum over j of C[t][j] * h[t][d][j]
//
// with h in float32, y written in x's type (float32, float16 or bfloat16; dt,
// B, C, a_neg and h0 are float32), and the final state written out, so one
// launch serves both a prompt from a zero state and a continuation. The
// association (dt * x) * B is the TPU kernel's; the term is rounded on its own
// (__fmul_rn) and added to a * h with one fmaf.
//
// Design. The TPU kernel's grid is (di blocks, chunks of 128 positions), the
// chunk axis sequential so that h can stay in VMEM from one grid step to the
// next. Nothing carries over between blocks on Hopper, so here a block owns a
// slab of kChannels channels of one batch row and walks all S positions
// itself. Each channel's n <= 16 states are split over kParts = 4 neighbouring
// threads, kStates = 4 states each, in registers; y is summed over the four
// with two shuffles. Positions go through shared memory kChunk at a time: x
// and dt as (kChunk x kChannels) tiles, neighbouring threads on neighbouring
// channels, and B and C as (kChunk x 16) rows, zero-padded past n, so padded
// states stay exactly 0. y is staged in shared memory and stored as the
// loads were. S and di are run-time sizes: a ragged last chunk or slab is
// masked (the TPU kernel asserts S % 128 == 0 and di % 512 == 0).
//
// Bound. At falcon-mamba's widths (B=4, S=4096, di=8192, n=16): the bytes of
// x, dt and y, 1.61 GB, take 0.48 ms at 3.35 TB/s; the B*S*di*n = 2^31
// exponentials take 0.51 ms at 16 special-function results per SM per clock.
// A tie. Each exponential is expf, not __expf: both take one MUFU.EX2 (the
// scarce unit), and expf's few extra FMA-pipe instructions keep its error
// within 2 ulp over the whole range, where __expf's grows with |a_neg * dt|
// (tens here), which would set the error against the plain version.
//
// Plain C interface (no PyTorch headers): the wrapper in ../kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kParts = 4;    // threads sharing one channel's states
constexpr int kStates = 4;   // states per thread
constexpr int kMaxN = kParts * kStates;
constexpr int kChannels = 32;  // channels per block
constexpr int kThreads = kParts * kChannels;
constexpr int kChunk = 64;   // positions staged per pass

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
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ xi, const float* __restrict__ dt,
                const float* __restrict__ bmat, const float* __restrict__ cmat,
                const float* __restrict__ a_neg, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, int s, int di,
                int n) {
  __shared__ float s_x[kChunk][kChannels];
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_y[kChunk][kChannels];
  __shared__ __align__(16) float s_b[kChunk][kMaxN];
  __shared__ __align__(16) float s_c[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int c = tid / kParts;  // channel within the slab
  const int part = tid % kParts;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int width = di - d0 < kChannels ? di - d0 : kChannels;
  const bool live = c < width;

  float a[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int j = part * kStates + k;
    const bool on = live && j < n;
    const size_t at = ((size_t)b * di + d) * n + j;
    a[k] = on ? a_neg[(size_t)d * n + j] : 0.0f;
    h[k] = on && h0 != nullptr ? h0[at] : 0.0f;
  }

  const size_t row0 = (size_t)b * s;  // this batch row's first position
  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = s - t0 < kChunk ? s - t0 : kChunk;
    for (int e = tid; e < len * kChannels; e += kThreads) {
      const int r = e / kChannels;
      const int cc = e - r * kChannels;
      float xv = 0.0f, dv = 0.0f;
      if (cc < width) {
        const size_t g = (row0 + t0 + r) * di + d0 + cc;
        xv = to_f(xi[g]);
        dv = dt[g];
      }
      s_x[r][cc] = xv;
      s_dt[r][cc] = dv;
    }
    for (int e = tid; e < len * kMaxN; e += kThreads) {
      const int r = e / kMaxN;
      const int j = e - r * kMaxN;
      float bv = 0.0f, cv = 0.0f;
      if (j < n) {
        const size_t g = (row0 + t0 + r) * n + j;
        bv = bmat[g];
        cv = cmat[g];
      }
      s_b[r][j] = bv;
      s_c[r][j] = cv;
    }
    __syncthreads();
    for (int r = 0; r < len; ++r) {
      const float dv = s_dt[r][c];
      const float dx = __fmul_rn(dv, s_x[r][c]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&s_b[r][part * kStates]);
      const float4 cv =
          *reinterpret_cast<const float4*>(&s_c[r][part * kStates]);
      const float bs[kStates] = {bv.x, bv.y, bv.z, bv.w};
      const float cs[kStates] = {cv.x, cv.y, cv.z, cv.w};
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float decay = expf(__fmul_rn(a[k], dv));
        h[k] = fmaf(decay, h[k], __fmul_rn(dx, bs[k]));
        acc = fmaf(h[k], cs[k], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) s_y[r][c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < len * kChannels; e += kThreads) {
      const int r = e / kChannels;
      const int cc = e - r * kChannels;
      if (cc < width) {
        y[(row0 + t0 + r) * di + d0 + cc] = from_f<T>(s_y[r][cc]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int j = part * kStates + k;
    if (live && j < n) h_out[((size_t)b * di + d) * n + j] = h[k];
  }
}

template <typename T>
int launch(const void* xi, const float* dt, const float* bmat,
           const float* cmat, const float* a_neg, const float* h0, void* y,
           float* h_out, int b, int s, int di, int n, cudaStream_t stream) {
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)b);
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xi), dt, bmat, cmat, a_neg, h0,
      static_cast<T*>(y), h_out, s, di, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The scan over contiguous xi (B, S, di) of type `dtype` (0 float32, 1
// float16, 2 bfloat16), float32 dt (B, S, di), B and C (B, S, n), a_neg
// (di, n) and h0 (B, di, n) or null for zeros, on `stream`: y (B, S, di) in
// xi's type and h_out (B, di, n) float32. The wrapper asks for B, di >= 1,
// B <= 65535 and 1 <= n <= 16. Returns a cudaError_t (0 = launched), or
// cudaErrorInvalidValue for another dtype or n.
int ssm_scan_launch(int dtype, const void* xi, const float* dt,
                    const float* bmat, const float* cmat, const float* a_neg,
                    const float* h0, void* y, float* h_out, int b, int s,
                    int di, int n, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(xi, dt, bmat, cmat, a_neg, h0, y, h_out, b, s, di,
                           n, st);
    case 1:
      return launch<__half>(xi, dt, bmat, cmat, a_neg, h0, y, h_out, b, s,
                            di, n, st);
    case 2:
      return launch<__nv_bfloat16>(xi, dt, bmat, cmat, a_neg, h0, y, h_out,
                                   b, s, di, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ssm_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
