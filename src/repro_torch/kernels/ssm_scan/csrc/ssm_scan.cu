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
// slab of channels of one batch row and walks all S positions itself, the
// states in registers, one exponential per (t, d, j).
//
// - One thread a channel. A thread holds its channel's n <= 16 states and
//   sums y over them itself, with no shuffles; a block is 128 threads, so
//   128 channels. At falcon-mamba's width (B = 4, di = 8192) that is 256
//   blocks, all resident in one round on 132 SMs; a batch of one or two at
//   that width gives 64 or 128 blocks and leaves SMs idle (no path of the
//   port runs it).
// - Loads overlap the scan. Positions go through shared memory kChunk at a
//   time in a ring of kStages buffers: x and dt as (kChunk x channels) rows,
//   B and C as (kChunk x 16) rows, zero-padded past n so that padded states
//   stay exactly 0. Each buffer is filled by cp.async (16-byte copies where
//   di, n and the pointers allow it, else plain loads) while the block scans
//   the one before it. y goes straight from registers to device memory, one
//   coalesced row a position, so shared memory holds only the inputs.
// - The position loop of a whole chunk has a compile-time bound and is
//   unrolled 8 positions a pass (128 state updates a thread),
//   so the exponentials of later positions, which do not depend on h, issue
//   under the fmaf chain on h; a ragged last chunk goes through a masked loop.
// - Each exponential is one ex2.approx.ftz.f32 (MUFU.EX2, the scarce unit) of
//   (a_neg * log2 e) * dt, a_neg scaled once when the block starts: one FMUL
//   and one MUFU a state, where expf adds about 7 FMA-pipe instructions. The
//   argument's rounding error grows with |a_neg * dt|, but only where the
//   decay exp(a_neg * dt) is already negligible (relative error ~2^-22 |arg|
//   of a decay e^-|arg|); results below 2^-126 flush to zero.
//
// S and di are run-time sizes: a ragged last chunk or slab is masked (the TPU
// kernel asserts S % 128 == 0 and di % 512 == 0).
//
// Bound. At falcon-mamba's widths (B=4, S=4096, di=8192, n=16): the B*S*di*n
// = 2^31 exponentials take 0.51 ms at 16 special-function results per SM per
// clock; the bytes of x, dt and y, 1.61 GB, take 0.48 ms at 3.35 TB/s. At the
// SSM path's prefill (S=128) both are about 0.016 ms. The kernel runs at about
// 0.6 of the bound at S=4096; with the exponentials replaced by a multiply it
// runs only 10% faster, so neither they nor the bytes alone hold it there.
//
// Plain C interface (no PyTorch headers): the wrapper in ../kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;      // states a channel at most
constexpr int kThreads = 128;  // threads a block, one a channel
constexpr int kChunk = 32;     // positions a buffer
constexpr int kStages = 2;     // buffers in the ring
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one buffer of the ring: x (kChunk x kThreads, x's type), dt (kChunk x
// kThreads), B and C (kChunk x kMaxN), in that order
template <typename T>
struct Buffer {
  static constexpr size_t kXBytes = sizeof(T) * kChunk * kThreads;
  static constexpr size_t kBytes =
      kXBytes + sizeof(float) * kChunk * (kThreads + 2 * kMaxN);
  static_assert(kXBytes % 16 == 0, "dt must start 16-byte aligned");
  T* x;
  float *dt, *b, *c;
  __device__ explicit Buffer(char* p)
      : x(reinterpret_cast<T*>(p)),
        dt(reinterpret_cast<float*>(p + kXBytes)),
        b(dt + kChunk * kThreads),
        c(b + kChunk * kMaxN) {}
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ xi, const float* __restrict__ dt,
                    const float* __restrict__ bmat,
                    const float* __restrict__ cmat,
                    const float* __restrict__ a_neg,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_out, int s, int di, int n,
                    int vec_xd, int vec_bc) {
  constexpr int CH = kThreads;         // channels a block
  constexpr int XV = 16 / sizeof(T);   // x elements a 16-byte copy
  constexpr int kUnroll = 8;           // positions a pass of the unrolled loop
  static_assert(kChunk % kUnroll == 0, "a chunk is whole passes");
  extern __shared__ __align__(16) char smem[];

  const int c = threadIdx.x;  // channel within the slab
  const int n_slabs = (di + CH - 1) / CH;
  const int b = blockIdx.x / n_slabs;
  const int d0 = (blockIdx.x - b * n_slabs) * CH;
  const int d = d0 + c;
  const int width = di - d0 < CH ? di - d0 : CH;
  const bool live = c < width;
  const size_t row0 = (size_t)b * s;  // this batch row's first position

  // B and C past n stay 0 in every buffer; the copies below write j < n only
  if (n < kMaxN) {
    for (int e = c; e < kStages * kChunk * kMaxN; e += kThreads) {
      if (e % kMaxN >= n) {
        Buffer<T> buf(smem + (e / (kChunk * kMaxN)) * Buffer<T>::kBytes);
        const int i = e % (kChunk * kMaxN);
        buf.b[i] = 0.0f;
        buf.c[i] = 0.0f;
      }
    }
  }

  // positions [t0, t0 + len) into buffer `stage`
  auto load = [&](int t0, int len, int stage) {
    Buffer<T> buf(smem + stage * Buffer<T>::kBytes);
    const size_t p0 = row0 + t0;
    if (vec_xd) {  // width and d0 are whole copies
      constexpr int XQ = CH / XV, DQ = CH / 4;
      const int xq = width / XV, dq = width / 4;
      for (int e = c; e < len * XQ; e += kThreads) {
        const int r = e / XQ, q = e % XQ;
        if (q < xq)
          cp_async16(buf.x + r * CH + q * XV, xi + (p0 + r) * di + d0 + q * XV);
      }
      for (int e = c; e < len * DQ; e += kThreads) {
        const int r = e / DQ, q = e % DQ;
        if (q < dq)
          cp_async16(buf.dt + r * CH + q * 4, dt + (p0 + r) * di + d0 + q * 4);
      }
    } else {
      for (int e = c; e < len * CH; e += kThreads) {
        const int r = e / CH, cc = e % CH;
        if (cc < width) {
          buf.x[r * CH + cc] = xi[(p0 + r) * di + d0 + cc];
          buf.dt[r * CH + cc] = dt[(p0 + r) * di + d0 + cc];
        }
      }
    }
    if (vec_bc) {  // n % 4 == 0
      const int nq = n / 4;
      for (int e = c; e < len * nq; e += kThreads) {
        const int r = e / nq, q = e - r * nq;
        cp_async16(buf.b + r * kMaxN + 4 * q, bmat + (p0 + r) * n + 4 * q);
        cp_async16(buf.c + r * kMaxN + 4 * q, cmat + (p0 + r) * n + 4 * q);
      }
    } else {
      for (int e = c; e < len * n; e += kThreads) {
        const int r = e / n, j = e - r * n;
        buf.b[r * kMaxN + j] = bmat[(p0 + r) * n + j];
        buf.c[r * kMaxN + j] = cmat[(p0 + r) * n + j];
      }
    }
  };

  float a2[kMaxN], h[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    const bool on = live && j < n;
    a2[j] = on ? a_neg[(size_t)d * n + j] * kLog2e : 0.0f;
    h[j] = on && h0 != nullptr ? h0[((size_t)b * di + d) * n + j] : 0.0f;
  }

  // one position: the states' update and y
  auto step = [&](const Buffer<T>& buf, int r, size_t t) {
    const float dv = buf.dt[r * CH + c];
    const float dx = __fmul_rn(dv, to_f(buf.x[r * CH + c]));
    float bs[kMaxN], cs[kMaxN];
#pragma unroll
    for (int q = 0; q < kMaxN / 4; ++q) {
      const float4 bv =
          *reinterpret_cast<const float4*>(buf.b + r * kMaxN + 4 * q);
      const float4 cv =
          *reinterpret_cast<const float4*>(buf.c + r * kMaxN + 4 * q);
      bs[4 * q] = bv.x, bs[4 * q + 1] = bv.y, bs[4 * q + 2] = bv.z,
      bs[4 * q + 3] = bv.w;
      cs[4 * q] = cv.x, cs[4 * q + 1] = cv.y, cs[4 * q + 2] = cv.z,
      cs[4 * q + 3] = cv.w;
    }
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      h[j] = fmaf(ex2(a2[j] * dv), h[j], __fmul_rn(dx, bs[j]));
      acc = fmaf(h[j], cs[j], acc);
    }
    if (live) y[t * di + d] = from_f<T>(acc);
  };

  const int n_chunks = (s + kChunk - 1) / kChunk;
  auto chunk_len = [&](int i) {
    return s - i * kChunk < kChunk ? s - i * kChunk : kChunk;
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_chunks) load(i * kChunk, chunk_len(i), i);
    cp_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    cp_wait<kStages - 2>();
    __syncthreads();  // chunk i landed; the buffer of chunk i - 1 is free
    const int next = i + kStages - 1;
    if (next < n_chunks) load(next * kChunk, chunk_len(next), next % kStages);
    cp_commit();
    const Buffer<T> buf(smem + (i % kStages) * Buffer<T>::kBytes);
    const size_t t0 = row0 + (size_t)i * kChunk;
    const int len = chunk_len(i);
    if (len == kChunk) {
#pragma unroll 1
      for (int r0 = 0; r0 < kChunk; r0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) step(buf, r0 + u, t0 + r0 + u);
      }
    } else {
#pragma unroll 1
      for (int r = 0; r < len; ++r) step(buf, r, t0 + r);
    }
  }

  // the final state: a thread's n words are contiguous, stored 16 bytes at
  // a time where n = 16 and h_out allows it (one word at a time, the lanes'
  // stores 64 bytes apart, left most of a call's fixed cost at S = 1)
  float* hp = h_out + ((size_t)b * di + d) * n;
  if (n == kMaxN && (uintptr_t)h_out % 16 == 0) {
    if (live) {
#pragma unroll
      for (int q = 0; q < kMaxN / 4; ++q)
        reinterpret_cast<float4*>(hp)[q] =
            make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (live && j < n) hp[j] = h[j];
  }
}

template <typename T>
cudaError_t launch(const void* xi, const float* dt, const float* bmat,
                   const float* cmat, const float* a_neg, const float* h0,
                   void* y, float* h_out, int b, int s, int di, int n,
                   cudaStream_t stream) {
  const size_t smem = kStages * Buffer<T>::kBytes;
  auto kern = ssm_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int align = (int)(((uintptr_t)xi | (uintptr_t)dt) % 16);
  const int vec_xd = align == 0 && di % 4 == 0 && di % (16 / sizeof(T)) == 0;
  const int vec_bc =
      n % 4 == 0 && ((uintptr_t)bmat | (uintptr_t)cmat) % 16 == 0;
  const long long blocks = (long long)b * ((di + kThreads - 1) / kThreads);
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xi), dt, bmat, cmat, a_neg, h0,
      static_cast<T*>(y), h_out, s, di, n, vec_xd, vec_bc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The scan over contiguous xi (B, S, di) of type `dtype` (0 float32, 1
// float16, 2 bfloat16), float32 dt (B, S, di), B and C (B, S, n), a_neg
// (di, n) and h0 (B, di, n) or null for zeros, on `stream`: y (B, S, di) in
// xi's type and h_out (B, di, n) float32. The wrapper asks for B, S, di >= 1,
// 1 <= n <= 16 and xi of fewer than 2**31 elements. Returns a cudaError_t (0 =
// launched), or cudaErrorInvalidValue for another dtype or n.
int ssm_scan_launch(int dtype, const void* xi, const float* dt,
                    const float* bmat, const float* cmat, const float* a_neg,
                    const float* h0, void* y, float* h_out, int b, int s,
                    int di, int n, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch<float>(xi, dt, bmat, cmat, a_neg, h0, y, h_out, b, s,
                                di, n, st);
    case 1:
      return (int)launch<__half>(xi, dt, bmat, cmat, a_neg, h0, y, h_out, b,
                                 s, di, n, st);
    case 2:
      return (int)launch<__nv_bfloat16>(xi, dt, bmat, cmat, a_neg, h0, y,
                                        h_out, b, s, di, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ssm_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
