// K6 (flash attention, the prefill) and K7 (decode attention against a KV
// cache), written by hand for sm_90a.
//
// K6 replaces the TPU kernel _flash_kernel in
// src/repro/kernels/attention/kernel.py (reached through flash_attention
// there), the twin of the model's blocked loop flash_mha
// (src/repro/models/flash.py):
//
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / rep]
//   s[i, j]    = sm_scale * q[b, i, h] . k[b, j, h / rep]   (-1e30 where
//                causal and j > i)
//
// K7 replaces _decode_kernel there (reached through decode_attention): one
// query per (b, h) against a KV cache of capacity C, masked at the committed
// frontier, s[j] = -1e30 for j >= lengths[b] (the RAW pair append / attend of
// DESIGN.md section 3.2).
//
// Layout. Both kernels take the model's layout, q (B, S, H, D) and k, v
// (B, S_kv, Hk, D), contiguous, with query head h reading kv head
// h / (H / Hk) by index (GQA; K and V are never copied per query head). The
// reference's (BH, S, d) layout is the case H = Hk = 1. Sizes are run-time
// arguments: a ragged last tile is masked, where the Pallas kernels assert
// that S and S_kv divide by their blocks. Inputs are float32, float16 or
// bfloat16; every sum is in float32 and the output is in the input's type.
//
// Numerics, as the reference's: q is scaled by sm_scale on load; the running
// max starts at NEG_INF = -1e30, masked scores are -1e30, the softmax is
// online in float32 (m, l, alpha = exp(m_old - m_new)), and the output is
// acc / max(l, 1e-30). Keys past S_kv in a ragged tile get no weight at all.
//
// K6 design. One block of 256 threads per (b * H + h, tile of 64 query
// rows); the heaviest causal tiles are dispatched first. The scaled q tile
// stays in shared memory; K and V tiles of 64 keys stream through shared
// memory (rows padded by one word against bank conflicts). Each thread
// computes 4 x 4 scores of the tile; then each warp owns 8 rows: it updates
// their running max and sum with warp shuffles and accumulates their
// 8 x D/32 outputs in registers. Causal tiles stop at the diagonal
// (the Pallas kernel's block skip).
//
// K6 bound. Operations: 4 * B * H * S * S_kv * D multiply-adds' flops, half
// of it when causal, in float32 on the CUDA cores: at B=1, H=40, S=4096,
// D=128 causal, 171.8 GFLOP, 2.56 ms at the H100 SXM's 67 TFLOP/s (132 SMs x
// 128 lanes x 2 x 1.98 GHz). The TF32 tensor cores (495 TFLOP/s, 0.35 ms)
// would need wgmma and TF32's precision; the port keeps float32.
//
// K7 design. One block of 256 threads per (b, kv head); it serves that kv
// head's rep = H / Hk query heads, so each committed K and V row is read
// once. The loop stops at the frontier min(lengths[b], C): the Pallas kernel
// walks all of C and masks, but once one entry is committed each masked one
// adds exp(-1e30 - m) = 0 and alpha = 1 in float32, so the result is the
// same and the load stream never looks past the frontier. lengths[b] <= 0
// keeps the reference's result: every score is -1e30, so the output is the
// uniform average of the whole cache (not zeros).
//
// K7 bound. Bytes: the committed K and V rows, once each, plus q and the
// output. Tiles of 64 keys go through shared memory; the output sums of the
// rep heads stay in shared memory.
//
// Plain C interface (no PyTorch headers): the wrappers in ../kernel.py pass
// data_ptr()s and the current stream through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;  // K6 query rows per block
constexpr int kBK = 64;  // keys per tile, both kernels
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__half* p, float x) {
  *p = __float2half_rn(x);
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// One online-softmax update of row r over a tile of kBK scores held at
// s_row: the row's running max and sum in m[r], l[r], alpha in a[r], and
// the tile's weights written back over the scores. Called by one warp.
__device__ __forceinline__ void softmax_row(float* s_row, float* m, float* l,
                                            float* a, int r, int lane) {
  const float x0 = s_row[lane], x1 = s_row[lane + 32];
  const float m_old = m[r];
  const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
  const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
  const float sum = warp_sum(p0 + p1);
  s_row[lane] = p0;
  s_row[lane + 32] = p1;
  if (lane == 0) {
    const float alpha = expf(m_old - m_new);
    m[r] = m_new;
    l[r] = l[r] * alpha + sum;
    a[r] = alpha;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int S_kv,
                 int H, int Hk, int d, int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int P = d + 1;
  float* sQ = smem;                 // kBQ x P, scaled
  float* sK = sQ + kBQ * P;         // kBK x P
  float* sV = sK + kBK * P;         // kBK x P
  float* sS = sV + kBK * P;         // kBQ x (kBK + 1): scores, then weights
  float* sM = sS + kBQ * (kBK + 1);
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;
  constexpr int SP = kBK + 1;
  constexpr int NJ = DMAX / 32;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tile first
  const long long q_pos = (long long)H * d, kv_pos = (long long)Hk * d;
  const T* qb = q + ((long long)b * S * H + h) * d;
  const T* kb = k + ((long long)b * S_kv * Hk + hk) * d;
  const T* vb = v + ((long long)b * S_kv * Hk + hk) * d;
  T* ob = o + ((long long)b * S * H + h) * d;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e % d, i = q0 + r;
    sQ[r * P + c] = i < S ? to_f(qb[i * q_pos + c]) * sm_scale : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // causal: keys past the tile's last row are masked for every row
  const int n_kv = causal ? min(S_kv, q0 + kBQ) : S_kv;
  for (int k0 = 0; k0 < n_kv; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d, j = k0 + r;
      const bool in = j < S_kv;
      sK[r * P + c] = in ? to_f(kb[j * kv_pos + c]) : 0.f;
      sV[r * P + c] = in ? to_f(vb[j * kv_pos + c]) : 0.f;
    }
    __syncthreads();
    {  // scores: rows ty * 4 + i, keys tx + 16 * jj
      const int ty = tid >> 4, tx = tid & 15;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      for (int c = 0; c < d; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * P + c];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 16 * jj) * P + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = ty * 4 + i, cj = tx + 16 * jj, j = k0 + cj;
          float x = s[i][jj];
          if (j >= S_kv) x = -INFINITY;
          else if (causal && j > q0 + r) x = kNegInf;
          sS[r * SP + cj] = x;
        }
    }
    __syncthreads();
    // each warp: the running softmax, then the outputs, of its 8 rows
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      softmax_row(sS + r * SP, sM, sL, sA, r, lane);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float alpha = sA[warp * kRowsPerWarp + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    const int cnt = min(kBK, S_kv - k0);
    for (int kk = 0; kk < cnt; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < d ? sV[kk * P + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = sS[(warp * kRowsPerWarp + i) * SP + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i, qi = q0 + r;
    if (qi >= S) continue;
    const float inv_l = 1.f / fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) store_f(&ob[qi * q_pos + c], acc[i][j] * inv_l);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, int C, int H, int Hk, int d,
                  float sm_scale) {
  extern __shared__ float smem[];
  const int rep = H / Hk, P = d + 1;
  float* sQ = smem;                // rep x d, scaled
  float* sO = sQ + rep * d;        // rep x d output sums
  float* sK = sO + rep * d;        // kBK x P
  float* sV = sK + kBK * P;        // kBK x P
  float* sS = sV + kBK * P;        // rep x kBK: scores, then weights
  float* sM = sS + rep * kBK;
  float* sL = sM + rep;
  float* sA = sL + rep;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk;
  const int len = lengths[b];
  // nothing committed: every score is -1e30 and the output is the uniform
  // average of the whole cache, as in the reference
  const bool none = len <= 0;
  const int n = none ? C : min(len, C);
  const long long kv_pos = (long long)Hk * d;
  const T* qb = q + ((long long)b * H + (long long)hk * rep) * d;
  const T* kb = k + ((long long)b * C * Hk + hk) * d;
  const T* vb = v + ((long long)b * C * Hk + hk) * d;
  T* ob = o + ((long long)b * H + (long long)hk * rep) * d;

  for (int e = tid; e < rep * d; e += kThreads) {
    sQ[e] = to_f(qb[e]) * sm_scale;
    sO[e] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int cnt = min(kBK, n - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < cnt * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const long long at = (long long)(k0 + r) * kv_pos + c;
      sK[r * P + c] = to_f(kb[at]);
      sV[r * P + c] = to_f(vb[at]);
    }
    __syncthreads();
    for (int e = tid; e < rep * kBK; e += kThreads) {
      const int r = e / kBK, jj = e % kBK;
      float x = -INFINITY;  // past the frontier within this tile: no weight
      if (jj < cnt) {
        if (none) {
          x = kNegInf;
        } else {
          x = 0.f;
          for (int c = 0; c < d; ++c) x = fmaf(sQ[r * d + c], sK[jj * P + c], x);
        }
      }
      sS[e] = x;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kWarps)
      softmax_row(sS + r * kBK, sM, sL, sA, r, lane);
    __syncthreads();
    for (int e = tid; e < rep * d; e += kThreads) {
      const int r = e / d, c = e % d;
      float x = sO[e] * sA[r];
      for (int jj = 0; jj < cnt; ++jj) x = fmaf(sS[r * kBK + jj], sV[jj * P + c], x);
      sO[e] = x;
    }
  }
  __syncthreads();
  for (int e = tid; e < rep * d; e += kThreads)
    store_f(&ob[e], sO[e] / fmaxf(sL[e / d], 1e-30f));
}

size_t flash_smem(int d) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (d + 1) + kBQ * (kBK + 1) + 3 * kBQ);
}

size_t decode_smem(int rep, int d) {
  return sizeof(float) * ((size_t)2 * rep * d + (size_t)2 * kBK * (d + 1) +
                          (size_t)rep * kBK + 3 * rep);
}

template <typename T, int DMAX>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int S_kv, int H, int Hk, int d,
                         int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = flash_smem(d);
  auto kern = flash_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, S_kv, H, Hk, d, causal,
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flash_d(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int S_kv, int H, int Hk,
                           int d, int causal, float sm_scale,
                           cudaStream_t stream) {
  if (d <= 32)
    return launch_flash<T, 32>(q, k, v, o, B, S, S_kv, H, Hk, d, causal,
                               sm_scale, stream);
  if (d <= 64)
    return launch_flash<T, 64>(q, k, v, o, B, S, S_kv, H, Hk, d, causal,
                               sm_scale, stream);
  if (d <= 128)
    return launch_flash<T, 128>(q, k, v, o, B, S, S_kv, H, Hk, d, causal,
                                sm_scale, stream);
  return launch_flash<T, 256>(q, k, v, o, B, S, S_kv, H, Hk, d, causal,
                              sm_scale, stream);
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, int B, int C, int H,
                          int Hk, int d, float sm_scale, cudaStream_t stream) {
  const size_t smem = decode_smem(H / Hk, d);
  auto kern = decode_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)(B * Hk), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, C, H, Hk, d,
      sm_scale);
  return cudaGetLastError();
}

bool shapes_ok(int B, int H, int Hk, int d) {
  return B > 0 && Hk > 0 && H >= Hk && H % Hk == 0 && d > 0 && d <= kMaxD;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float16, 2 bfloat16. q (B, S, H, d), k and v
// (B, S_kv, Hk, d), o (B, S, H, d), all contiguous; S, S_kv >= 1 and
// S <= 65535 * 64. Returns a cudaError_t (0 = launched).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, int B, int S, int S_kv,
                           int H, int Hk, int d, int causal, float sm_scale,
                           void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (!shapes_ok(B, H, Hk, d) || S < 1 || S_kv < 1 ||
      (S + kBQ - 1) / kBQ > 65535 || flash_smem(d) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_flash_d<float>(q, k, v, o, B, S, S_kv, H, Hk, d,
                                        causal, sm_scale, stream);
    case 1:
      return (int)launch_flash_d<__half>(q, k, v, o, B, S, S_kv, H, Hk, d,
                                         causal, sm_scale, stream);
    case 2:
      return (int)launch_flash_d<__nv_bfloat16>(q, k, v, o, B, S, S_kv, H, Hk,
                                                d, causal, sm_scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// q (B, H, d), caches (B, C, Hk, d), lengths (B,) int32, o (B, H, d), all
// contiguous, C >= 1. Returns a cudaError_t (0 = launched).
int decode_attention_launch(int dtype, const void* q, const void* k,
                            const void* v, const int* lengths, void* o, int B,
                            int C, int H, int Hk, int d, float sm_scale,
                            void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (!shapes_ok(B, H, Hk, d) || C < 1 ||
      decode_smem(H / Hk, d) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_decode<float>(q, k, v, lengths, o, B, C, H, Hk, d,
                                       sm_scale, stream);
    case 1:
      return (int)launch_decode<__half>(q, k, v, lengths, o, B, C, H, Hk, d,
                                        sm_scale, stream);
    case 2:
      return (int)launch_decode<__nv_bfloat16>(q, k, v, lengths, o, B, C, H,
                                               Hk, d, sm_scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* attention_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
