// K4: SpMV over a block-padded ELL layout.
//
// Replaces the TPU kernel _spmv_kernel in src/repro/kernels/csr_spmv/kernel.py
// (reached through csr_spmv there). For every row r of the (N_pad, W) ELL
// arrays (ops.csr_to_ell builds them from CSR, pads with column 0, value 0):
//
//   y[r] = sum over w = 0 .. W-1 of vals[r][w] * x[clip(cols[r][w], 0, M-1)]
//
// accumulated in float32 and written in x's type (float32 or float64; x is
// read in its own type and rounded to float32 on the way in, as the
// reference's astype(float32) does). The gather clips like
// jnp.take(mode="clip").
//
// Sum order. The reference leaves the order of its row sum to XLA. This
// kernel fixes it: w = 0, 1, ..., W-1 into one float32 accumulator that
// starts at 0, each product and each sum rounded on its own (__fmul_rn,
// __fadd_rn keep nvcc from contracting them into an FMA). The plain version
// in ref.py adds column by column in the same order, so the two agree bit
// for bit; against the TPU kernel they agree to the reference tests'
// tolerance.
//
// Design. kLanes = 4 lanes per row, kThreads / kLanes rows per block. A row
// is cut into chunks of 4 columns; lane l takes chunks l, l + 4, l + 8, ...
// (W = 16: one chunk a lane). On the vector path each lane reads its chunk
// as one int4 of cols and one float4 of vals, so the 8 rows of a warp read
// whole 128-byte lines of both arrays, and the loads are streaming
// (__ldcs: evict first, read once) so that x keeps its place in the 50 MB
// L2 for the gathers, which go through the read-only path (__ldg). The
// lanes gather and multiply their chunks in parallel; the sum then runs
// chunk by chunk in column order down a chain of warp shuffles: the lane
// that owns chunk c takes the running sum from the owner of chunk c - 1 and
// adds its four products one by one. The scalar path, for W not a multiple
// of 4, cols or vals not 16-byte aligned (a view such as cols[1:] of a flat
// buffer), or float64 x, is the same with the chunk read word by word.
//
// Bound. Bytes: the ELL arrays are read once (N_pad * W * 8), y is written
// once (N_pad * x's width) and x is read once while it stays in L2 (M * x's
// width). The 2 * N_pad * W float32 operations are far below the card's
// rate, so memory bounds it; the gathers cost one 32-byte L2 sector each,
// which the L2's rate has to carry beside the streamed arrays.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;                // threads per block
constexpr int kLanes = 4;                    // lanes per row
constexpr int kRows = kThreads / kLanes;     // rows per block
constexpr unsigned kFull = 0xffffffffu;

template <typename X, bool kVec>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                const X* __restrict__ x, X* __restrict__ y, long long n_pad,
                int w, long long m) {
  const long long r = (long long)blockIdx.x * kRows + threadIdx.x / kLanes;
  const int sub = threadIdx.x % kLanes;
  const int lead = (threadIdx.x & 31) - sub;  // the row's lane 0 in the warp
  const bool live = r < n_pad;
  const int* rc = cols + r * w;
  const float* rv = vals + r * w;
  const int chunks = (w + 3) / 4;
  float acc = 0.0f;  // the running sum, current in the last chunk's owner
  // every lane of the warp runs every round and shuffle (W is uniform)
  for (int c0 = 0; c0 < chunks; c0 += kLanes) {
    const int c = c0 + sub;
    float p[4];
    int n = 0;  // products this lane adds
    if (live && c < chunks) {
      int ci[4];
      float vi[4];
      if (kVec) {
        const int4 cv = __ldcs(reinterpret_cast<const int4*>(rc) + c);
        const float4 vv = __ldcs(reinterpret_cast<const float4*>(rv) + c);
        ci[0] = cv.x; ci[1] = cv.y; ci[2] = cv.z; ci[3] = cv.w;
        vi[0] = vv.x; vi[1] = vv.y; vi[2] = vv.z; vi[3] = vv.w;
        n = 4;
      } else {
        n = min(4, w - 4 * c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n) {
            ci[j] = __ldcs(rc + 4 * c + j);
            vi[j] = __ldcs(rv + 4 * c + j);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < n) {
          const long long col = ci[j];
          const long long at = col < 0 ? 0 : (col >= m ? m - 1 : col);
          p[j] = __fmul_rn(vi[j], (float)__ldg(x + at));
        }
      }
    }
    const int steps = min(kLanes, chunks - c0);
    for (int o = 0; o < steps; ++o) {
      // the owner of the previous chunk (lane kLanes - 1 before round 0
      // holds 0, like every lane)
      const float run = __shfl_sync(kFull, acc, lead + (o + kLanes - 1) % kLanes);
      if (sub == o) {
        acc = run;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n) acc = __fadd_rn(acc, p[j]);
        }
      }
    }
  }
  const int last = chunks ? (chunks - 1) % kLanes : 0;
  if (live && sub == last) y[r] = (X)acc;
}

template <typename X, bool kVec>
int launch(const int* cols, const float* vals, const void* x, void* y,
           long long n_pad, int w, long long m, cudaStream_t stream) {
  const long long grid = (n_pad + kRows - 1) / kRows;
  csr_spmv_kernel<X, kVec><<<(unsigned)grid, kThreads, 0, stream>>>(
      cols, vals, static_cast<const X*>(x), static_cast<X*>(y), n_pad, w, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether a launch reads cols and vals as 16-byte vectors: float32 x
// (x_bytes 4), W a multiple of 4 and both arrays 16-byte aligned. Otherwise
// it reads them word by word, with the same sum order.
int csr_spmv_vector_loads(const int* cols, const float* vals, int w,
                          int x_bytes) {
  return x_bytes == 4 && w % 4 == 0 && (uintptr_t)cols % 16 == 0 &&
         (uintptr_t)vals % 16 == 0;
}

// y = ELL(cols, vals) @ x for N_pad rows of width W over an M-word x on
// `stream`; x and y are x_bytes (4: float32, 8: float64) wide. Reads 16-byte
// vectors where csr_spmv_vector_loads allows, words otherwise. Returns a
// cudaError_t (0 = launched), or cudaErrorInvalidValue for another width.
// The wrapper skips N_pad = 0 and asks for M >= 1.
int csr_spmv_launch(const int* cols, const float* vals, const void* x,
                    void* y, long long n_pad, int w, long long m, int x_bytes,
                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (csr_spmv_vector_loads(cols, vals, w, x_bytes)) {
    return launch<float, true>(cols, vals, x, y, n_pad, w, m, st);
  }
  if (x_bytes == 4) {
    return launch<float, false>(cols, vals, x, y, n_pad, w, m, st);
  }
  if (x_bytes == 8) {
    return launch<double, false>(cols, vals, x, y, n_pad, w, m, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* csr_spmv_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
