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
// Design. One thread per row, kRows rows per block. The block stages its
// (kRows x kTileW) tile of cols and vals through shared memory with
// coalesced loads (consecutive threads read consecutive words of the
// row-major tile), then each thread walks its own row of the tile in column
// order. Rows of the tile are padded by one word so that a warp reading
// column c of 32 rows hits 32 banks. x is gathered through the read-only
// path (__ldg); at the main path's sizes it stays in the 50 MB L2.
//
// Bound. Bytes: the ELL arrays are read once (N_pad * W * 8), y is written
// once (N_pad * x's width) and x is read once while it stays in L2 (M * x's
// width). The 2 * N_pad * W float32 operations are far below the card's
// rate, so memory bounds it.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // rows per block, one thread each
constexpr int kTileW = 16;   // ELL columns staged per pass

template <typename X>
__global__ void __launch_bounds__(kRows)
csr_spmv_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                const X* __restrict__ x, X* __restrict__ y, long long n_pad,
                int w, long long m) {
  __shared__ int s_cols[kRows][kTileW + 1];
  __shared__ float s_vals[kRows][kTileW + 1];
  const long long row0 = (long long)blockIdx.x * kRows;
  const int t = threadIdx.x;
  const long long left = n_pad - row0;
  const int rows = left < kRows ? (int)left : kRows;
  float acc = 0.0f;
  for (int w0 = 0; w0 < w; w0 += kTileW) {
    const int tw = w - w0 < kTileW ? w - w0 : kTileW;
    for (int e = t; e < rows * tw; e += kRows) {
      const int r = e / tw;
      const int c = e - r * tw;
      const long long g = (row0 + r) * (long long)w + w0 + c;
      s_cols[r][c] = cols[g];
      s_vals[r][c] = vals[g];
    }
    __syncthreads();
    if (t < rows) {
      for (int c = 0; c < tw; ++c) {
        const long long col = s_cols[t][c];
        const long long at = col < 0 ? 0 : (col >= m ? m - 1 : col);
        const float xv = (float)__ldg(&x[at]);
        acc = __fadd_rn(acc, __fmul_rn(s_vals[t][c], xv));
      }
    }
    __syncthreads();
  }
  if (t < rows) y[row0 + t] = (X)acc;
}

template <typename X>
int launch(const int* cols, const float* vals, const void* x, void* y,
           long long n_pad, int w, long long m, cudaStream_t stream) {
  const long long grid = (n_pad + kRows - 1) / kRows;
  csr_spmv_kernel<X><<<(unsigned)grid, kRows, 0, stream>>>(
      cols, vals, static_cast<const X*>(x), static_cast<X*>(y), n_pad, w, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = ELL(cols, vals) @ x for N_pad rows of width W over an M-word x on
// `stream`; x and y are x_bytes (4: float32, 8: float64) wide. Returns a
// cudaError_t (0 = launched), or cudaErrorInvalidValue for another width.
// The wrapper skips N_pad = 0 and asks for M >= 1.
int csr_spmv_launch(const int* cols, const float* vals, const void* x,
                    void* y, long long n_pad, int w, long long m, int x_bytes,
                    void* stream) {
  if (x_bytes == 4) {
    return launch<float>(cols, vals, x, y, n_pad, w, m, (cudaStream_t)stream);
  }
  if (x_bytes == 8) {
    return launch<double>(cols, vals, x, y, n_pad, w, m, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* csr_spmv_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
