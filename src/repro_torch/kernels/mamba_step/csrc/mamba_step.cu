// K10: one Mamba-1 decode step (S = 1) of a layer, written by hand for sm_90a.
//
// Replaces no TPU kernel: the reference runs the recurrent step in plain JAX
// (src/repro/models/ssm.py, _mamba1_step and the conv, skip and gate of
// mamba_apply). It was added because the same step in plain torch writes about
// fifteen state-sized temporaries a layer (the decay's product and exp, dt*B,
// *x, a*h, + bx, the einsum's read, the copy back into the cache), where the
// step needs the state read once and written once. For every batch row b and
// channel d, from the layer's input projection xz = [x | z] (B, 2 di):
//
//   xi[d]    = silu(sum_k w[k][d] * win[k][d] + bias[d]), win = [window, x]
//   window  <- win[1:]                                   (in place)
//   B, C     = xi @ w_bc (n columns each); dt[d] = softplus(xi @ w_dt + dt_bias[d])
//   h[d][j] <- exp(-exp(a_log[d][j]) * dt[d]) * h[d][j] + (dt[d] * B[j]) * xi[d]
//                                                        (in place)
//   y[d]     = (sum_j h[d][j] * C[j] + d_skip[d] * xi[d]) * silu(z[d])
//
// all in float32, with accurate expf and log1pf (softplus as torch's, linear
// above 20), no approximate exponent and no TF32.
//
// Design. B, C and the step's projection reduce over all di channels of a
// row, and the state pass needs them for every channel, so the step is two
// launches:
//
// 1. conv_proj_kernel: a block owns 16 rows x 256 channels, one thread a
//    channel. It runs the conv (the window's loads batched 8 rows at a time,
//    since the in-place stores would otherwise order them), shifts the window
//    in place, writes xi to a scratch row, and multiplies its xi tile
//    (256 x 16, in shared memory) by its rows of w_bc (256 x 32): each warp
//    takes 32 channels, each lane a 4 x 4 tile of (rows, columns), two
//    16-byte shared loads for 16 FMAs. The warps' sums meet in shared memory
//    and each block writes its partial sums, (16 rows x 33 columns: B, C,
//    then the step's projection at column 32) for its chunk of channels.
// 2. state_kernel: a block owns 8 rows x 256 channels. It first sums the
//    chunks' partials for its rows in chunk order (deterministic), then takes
//    64 channels at a time, four lanes a channel: a lane holds four of the
//    channel's 16 states, read and written as one 16-byte access, so each
//    load instruction of a warp reads 512 contiguous bytes; y's sum over the
//    states closes with two shuffles. -exp(a_log) is computed once a block
//    for its channels and reused over its 8 rows. The 8 rows' states are
//    loaded before any is updated, so 8 loads a lane are in flight.
//
// n <= 16 (four lanes of four states); states go through 16-byte accesses
// where n == 16 and the state is 16-byte aligned, else one word at a time.
// The conv's width K <= 4. di and B are run-time sizes; a ragged last chunk
// of channels or rows is masked.
//
// Bound. At falcon-mamba-7b's widths (B = 512, di = 8192, n = 16, K = 4) a
// layer reads and writes the state (268 MB each way) and the window (50 MB),
// reads xz (34 MB) and writes y (17 MB): 0.22 ms at 3.35 TB/s, with the
// scratch xi (17 MB out and in) and the partials (L2-resident, 2 MB) on top.
// The 67 M exponentials of the decay take 0.02 ms at 16 special-function
// results per SM per clock, and the 134 M FMAs of the projections 0.004 ms
// at the float32 peak: the bytes bound it.
//
// Plain C interface (no PyTorch headers): the wrapper in ../kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;              // states a channel at most
constexpr int kMaxK = 4;               // conv width at most
constexpr int kCols = 2 * kMaxN + 1;   // partial columns: B, C, the step's
constexpr int kDtCol = 2 * kMaxN;      // column of the step's projection
constexpr int kConvThreads = 256;      // channels a conv block, one a thread
constexpr int kConvRows = 16;          // rows a conv block
constexpr int kLoadRows = 8;           // rows whose loads go out together
constexpr int kConvWarps = kConvThreads / 32;
constexpr int kStateThreads = 256;     // four lanes a channel
constexpr int kStatePass = kStateThreads / 4;  // channels a pass
constexpr int kStatePasses = 4;
constexpr int kStateChannels = kStatePass * kStatePasses;
constexpr int kStateRows = 8;          // rows a state block

__device__ __forceinline__ float silu_f(float v) {
  return v / (1.0f + expf(-v));
}

__device__ __forceinline__ float softplus_f(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// Grid (chunks of kConvThreads channels, groups of kConvRows rows). Writes
// xi (B, di), the shifted window in place, and part (chunks, B, kCols).
__global__ void __launch_bounds__(kConvThreads) conv_proj_kernel(
    const float* __restrict__ xz, long long ld_xz, float* __restrict__ conv,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const float* __restrict__ w_bc, const float* __restrict__ w_dt,
    float* __restrict__ xi, float* __restrict__ part, int b, int di, int n,
    int k) {
  // xs: each channel's 16 rows of xi as four float4, the float4 of rows
  // 4q..4q+3 stored at q ^ ((channel >> 1) & 3) so that eight lanes' stores
  // fall in eight bank groups; ws: the chunk's rows of w_bc, zero past 2n
  // and past di, later the warps' sums
  __shared__ __align__(16) float4 xs[kConvThreads * kConvRows / 4];
  __shared__ __align__(16) float4 ws[kConvThreads * 32 / 4];
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int c0 = blockIdx.x * kConvThreads, r0 = blockIdx.y * kConvRows;
  const int c = c0 + t;
  const bool live = c < di;
  const int nbc = 2 * n;

  float* wsf = reinterpret_cast<float*>(ws);
  for (int i = t; i < kConvThreads * 32; i += kConvThreads) {
    const int cc = i >> 5, o = i & 31;
    wsf[i] = (c0 + cc < di && o < nbc) ? w_bc[(size_t)(c0 + cc) * nbc + o]
                                       : 0.0f;
  }

  // the taps on the window's k-1 words, then the one on x
  float wk[kMaxK - 1];
#pragma unroll
  for (int i = 0; i < kMaxK - 1; ++i)
    wk[i] = live && i < k - 1 ? conv_w[(size_t)i * di + c] : 0.0f;
  const float wx = live ? conv_w[(size_t)(k - 1) * di + c] : 0.0f;
  const float bias = live ? conv_b[c] : 0.0f;
  const float wdt = live ? w_dt[c] : 0.0f;

  float xv[kConvRows];
#pragma unroll
  for (int g = 0; g < kConvRows; g += kLoadRows) {
    float win[kLoadRows][kMaxK];
#pragma unroll
    for (int r = 0; r < kLoadRows; ++r) {
      const int row = r0 + g + r;
      const bool on = live && row < b;
      const float* wrow = conv + (size_t)row * (k - 1) * di + c;
#pragma unroll
      for (int i = 0; i < kMaxK - 1; ++i)
        win[r][i] = on && i < k - 1 ? wrow[(size_t)i * di] : 0.0f;
      win[r][kMaxK - 1] = on ? xz[(size_t)row * ld_xz + c] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kLoadRows; ++r) {
      const int row = r0 + g + r;
      if (!(live && row < b)) {
        xv[g + r] = 0.0f;
        continue;
      }
      // the window's k-1 words, then x: sum_i w[i] * win[i] in order
      const float x = win[r][kMaxK - 1];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxK - 1; ++i)
        if (i < k - 1) acc += wk[i] * win[r][i];
      acc += wx * x;
      const float v = silu_f(acc + bias);
      xv[g + r] = v;
      float* wrow = conv + (size_t)row * (k - 1) * di + c;
#pragma unroll
      for (int i = 0; i < kMaxK - 1; ++i)
        if (i < k - 1) wrow[(size_t)i * di] = i + 1 < k - 1 ? win[r][i + 1] : x;
      xi[(size_t)row * di + c] = v;
    }
  }
  const int swz = (t >> 1) & 3;
#pragma unroll
  for (int q = 0; q < kConvRows / 4; ++q)
    xs[t * 4 + (q ^ swz)] =
        make_float4(xv[4 * q], xv[4 * q + 1], xv[4 * q + 2], xv[4 * q + 3]);

  // the step's projection of each row, summed over the warp's 32 channels
  float dts[kConvRows];
#pragma unroll
  for (int r = 0; r < kConvRows; ++r) {
    float s = xv[r] * wdt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    dts[r] = s;
  }
  __syncthreads();

  // B and C: a lane's tile is rows 4 rt .. 4 rt + 3, columns 4 ot .. 4 ot + 3
  const int rt = lane >> 3, ot = lane & 7;
  float acc[4][4] = {};
#pragma unroll 8
  for (int cc = warp * 32; cc < warp * 32 + 32; ++cc) {
    const float4 xq = xs[cc * 4 + (rt ^ ((cc >> 1) & 3))];
    const float4 wq = ws[cc * 8 + ot];
    const float xr[4] = {xq.x, xq.y, xq.z, xq.w};
    const float wr[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += xr[i] * wr[j];
  }
  __syncthreads();  // ws is read by every warp; now it takes the sums

  float* red = wsf;  // [warp][row][32], then [warp][row] of the step's
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(red)[(warp * kConvRows + 4 * rt + i) * 8 + ot] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  float* red_dt = red + kConvWarps * kConvRows * 32;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kConvRows; ++r) red_dt[warp * kConvRows + r] = dts[r];
  }
  __syncthreads();

  float* out = part + ((size_t)blockIdx.x * b + r0) * kCols;
  for (int i = t; i < kConvRows * 32; i += kConvThreads) {
    const int r = i >> 5, o = i & 31;
    if (r0 + r >= b) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kConvWarps; ++w) s += red[w * kConvRows * 32 + i];
    out[(size_t)r * kCols + o] = s;
  }
  if (t < kConvRows && r0 + t < b) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kConvWarps; ++w) s += red_dt[w * kConvRows + t];
    out[(size_t)t * kCols + kDtCol] = s;
  }
}

// Grid (chunks of kStateChannels channels, groups of kStateRows rows).
// Updates h (B, di, n) in place and writes y (B, di).
template <bool kVec>
__global__ void __launch_bounds__(kStateThreads) state_kernel(
    const float* __restrict__ xz, long long ld_xz,
    const float* __restrict__ xi, const float* __restrict__ part, int chunks,
    float* __restrict__ h, const float* __restrict__ dt_bias,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    float* __restrict__ y, int b, int di, int n) {
  __shared__ float bcs[kStateRows][kCols];
  const int t = threadIdx.x;
  const int r0 = blockIdx.y * kStateRows;
  for (int i = t; i < kStateRows * kCols; i += kStateThreads) {
    const int r = i / kCols, o = i % kCols;
    float s = 0.0f;
    if (r0 + r < b)
      for (int q = 0; q < chunks; ++q)
        s += part[((size_t)q * b + r0 + r) * kCols + o];
    bcs[r][o] = s;
  }
  __syncthreads();

  const int lane = t & 3;  // states 4 lane .. 4 lane + 3 of the channel
  for (int p = 0; p < kStatePasses; ++p) {
    const int c = blockIdx.x * kStateChannels + p * kStatePass + (t >> 2);
    const bool live = c < di;  // the shuffles below need every lane
    float a_neg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * lane + i;
      a_neg[i] = live && j < n ? -expf(a_log[(size_t)c * n + j]) : 0.0f;
    }
    const float dtb = live ? dt_bias[c] : 0.0f;
    const float skip = live ? d_skip[c] : 0.0f;

    float hv[kStateRows][4], xv[kStateRows], zv[kStateRows];
#pragma unroll
    for (int r = 0; r < kStateRows; ++r) {
      const int row = r0 + r;
      const bool on = live && row < b;
      const size_t base = ((size_t)row * di + c) * n + 4 * lane;
      if (kVec) {
        const float4 v = on ? *reinterpret_cast<const float4*>(h + base)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        hv[r][0] = v.x, hv[r][1] = v.y, hv[r][2] = v.z, hv[r][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          hv[r][i] = on && 4 * lane + i < n ? h[base + i] : 0.0f;
      }
      xv[r] = on ? xi[(size_t)row * di + c] : 0.0f;
      zv[r] = on ? xz[(size_t)row * ld_xz + di + c] : 0.0f;
    }

#pragma unroll
    for (int r = 0; r < kStateRows; ++r) {
      const int row = r0 + r;
      const bool on = live && row < b;
      const float dt = softplus_f(bcs[r][kDtCol] + dtb);
      const float x = xv[r];
      float yp = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * lane + i;
        if (j < n) {
          const float a = expf(a_neg[i] * dt);
          const float hn = a * hv[r][i] + (dt * bcs[r][j]) * x;
          hv[r][i] = hn;
          yp += hn * bcs[r][n + j];
        }
      }
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (!on) continue;
      const size_t base = ((size_t)row * di + c) * n + 4 * lane;
      if (kVec) {
        *reinterpret_cast<float4*>(h + base) =
            make_float4(hv[r][0], hv[r][1], hv[r][2], hv[r][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * lane + i < n) h[base + i] = hv[r][i];
      }
      if (lane == 0)
        y[(size_t)row * di + c] = (yp + skip * x) * silu_f(zv[r]);
    }
  }
}

}  // namespace

extern "C" {

// One step of a layer on `stream`, every tensor float32 and contiguous but
// xz, whose rows are ld_xz words apart (x its first di words, z the next
// di): conv (B, k-1, di) and h (B, di, n) updated in place; conv_w (k, di),
// conv_b, w_dt, dt_bias and d_skip (di), w_bc (di, 2n), a_log (di, n); the
// scratch xi (B, di) and part (ceil(di / 256), B, 33); y (B, di)
// written. The wrapper asks for B, di >= 1, 1 <= n <= 16, 2 <= k <= 4 and
// B <= 65535 * 8. Returns a cudaError_t (0 = both launched), or
// cudaErrorInvalidValue for sizes outside those.
int mamba_step_launch(const float* xz, long long ld_xz, float* conv,
                      float* h, const float* conv_w, const float* conv_b,
                      const float* w_bc, const float* w_dt,
                      const float* dt_bias, const float* a_log,
                      const float* d_skip, float* xi, float* part, float* y,
                      int b, int di, int n, int k, void* stream) {
  if (n < 1 || n > kMaxN || k < 2 || k > kMaxK || b < 1 || di < 1 ||
      b > 65535 * kStateRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (di + kConvThreads - 1) / kConvThreads;
  const dim3 g1(chunks, (b + kConvRows - 1) / kConvRows);
  conv_proj_kernel<<<g1, kConvThreads, 0, st>>>(
      xz, ld_xz, conv, conv_w, conv_b, w_bc, w_dt, xi, part, b, di, n, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2((di + kStateChannels - 1) / kStateChannels,
                (b + kStateRows - 1) / kStateRows);
  if (n == kMaxN && (uintptr_t)h % 16 == 0)
    state_kernel<true><<<g2, kStateThreads, 0, st>>>(
        xz, ld_xz, xi, part, chunks, h, dt_bias, a_log, d_skip, y, b, di, n);
  else
    state_kernel<false><<<g2, kStateThreads, 0, st>>>(
        xz, ld_xz, xi, part, chunks, h, dt_bias, a_log, d_skip, y, b, di, n);
  return (int)cudaGetLastError();
}

const char* mamba_step_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
