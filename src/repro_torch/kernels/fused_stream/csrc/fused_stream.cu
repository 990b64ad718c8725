// K3: fused producer/consumer stream with guarded store-to-load forwarding.
//
// Replaces the TPU kernel _fused_kernel in
// src/repro/kernels/fused_stream/kernel.py (reached through fused_stream
// there). For consumer j with address a_j
// and producer frontier f_j (from K2):
//
//   the youngest producer i in f_j-1, f_j-2, ..., f_j-lookback with i >= 0,
//   src_addr[i] == a_j and src_valid[i] == 1 forwards src_val[i]  (hit);
//   otherwise the value is memory[clip(a_j, 0, M-1)]               (miss).
//
// Candidate indices clip to [0, S-1] as jnp.take(mode="clip") does in the
// reference. src_valid == nullptr means every producer landed. Monotonic
// producer addresses keep equal-address producers adjacent, which is why a
// bounded lookback is exact (ops.min_lookback gives the tight depth).
//
// Design. One thread per consumer; `lookback` is a run-time loop that stops
// at the first hit or at the first negative index. A consumer reads memory
// only on a miss. Values move as whole 4- or 8-byte words (the wrapper picks
// the width from the dtype), so f32 matches the TPU kernel bit for bit and
// f64 forwards the plan's float64 values exactly, NaN payloads included.
//
// Bound. Memory: per consumer its frontier and address (8 B), its value and
// hit out (9 B for f64), the producers its lookback window reads, and one
// 32-byte DRAM sector for the random memory gather of a miss. There is no
// arithmetic to speak of; the gathers are uncoalesced, so sectors, not
// bytes, are what the card moves.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
fused_stream_kernel(const int* __restrict__ src_addr,
                    const Word* __restrict__ src_val,
                    const int* __restrict__ src_valid,
                    const int* __restrict__ frontier,
                    const int* __restrict__ dst_addr,
                    const Word* __restrict__ memory, Word* __restrict__ out,
                    unsigned char* __restrict__ hits, int s, int d,
                    long long m, int lookback) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  const long long f = frontier[j];
  const int a = dst_addr[j];
  bool found = false;
  Word val = 0;
  if (s > 0) {
    for (int lb = 0; lb < lookback; ++lb) {
      const long long idx = f - 1 - lb;
      if (idx < 0) break;  // deeper candidates are more negative still
      const long long c = idx >= s ? (long long)s - 1 : idx;
      if (src_addr[c] == a && (src_valid == nullptr || src_valid[c] == 1)) {
        val = src_val[c];
        found = true;
        break;
      }
    }
  }
  if (!found) {
    const long long at = a < 0 ? 0 : (a >= m ? m - 1 : (long long)a);
    val = memory[at];
  }
  out[j] = val;
  hits[j] = found ? 1 : 0;
}

template <typename Word>
int launch(const int* src_addr, const void* src_val, const int* src_valid,
           const int* frontier, const int* dst_addr, const void* memory,
           void* out, unsigned char* hits, int s, int d, long long m,
           int lookback, cudaStream_t stream) {
  const unsigned grid = (unsigned)((d + kThreads - 1) / kThreads);
  fused_stream_kernel<Word><<<grid, kThreads, 0, stream>>>(
      src_addr, static_cast<const Word*>(src_val), src_valid, frontier,
      dst_addr, static_cast<const Word*>(memory), static_cast<Word*>(out),
      hits, s, d, m, lookback);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forwards D consumers against S producers over an M-word memory on
// `stream`; values are word_bytes (4 or 8) wide. src_valid may be null.
// Returns a cudaError_t (0 = launched), or cudaErrorInvalidValue for
// another word width. The wrapper skips D = 0.
int fused_stream_launch(const int* src_addr, const void* src_val,
                        const int* src_valid, const int* frontier,
                        const int* dst_addr, const void* memory, void* out,
                        unsigned char* hits, int s, int d, long long m,
                        int lookback, int word_bytes, void* stream) {
  if (word_bytes == 4) {
    return launch<unsigned int>(src_addr, src_val, src_valid, frontier,
                                dst_addr, memory, out, hits, s, d, m,
                                lookback, (cudaStream_t)stream);
  }
  if (word_bytes == 8) {
    return launch<unsigned long long>(src_addr, src_val, src_valid, frontier,
                                      dst_addr, memory, out, hits, s, d, m,
                                      lookback, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fused_stream_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
