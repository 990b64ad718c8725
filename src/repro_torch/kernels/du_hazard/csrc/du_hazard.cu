// K2: DU hazard frontier merge, K independent (src, dst) stream pairs.
//
// Replaces the TPU kernel _hazard_kernel in
// src/repro/kernels/du_hazard/kernel.py (reached through
// hazard_frontier_batch and hazard_frontier there). For
// every row k and consumer lane j:
//
//   out[k][j] = |{ i < S : src[k][i] <= dst[k][j] }|    (side "right")
//   out[k][j] = |{ i < S : src[k][i] <  dst[k][j] }|    (side "left")
//
// This is a count, defined for any src row. For a non-decreasing row (the
// paper's §3.1 requirement) it equals searchsorted(src, dst, side), the
// minimal safe producer frontier of each consumer request, and the kernel
// finds it by binary search; any other row is counted word by word. Bounds
// come from S: there are no pads, so dst = INT32_MAX counts S under side
// "right" (the TPU kernel padded src with INT32_MAX, which a dst of
// INT32_MAX counted too).
//
// Design: one cooperative launch of a persistent grid (at most the
// co-resident limit), in two phases split by one grid barrier, so a call
// costs the host one launch and the card no sync with the host.
//
// 1. Check: the grid walks the K x ceil(S/kChunk) chunks of the rows. A
//    block looks for a descent (src[i] > src[i+1], the pair across the
//    chunk's end included) in its chunk, four words a thread with all
//    loads issued together, and writes one flag word for the chunk, so no
//    flag needs zeroing first. The threads also copy every stride-th word
//    into the row's samples, stride the least power of two with
//    stride * kMaxSamples >= S: the top levels of the row's search tree, at
//    most 16 KB a row.
// 2. Search: the grid walks the K x ceil(D/kLanes) tiles of kLanes dst,
//    kItems a thread. For each new row a block loads, all at once, the
//    tile's dst, the row's chunk flags and its samples; the OR of the flags
//    is the same for the whole block, so the choice of path is per row, on
//    the device:
//    - sorted row: the samples go to shared memory, each at a swizzled
//      index (swz): a binary search over a power-of-two array probes
//      indices that share their low bits, which would put every lane of a
//      warp on one bank. Each lane binary-lifts through the samples
//      (log2(min(S, kMaxSamples)) shared probes), which leaves a window of
//      stride - 1 src words, then lifts through the window with dependent
//      global probes down to kVec words and counts those with two 16-byte
//      loads in one round (S = 65536: no probe, one round; S = 2^20: five
//      probes, one round). The lifting steps depend only on S, so a
//      thread's kItems searches run in lock step and their loads overlap.
//      A row that is not 16-byte aligned probes down to single words.
//    - unsorted row: the count of the earlier design, the row staged
//      through shared memory in tiles of kMaxSamples words (each word a
//      broadcast) and compared with all kItems dst of the thread.
//
// Bound. The function must move (S + 2D) * 4 bytes a row, about a
// microsecond at the main path's shapes, so what bounds this design is
// latency: the launch, the check, the grid barrier, and per tile one round
// for its loads, log2(min(S, kMaxSamples)) shared probes and
// log2(stride / kVec) + 1 dependent rounds to L2; the kItems interleaved
// searches per thread and the resident blocks hide what they can. At large
// S the probes' L2 sectors (32 bytes each, a few per dst) outweigh the
// bytes. The unsorted path does 2*S*D integer operations a row (a compare
// and an add per pair) and is bound by the SMs' INT32 lanes.
//
// Plain C interface (no PyTorch headers): the wrapper in kernel.py passes
// data_ptr()s, a scratch buffer and the current stream through ctypes.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kItems = 4;                  // dst lanes a thread searches
constexpr int kLanes = kThreads * kItems;  // dst lanes per tile
constexpr int kPer = 4;                    // src words a thread checks
constexpr int kChunk = kThreads * kPer;    // src words per check chunk
constexpr int kMaxSamples = 4096;          // shared words: samples or a tile

constexpr int kTileWords = kMaxSamples / kThreads;  // a thread's tile words
constexpr int kVec = 8;  // window words a search reads in one round

static_assert(kMaxSamples % 32 == 0 && kMaxSamples % (4 * kThreads) == 0,
              "sh holds whole rows of 32 words and whole tiles");

template <bool kStrict>
__device__ __forceinline__ bool below(int v, int a) {
  return kStrict ? (v < a) : (v <= a);
}

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// The smallest power of two p with p * kMaxSamples >= s (1 for s <= 0).
__host__ __device__ inline int sample_shift(int s) {
  int shift = 0;
  while ((long long)kMaxSamples << shift < s) ++shift;
  return shift;
}

// The scratch layout of a launch: K * nc chunk flags, then per row
// ns_pad >= ns samples, the samples 16-byte aligned. Its size reaches the
// wrapper only through hazard_frontier_scratch_words.
// The samples are src words 0, stride, 2 * stride, ... of the row, stride a
// power of two.
struct Layout {
  int shift, stride, ns, ns_pad, nc;
  long long flags_words;
  __host__ __device__ explicit Layout(int k, int s)
      : shift(sample_shift(s)),
        stride(1 << shift),
        ns((int)ceil_div(s, stride)),
        ns_pad((ns + 3) & ~3),
        nc((int)ceil_div(s > 0 ? s : 1, kChunk)),
        flags_words(((long long)k * nc + 3) & ~3LL) {}
  __host__ __device__ long long words(int k) const {
    return flags_words + (long long)k * ns_pad;
  }
};

// Phase 1 for chunk c of row k: its descent flag and its samples.
__device__ void check_chunk(const int* __restrict__ src, int* flags,
                            int* samples, const Layout& L, int s,
                            long long k, int c) {
  const int* row = src + k * s;
  const long long c0 = (long long)c * kChunk;
  int v[kPer], nxt[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {  // issue every load before any use
    const long long e = c0 + i * kThreads + threadIdx.x;
    v[i] = e < s ? __ldg(row + e) : 0;
    nxt[i] = e + 1 < s ? __ldg(row + e + 1) : 0;
  }
  int bad = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long e = c0 + i * kThreads + threadIdx.x;
    if (e + 1 < s) bad |= v[i] > nxt[i];
    if (e < s && (e & (L.stride - 1)) == 0) {
      samples[k * L.ns_pad + (e >> L.shift)] = v[i];
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) flags[k * L.nc + c] = bad;
}

// Where sample q sits in shared memory. A binary search over a power-of-two
// array probes indices that agree in their low bits (q = m * 2^j - 1), all
// in one of the 32 banks; swapping q's bank bits with bits of its row of
// 32 words spreads them (a permutation inside each row of 32, so sh needs
// no padding).
__device__ __forceinline__ int swz(int q) {
  return q ^ (((q >> 5) ^ (q >> 10)) & 31);
}

// The largest power of two <= n, or 0 for n <= 0.
__device__ __forceinline__ int top_step(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

// Counts of a sorted row by binary lifting: each step adds a power of two
// to a lane's count where the word just below the new count qualifies. The
// step sequence depends only on the row's length, not on the data, so the
// kItems searches of a thread run in lock step and their loads overlap.
template <bool kStrict>
__device__ void search_tile(const int* __restrict__ row, const int* sh,
                            const Layout& L, int s, bool vec_ok,
                            const int (&a)[kItems], int (&cnt)[kItems]) {
  // the samples at or below (side "right") / below (side "left") a
#pragma unroll
  for (int i = 0; i < kItems; ++i) cnt[i] = 0;
  for (int step = top_step(L.ns); step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int nxt = cnt[i] + step;
      const int v = sh[swz(min(nxt, L.ns) - 1)];
      if (nxt <= L.ns && below<kStrict>(v, a[i])) cnt[i] = nxt;
    }
  }
  // sample q - 1 (src word (q - 1) * stride) qualifies and sample q does
  // not, so the count lies in [(q - 1) * stride + 1, min(q * stride, S)]:
  // lift through that window in global memory, by dependent probes while
  // the steps are wider than kVec words, then (where the row is 16-byte
  // aligned) take the last kVec words in one round of 16-byte loads and
  // count them, else probe on to steps of one word
  const int vec = vec_ok && L.stride >= 4 ? min(L.stride, kVec) : 1;
  int hi[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long q = cnt[i];
    hi[i] = (int)min(q << L.shift, (long long)s);
    cnt[i] = q ? (int)(((q - 1) << L.shift) + 1) : 0;
  }
  for (int step = L.stride >> 1; step >= vec; step >>= 1) {
    int v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {  // every lane loads: the loads overlap
      v[i] = __ldg(row + max(min(cnt[i] + step, hi[i]) - 1, 0));
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int nxt = cnt[i] + step;
      if (nxt <= hi[i] && below<kStrict>(v[i], a[i])) cnt[i] = nxt;
    }
  }
  if (vec > 1) {
    // words [cnt - 1, cnt - 1 + vec) start on a multiple of vec (so each
    // 16-byte load lies wholly inside or past the row, S being a multiple
    // of 4), and the first of them qualifies: the count is cnt - 1 plus
    // those of them that do
    int4 w[kItems][kVec / 4];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int u = 0; u < kVec / 4; ++u) {
        const int at = cnt[i] - 1 + 4 * u;
        if (cnt[i] > 0 && 4 * u < vec && at < s) {
          w[i][u] = __ldg(reinterpret_cast<const int4*>(row + at));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (cnt[i] > 0) {
        int c = cnt[i] - 1;
#pragma unroll
        for (int u = 0; u < kVec / 4; ++u) {
          if (4 * u < vec && cnt[i] - 1 + 4 * u < s) {
            c += below<kStrict>(w[i][u].x, a[i]) +
                 below<kStrict>(w[i][u].y, a[i]) +
                 below<kStrict>(w[i][u].z, a[i]) +
                 below<kStrict>(w[i][u].w, a[i]);
          }
        }
        cnt[i] = c;
      }
    }
  }
}

template <bool kStrict>
__device__ void count_tile(const int* __restrict__ row, int* sh, int s,
                           const int (&a)[kItems], int (&cnt)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) cnt[i] = 0;
  for (long long base = 0; base < s; base += kMaxSamples) {
    const int n = (int)min((long long)kMaxSamples, s - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int i0 = 0; i0 < kTileWords; i0 += 4) {  // 4 loads in flight
      int w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = (i0 + i) * kThreads + threadIdx.x;
        w[i] = q < n ? row[base + q] : 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sh[(i0 + i) * kThreads + threadIdx.x] = w[i];
    }
    __syncthreads();
    const int n4 = n & ~3;
#pragma unroll 4
    for (int q = 0; q < n4; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(sh + q);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        cnt[i] += below<kStrict>(v.x, a[i]) + below<kStrict>(v.y, a[i]) +
                  below<kStrict>(v.z, a[i]) + below<kStrict>(v.w, a[i]);
      }
    }
    for (int q = n4; q < n; ++q) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) cnt[i] += below<kStrict>(sh[q], a[i]);
    }
  }
}

template <bool kStrict>
__global__ void __launch_bounds__(kThreads)
hazard_frontier_kernel(const int* __restrict__ src,
                       const int* __restrict__ dst, int* __restrict__ out,
                       int* scratch, int k_rows, int s, int d) {
  __shared__ __align__(16) int sh[kMaxSamples];
  const Layout L(k_rows, s);
  int* flags = scratch;
  int* samples = scratch + L.flags_words;

  const long long chunks = (long long)k_rows * L.nc;
  for (long long w = blockIdx.x; w < chunks; w += gridDim.x) {
    check_chunk(src, flags, samples, L, s, w / L.nc, (int)(w % L.nc));
  }
  cg::this_grid().sync();

  // 16-byte loads of a row's words need every row 16-byte aligned
  const bool vec_ok =
      reinterpret_cast<unsigned long long>(src) % 16 == 0 && s % 4 == 0;
  const long long per_row = ceil_div(d, kLanes);
  const long long tiles = (long long)k_rows * per_row;
  long long cur = -1;     // the row whose samples sit in sh
  bool unsorted = false;  // whether row cur has a descent
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long k = t / per_row;
    const long long j0 = (t % per_row) * kLanes + threadIdx.x;
    const int* row = src + k * s;
    // issue the tile's loads together: its dst lanes and, for a new row,
    // the row's flags and samples (samples exist for every row)
    int a[kItems], cnt[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = j0 + i * kThreads;
      a[i] = j < d ? __ldg(dst + k * d + j) : 0;
    }
    if (k != cur) {
      int bad = 0;
#pragma unroll 4
      for (int c = threadIdx.x; c < L.nc; c += kThreads) {
        bad |= __ldcg(flags + k * L.nc + c);  // written by other SMs: via L2
      }
      const int4* from = reinterpret_cast<const int4*>(samples +
                                                       k * L.ns_pad);
      constexpr int kVecs = kMaxSamples / 4 / kThreads;
      int4 w[kVecs];
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int q = i * kThreads + threadIdx.x;
        if (4 * q < L.ns_pad) w[i] = __ldcg(from + q);
      }
      __syncthreads();  // every thread is done with sh
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int q = 4 * (i * kThreads + threadIdx.x);
        if (q < L.ns_pad) {
          sh[swz(q)] = w[i].x;
          sh[swz(q + 1)] = w[i].y;
          sh[swz(q + 2)] = w[i].z;
          sh[swz(q + 3)] = w[i].w;
        }
      }
      unsorted = __syncthreads_or(bad);  // and publishes sh
      cur = unsorted ? -1 : k;  // the count stages the row through sh
    }
    if (unsorted) {
      count_tile<kStrict>(row, sh, s, a, cnt);
    } else {
      search_tile<kStrict>(row, sh, L, s, vec_ok, a, cnt);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = j0 + i * kThreads;
      if (j < d) out[k * d + j] = cnt[i];
    }
  }
}

}  // namespace

extern "C" {

// The co-resident limit of the kernel on the current device (blocks per SM
// times SMs): the largest grid a cooperative launch accepts. The wrapper
// asks once per device.
int hazard_frontier_max_grid(int* out) {
  int dev = 0, sms = 0, per_sm = 0, per_sm_strict = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hazard_frontier_kernel<false>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm_strict, hazard_frontier_kernel<true>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *out = (per_sm < per_sm_strict ? per_sm : per_sm_strict) * sms;
  return 0;
}

// The int32 words of scratch a launch over K rows of S src words needs:
// one descent flag per kChunk src words of each row (one for S = 0), then
// each row's samples, every stride-th src word (stride the least power of
// two that keeps them within kMaxSamples), each part padded to 4 words.
long long hazard_frontier_scratch_words(int k, int s) {
  return Layout(k, s).words(k);
}

// Frontiers for K rows of S src and D dst words (row-major, contiguous)
// into out (K x D) on `stream`; strict != 0 is side "left". `scratch` is
// 16-byte aligned and holds scratch_words int32 words, at least
// hazard_frontier_scratch_words(K, S); max_grid is hazard_frontier_max_grid's
// answer.
// One cooperative launch. Returns a cudaError_t (0 = launched). The
// wrapper skips K = 0 or D = 0.
int hazard_frontier_launch(const int* src, const int* dst, int* out,
                           int* scratch, long long scratch_words, int k,
                           int s, int d, int strict, int max_grid,
                           void* stream) {
  const Layout L(k, s);
  if (scratch_words < L.words(k) || max_grid < 1 ||
      reinterpret_cast<unsigned long long>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long work = (long long)k * (L.nc > ceil_div(d, kLanes)
                                             ? L.nc
                                             : ceil_div(d, kLanes));
  const int grid = (int)(work < max_grid ? work : max_grid);
  void* args[] = {&src, &dst, &out, &scratch, &k, &s, &d};
  const void* fn = strict ? (const void*)hazard_frontier_kernel<true>
                          : (const void*)hazard_frontier_kernel<false>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3((unsigned)grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* du_hazard_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
