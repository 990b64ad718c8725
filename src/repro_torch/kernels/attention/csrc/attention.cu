// K6 (flash attention, the prefill) and K7 (decode attention against a KV
// cache), written by hand for sm_90a.
//
// K6 replaces the TPU kernel _flash_kernel (src/repro/kernels/attention/
// kernel.py:27, reached through flash_attention :73), the twin of the
// model's blocked loop flash_mha (src/repro/models/flash.py):
//
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / rep]
//   s[i, j]    = sm_scale * q[b, i, h] . k[b, j, h / rep]   (-1e30 where
//                causal and j > i, and where window > 0 and j <= i - window)
//
// The sliding window (gemma3's local layers) is the mask of the reference's
// model-level loop (flash._mask, src/repro/models/flash.py:56); the Pallas
// kernel has none.
//
// K7 replaces _decode_kernel (same file :108, reached through
// decode_attention :140): one query per (b, h) against a KV cache of
// capacity C, masked at the committed frontier, s[j] = -1e30 for
// j >= lengths[b] (the RAW pair append / attend of DESIGN.md section 3.2).
//
// Layout. Both kernels take the model's layout, q (B, S, H, D) and k, v
// (B, S_kv, Hk, D), contiguous, with query head h reading kv head
// h / (H / Hk) by index (GQA; K and V are never copied per query head). The
// reference's (BH, S, d) layout is the case H = Hk = 1. K6's V may have a
// head dim Dv of its own, and its output is (B, S, H, Dv): minicpm3's MLA
// prefill attends with q, k of 96 (64 + 32 rotary) and v of 64, as the
// reference's flash_mha allows (the Pallas kernel's block shapes take one d). Sizes are run-time
// arguments: a ragged last tile is masked, where the Pallas kernels assert
// that S and S_kv divide by their blocks. Inputs are float32, float16 or
// bfloat16; every sum is in float32 and the output is in the input's type.
//
// Numerics, as the reference's: q is scaled by sm_scale on load; the running
// max starts at NEG_INF = -1e30, masked scores are -1e30, the softmax is
// online in float32 (m, l, alpha = exp(m_old - m_new)), and the output is
// acc / max(l, 1e-30). Keys past S_kv in a ragged tile get no weight at all.
// Where the caller asks (training: the reference's custom VJP keeps it as a
// residual, src/repro/models/flash.py:114), K6 also writes each row's
// log-sum-exp m + log(max(l, 1e-30)), float32, in (B, H, S) order; the
// output's arithmetic is the same with or without it.
//
// K6 design: both products on the tensor cores in 3xTF32
// (mma.sync.m16n8k8.tf32). One block per (b * H + h, tile of query rows),
// 16 rows a warp (the mma's m16): 8 warps (128 rows) over 32-key tiles up
// to D = 128 where those blocks fill the card's SMs twice; 4 warps (64
// rows) over 16-key tiles where they do not (the serve path's prefill,
// B=4, S=128: 160 blocks of 128 rows would run in two waves on 132 SMs,
// the second a fifth full), and above D = 128 (shared memory). The
// heaviest causal tiles are dispatched first. Each operand
// x is split once into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna) and a
// product is lo*hi + hi*hi + hi*lo, summed in float32: one TF32 pass
// keeps ~3 digits and misses the reference's 1e-4 at D=128 (9.3e-4 in the
// CPU emulation of tests/test_torch_attention_tf32.py); three hold it
// (6.5e-7). The
// scaled q tile is split when the block starts; K and V tiles are copied
// by cp.async (16 bytes a copy, for aligned
// float32 rows; converted loads otherwise) while the warps compute on the
// tile before, then split by all threads at once. The split words sit in
// shared memory in the order of the mma fragments, so a lane reads each
// fragment's hi and lo words in one 16-byte load. The scores stay in the
// accumulator fragments: the online softmax runs there (row max and sum
// across the quad of lanes sharing a row), and P enters P.V as the A
// operand with its k index permuted (the fragment's keys 2t, 2t+1 as
// k = t, t+4), matched by the order of the V words, so no shuffle
// re-lays it out. The three products of a term go one pass over the
// n-tiles at a time, so no mma waits on the one before it. Causal tiles
// stop at the diagonal and a warp skips the tiles wholly above its rows.
// With a window, a block starts at the first tile that holds a key inside its
// first row's window, and a warp skips the tiles wholly left of its own first
// row's (where every row keeps a key: S < S_kv + window). A row whose first
// tile lies wholly left of its window gets weights of 1 there (finite -1e30
// minus itself); its first key inside the window sets alpha = exp(-1e30 - m)
// = 0 on them, as in the reference's blocked loop.
//
// K6 bound. Operations: 2 * B * H * S * S_kv * (D + Dv) flops (Q.K and
// P.V), half of it when causal: at B=1, H=40, S=4096, D=128 causal, 171.8 GFLOP.
// At the accuracy kept (3xTF32) that is 3 * 171.8 GFLOP at the TF32 tensor
// cores' 495 TFLOP/s, 1.04 ms; in float32 on the CUDA cores (67 TFLOP/s)
// it was 2.57 ms. With a window only the keys inside it count: at gemma3's
// heads (8 over 4, D=256), S=4096 and window 1024, sum_i min(i + 1, 1024)
// key rows per query row. mma.sync does not reach the data sheet's rate (that
// takes wgmma): the split and the softmax run between the products, and
// the block's phases (split, then products) do not overlap.
//
// K7 design: split-KV in one launch. The grid is (B * Hk, n_split): block
// (g, s) takes cache positions [s * L, (s + 1) * L) of kv head g's rep =
// H / Hk query heads, L and n_split chosen from B * Hk, C and the card's
// SM count alone (about 4 blocks an SM, L a multiple of 32 in [32, 256]
// unless C needs more than 1024 splits; the wrapper passes the count), so
// the longest frontier no longer sets the time. A block
// stops at the frontier min(lengths[b], C); one wholly past it writes
// nothing. Tiles of 32 keys stream through a cp.async double buffer
// (16-byte copies where rows are aligned, 4-byte or element loads
// otherwise). Each key's dot products are split over 4 lanes (the rep
// queries read from shared memory, each K row once); a warp runs the
// online softmax of a query row; each thread then accumulates 4 output
// columns of a query row over the tile. Each block writes its partial
// (m, l, acc) to scratch, takes a ticket after a __threadfence, and the
// last block of each kv head merges the partials in split order (the same
// bits from run to run) and re-arms the ticket to 0 for the next call.
// lengths[b] <= 0 keeps the reference's result: every split covers its
// whole range at -1e30, so the merge's alpha = exp(m_i - m) = 1 gives the
// uniform average of the whole cache (not zeros). Past the frontier the
// Pallas kernel walks all of C and masks; once one entry is committed each
// masked one adds exp(-1e30 - m) = 0, so stopping there gives the same.
//
// K7 bound. Bytes: the committed K and V rows, once each, plus q and the
// output: 0.267 ms at B=32, H=40, Hk=8, C=8192, D=128 (108895 rows). The
// splits put every SM to work on those bytes whatever the frontiers are.
// At the serve path's shape (B=4, 160 rows) the bytes take 1.6 us, and a
// call is bound by its latency: the launch, one tile, the ticket and the
// merge's reads of the partials.
//
// Plain C interface (no PyTorch headers): the wrappers in ../kernel.py pass
// data_ptr()s, scratch and the current stream through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// K6
constexpr int kSmallBK = 16;  // keys a tile of the 4-warp tile up to D = 128

// K7
constexpr int kDThreads = 128;
constexpr int kDT = 32;          // keys per tile
constexpr int kRB = 8;           // query rows a score pass holds
constexpr int kBlocksPerSM = 4;  // blocks the splits aim at, per SM
constexpr int kMaxSplitLen = 256;
constexpr int kMaxSplits = 1024;

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

// four consecutive elements (8- or 16-byte aligned) as float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
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

// ---------------------------------------------------------------- K6 ----

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K6's tile: WARPS warps of 16 query rows each over tiles of KEYS keys
// (the launcher's choice, launch_flash_tile)
template <int WARPS, int KEYS>
struct FlashTile {
  static constexpr int kWarps = WARPS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kBK = KEYS;
};

// shared words: q, K (head dim d) and V (head dim dv) split into hi/lo TF32
// words in the order of the mma fragments (2 words an element), and the
// staged K and V rows; at dv = d, dp (2 BQ + 6 BK) words
template <int WARPS, int KEYS>
size_t flash_smem_t(int d, int dv) {
  using F = FlashTile<WARPS, KEYS>;
  const size_t dp = (d + 7) / 8 * 8, dvp = (dv + 7) / 8 * 8;
  return sizeof(float) * (2 * F::kBQ * dp + 3 * F::kBK * (dp + dvp));
}

template <typename T, int DMAX, int WARPS, int KEYS>
__global__ void __launch_bounds__(FlashTile<WARPS, KEYS>::kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int S_kv, int H, int Hk,
                 int d, int dv, int causal, int window, float sm_scale,
                 int vec) {
  using F = FlashTile<WARPS, KEYS>;
  constexpr int BQ = F::kBQ, BK = F::kBK, NTH = F::kThreads;
  constexpr int NT = DMAX / 8;  // n-tiles of the output, k-steps of Q.K
  constexpr int NK = BK / 8;    // n-tiles of the scores, k-steps of P.V
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 7) & ~7;  // dims Q.K runs over (zero-padded)
  const int nks = dp >> 3;      // its 8-dim groups
  const int dvp = (dv + 7) & ~7;  // dims P.V and the output run over
  const int nvs = dvp >> 3;       // the output's n-tiles
  // fragment-ordered words: q [warp][group][lane][a0..a3 hi, a0..a3 lo],
  // K [key n-tile][group][lane][b0 hi, b1 hi, b0 lo, b1 lo], V [key k-step]
  // [dim n-tile][lane][same]; a lane's words are one 16-byte load each
  unsigned* sQf = reinterpret_cast<unsigned*>(smem);  // 2 BQ x dp
  unsigned* sKf = sQf + 2 * BQ * dp;                   // 2 BK x dp
  unsigned* sVf = sKf + 2 * BK * dp;                   // 2 BK x dvp
  float* sStage = reinterpret_cast<float*>(sVf + 2 * BK * dvp);  // K rows
  float* sStageV = sStage + BK * dp;                              // V rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first
  const long long q_pos = (long long)H * d, k_pos = (long long)Hk * d;
  const long long v_pos = (long long)Hk * dv, o_pos = (long long)H * dv;
  const T* qb = q + ((long long)b * S * H + h) * d;
  const T* kb = k + ((long long)b * S_kv * Hk + hk) * d;
  const T* vb = v + ((long long)b * S_kv * Hk + hk) * dv;
  T* ob = o + ((long long)b * S * H + h) * dv;

  // q, scaled, split once: (hi, lo) = (tf32(x), tf32(x - hi))
  for (int e = tid; e < BQ * dp; e += NTH) {
    const int r = e / dp, c = e - r * dp, i = q0 + r;
    unsigned hi, lo;
    split_tf32(i < S && c < d ? to_f(qb[i * q_pos + c]) * sm_scale : 0.f, hi,
               lo);
    const int rr = r & 15, cc = c & 7;
    const int a = (rr >> 3) + 2 * (cc >> 2);  // a0 (g, t), a1 (g + 8, t), ...
    unsigned* w = sQf + (((r >> 4) * nks + (c >> 3)) * 32 + (rr & 7) * 4 +
                         (cc & 3)) * 8;
    w[a] = hi;
    w[4 + a] = lo;
  }
  // each thread's walks, stepping NTH: over the staged 16-byte chunks (d / 4
  // a K row, dv / 4 a V row); over (key, 8-dim group) for K's split and (key
  // pair, 4-dim chunk) for V's, key or pair fastest
  const int n4 = d >> 2, n4v = dv >> 2;
  const int s_r0 = vec ? tid / n4 : 0, s_c0 = vec ? tid - s_r0 * n4 : 0;
  const int s_dr = vec ? NTH / n4 : 0, s_dc = vec ? NTH - s_dr * n4 : 0;
  const int v_r0 = vec ? tid / n4v : 0, v_c0 = vec ? tid - v_r0 * n4v : 0;
  const int v_dr = vec ? NTH / n4v : 0, v_dc = vec ? NTH - v_dr * n4v : 0;
  auto stage = [&](int k0) {
    for (int r = s_r0, c = s_c0; r < BK;) {
      const int j = k0 + r;
      if (j < S_kv) cp_async16(sStage + r * dp + 4 * c, kb + j * k_pos + 4 * c);
      r += s_dr;
      c += s_dc;
      if (c >= n4) c -= n4, ++r;
    }
    for (int r = v_r0, c = v_c0; r < BK;) {
      const int j = k0 + r;
      if (j < S_kv)
        cp_async16(sStageV + r * dvp + 4 * c, vb + j * v_pos + 4 * c);
      r += v_dr;
      c += v_dc;
      if (c >= n4v) c -= n4v, ++r;
    }
  };
  // 4 dims [c0, c0 + 4) of key row r (rows >= BK: V's), zeros past S_kv
  // (a weight of 0 times stale data could be NaN) and past d (V: dv)
  auto row4 = [&](int k0, int r, int c0) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool is_k = r < BK;
    const int kr = is_k ? r : r - BK, j = k0 + kr, w = is_k ? d : dv;
    if (j >= S_kv) return x;
    if (vec) {
      if (c0 < w)
        x = *reinterpret_cast<const float4*>(is_k ? sStage + kr * dp + c0
                                                  : sStageV + kr * dvp + c0);
    } else {
      const T* src = is_k ? kb + j * k_pos : vb + j * v_pos;
      if (c0 < w) x.x = to_f(src[c0]);
      if (c0 + 1 < w) x.y = to_f(src[c0 + 1]);
      if (c0 + 2 < w) x.z = to_f(src[c0 + 2]);
      if (c0 + 3 < w) x.w = to_f(src[c0 + 3]);
    }
    return x;
  };

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int last_row = q0 + warp * 16 + 15;
  const uint4* qf = reinterpret_cast<const uint4*>(sQf) +
                    (warp * nks * 32 + lane) * 2;
  const uint4* kf = reinterpret_cast<const uint4*>(sKf) + lane;
  const uint4* vf = reinterpret_cast<const uint4*>(sVf) + lane;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  // causal: keys past the tile's last row are masked for every row
  const int n_kv = causal ? min(S_kv, q0 + BQ) : S_kv;
  const int n_tiles = (n_kv + BK - 1) / BK;
  // window: keys j <= q0 - window are masked for every row; skipped only
  // where every row keeps a key inside its window (else such a row averages
  // all S_kv keys, as in the reference)
  const int wskip = window > 0 && S < (long long)S_kv + window ? window : 0;
  const int t_lo = wskip ? max(0, q0 - wskip + 1) / BK : 0;
  const int warp_row = q0 + warp * 16;  // the warp's first row
  const int n_split = BK * max(nks, nvs);  // the split's walk
  if (vec) stage(t_lo * BK);
  cp_commit();
  for (int t = t_lo; t < n_tiles; ++t) {
    const int k0 = t * BK;
    cp_wait<0>();
    __syncthreads();  // tile t staged; the split words consumed
    for (int e = tid; e < n_split; e += NTH) {
      if (e < BK * nks) {  // K: key j, dims [8 grp, 8 grp + 8)
        const int j = e % BK, grp = e / BK;
        const float4 x0 = row4(k0, j, 8 * grp), x1 = row4(k0, j, 8 * grp + 4);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        unsigned hi[8], lo[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) split_tf32(x[i], hi[i], lo[i]);
        uint4* w = reinterpret_cast<uint4*>(
            sKf + (((j >> 3) * nks + grp) * 32 + (j & 7) * 4) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = make_uint4(hi[i], hi[i + 4], lo[i], lo[i + 4]);
      }
      if (e < BK * nvs) {  // V: keys 2p, 2p + 1, dims [4 c4, 4 c4 + 4)
        const int p = e % (BK / 2), c4 = e / (BK / 2);
        const float4 x0 = row4(k0, BK + 2 * p, 4 * c4);
        const float4 x1 = row4(k0, BK + 2 * p + 1, 4 * c4);
        const float y0[4] = {x0.x, x0.y, x0.z, x0.w};
        const float y1[4] = {x1.x, x1.y, x1.z, x1.w};
        uint4* w = reinterpret_cast<uint4*>(sVf) +
                   ((p >> 2) * nvs + (c4 >> 1)) * 32 + (c4 & 1) * 16 + (p & 3);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned h0, l0, h1, l1;
          split_tf32(y0[i], h0, l0);
          split_tf32(y1[i], h1, l1);
          w[4 * i] = make_uint4(h0, h1, l0, l1);
        }
      }
    }
    __syncthreads();  // the split words are ready; the staging rows free
    if (vec && t + 1 < n_tiles) stage(k0 + BK);
    cp_commit();
    if (causal && k0 > last_row) continue;  // every score of the warp masked
    if (wskip && k0 + BK - 1 <= warp_row - wskip) continue;  // left of it
    // S = Q K^T, 16 x BK a warp: NK n-tiles of 8 keys, the small terms in
    // their own accumulators, one pass over the n-tiles a term (no product
    // waits on the one before)
    float s[NK][4], s2[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < NT; ++ks) {
      if (ks >= nks) break;
      const uint4 qh = qf[ks * 64], ql = qf[ks * 64 + 1];
      const unsigned ah[4] = {qh.x, qh.y, qh.z, qh.w};
      const unsigned al[4] = {ql.x, ql.y, ql.z, ql.w};
      uint4 bk[NK];
#pragma unroll
      for (int n = 0; n < NK; ++n) bk[n] = kf[(n * nks + ks) * 32];
#pragma unroll
      for (int n = 0; n < NK; ++n) mma_tf32(s2[n], al, bk[n].x, bk[n].y);
#pragma unroll
      for (int n = 0; n < NK; ++n) mma_tf32(s[n], ah, bk[n].x, bk[n].y);
#pragma unroll
      for (int n = 0; n < NK; ++n) mma_tf32(s2[n], ah, bk[n].z, bk[n].w);
    }
    // masks, then the online softmax of rows row0 (e = 0, 1) and row0 + 8
    // (e = 2, 3) in the fragments
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + n * 8 + 2 * t4 + (e & 1);
        const int i = row0 + 8 * (e >> 1);
        float x = s[n][e] + s2[n][e];
        if (j >= S_kv) x = -INFINITY;
        else if ((causal && j > i) || (window > 0 && j <= i - window))
          x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(~0u, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(~0u, mx[hh], 2));
      const float m_new = fmaxf(m_r[hh], mx[hh]);
      alpha[hh] = expf(m_r[hh] - m_new);
      m_r[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_r[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: k-step kk takes keys kk*8 + 2*t4 (+1) as k = t4 (t4 + 4)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
      // the n-tiles in groups of 4, one pass a term within a group
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += 4) {
        if (n0 >= nvs) break;
        uint4 bv[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)  // zeros past the padded dims
          bv[n] = n0 + n < nvs ? vf[(kk * nvs + n0 + n) * 32]
                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], al, bv[n].x, bv[n].y);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], ah, bv[n].z, bv[n].w);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], ah, bv[n].x, bv[n].y);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_r[hh] += __shfl_xor_sync(~0u, l_r[hh], 1);
    l_r[hh] += __shfl_xor_sync(~0u, l_r[hh], 2);
    const float l_c = fmaxf(l_r[hh], 1e-30f);
    // the row's log-sum-exp of its scaled scores (natural log; the
    // backward's residual), written by the quad's first lane
    const int i = row0 + 8 * hh;
    if (lse != nullptr && t4 == 0 && i < S)
      lse[(long long)blockIdx.x * S + i] = m_r[hh] + logf(l_c);
    l_r[hh] = 1.f / l_c;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row0 + 8 * (e >> 1), c = n * 8 + 2 * t4 + (e & 1);
      if (i < S && c < dv) store_f(&ob[i * o_pos + c], acc[n][e] * l_r[e >> 1]);
    }
}

// ---------------------------------------------------------------- K7 ----

struct DecodeSplit {
  int n_split, len;
};

// the split of C positions over blocks, from B * Hk, C and the card's SM
// count alone
DecodeSplit decode_split(int groups, int C, int sms) {
  const int want = (kBlocksPerSM * max(sms, 1) + groups - 1) / groups;
  int len = min((C + want - 1) / want, kMaxSplitLen);
  len = max(len, (C + kMaxSplits - 1) / kMaxSplits);
  len = max(kDT, (len + kDT - 1) / kDT * kDT);
  return {(C + len - 1) / len, len};
}

// bytes of a K7 shared row: d elements rounded up to 16 bytes, plus 16
__host__ __device__ __forceinline__ int decode_row_bytes(int d, int size) {
  return (d * size + 15) / 16 * 16 + 16;
}

// K and V rows [k0, k0 + cnt) into sK, sV (raw, rb bytes a row): cp.async
// of cp bytes (16 or 4) a copy, or element loads where cp is 0
template <typename T>
__device__ __forceinline__ void decode_load_kv(char* sK, char* sV, const T* kb,
                                               const T* vb, long long kv_pos,
                                               int k0, int cnt, int d, int rb,
                                               int cp) {
  if (cp) {
    const int per_row = d * (int)sizeof(T) / cp;
    for (int e = threadIdx.x; e < cnt * per_row; e += kDThreads) {
      const int r = e / per_row, c = (e - r * per_row) * cp;
      const long long at = (k0 + r) * kv_pos * (long long)sizeof(T) + c;
      const char* gk = reinterpret_cast<const char*>(kb) + at;
      const char* gv = reinterpret_cast<const char*>(vb) + at;
      if (cp == 16) {
        cp_async16(sK + r * rb + c, gk);
        cp_async16(sV + r * rb + c, gv);
      } else {
        cp_async4(sK + r * rb + c, gk);
        cp_async4(sV + r * rb + c, gv);
      }
    }
  } else {
    for (int e = threadIdx.x; e < cnt * d; e += kDThreads) {
      const int r = e / d, c = e - r * d;
      const long long at = (k0 + r) * kv_pos + c;
      reinterpret_cast<T*>(sK + r * rb)[c] = kb[at];
      reinterpret_cast<T*>(sV + r * rb)[c] = vb[at];
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kDThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  T* __restrict__ o, float* __restrict__ part,
                  int* __restrict__ tickets, int C, int H, int Hk, int d,
                  int split_len, int cp, float sm_scale) {
  extern __shared__ __align__(16) char dsmem[];
  const int rep = H / Hk, rb = decode_row_bytes(d, sizeof(T));
  char* sK = dsmem;                   // 2 x kDT rows of rb bytes
  char* sV = sK + 2 * kDT * rb;       // 2 x kDT rows
  float* sQ = reinterpret_cast<float*>(sV + 2 * kDT * rb);  // rep x d
  float* sO = sQ + rep * d;           // rep x d output sums
  float* sS = sO + rep * d;           // rep x kDT: scores, then weights
  float* sM = sS + rep * kDT;
  float* sL = sM + rep;
  float* sA = sL + rep;
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = blockIdx.x, n_split = gridDim.y;
  const int b = grp / Hk, hk = grp % Hk;
  const int len = lengths[b];
  // nothing committed: every score is -1e30 and the output is the uniform
  // average of the whole cache, as in the reference
  const bool none = len <= 0;
  const int n = none ? C : min(len, C);
  const int k_begin = blockIdx.y * split_len;
  const int k_end = min(k_begin + split_len, n);
  const long long kv_pos = (long long)Hk * d;
  const T* kb = k + ((long long)b * C * Hk + hk) * d;
  const T* vb = v + ((long long)b * C * Hk + hk) * d;
  const int rd = rep * d;
  // partials: every split's rep x d output sums, then its (max, sum) pairs
  float* part_acc = part + ((long long)grp * n_split) * rd;
  float* part_ml = part + (long long)gridDim.x * n_split * rd +
                   ((long long)grp * n_split) * rep * 2;

  if (k_begin < k_end) {
    const int n_tiles = (k_end - k_begin + kDT - 1) / kDT;
    decode_load_kv(sK, sV, kb, vb, kv_pos, k_begin,
                   min(kDT, k_end - k_begin), d, rb, cp);
    cp_commit();
    const T* qb = q + ((long long)b * H + (long long)hk * rep) * d;
    for (int e = tid; e < rd; e += kDThreads) {
      sQ[e] = to_f(qb[e]) * sm_scale;
      sO[e] = 0.f;
    }
    for (int r = tid; r < rep; r += kDThreads) {
      sM[r] = kNegInf;
      sL[r] = 0.f;
    }
    const int j = tid >> 2, gl = tid & 3;  // score phase: key j, lane gl
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = k_begin + t * kDT, buf = t & 1;
      const int cnt = min(kDT, k_end - k0);
      if (t + 1 < n_tiles) {
        const int nb = (buf ^ 1) * kDT * rb;
        decode_load_kv(sK + nb, sV + nb, kb, vb, kv_pos, k0 + kDT,
                       min(kDT, k_end - k0 - kDT), d, rb, cp);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const char* bK = sK + buf * kDT * rb;
      const char* bV = sV + buf * kDT * rb;
      // scores: 4 lanes a key, kRB query rows a pass
      for (int r0 = 0; r0 < rep; r0 += kRB) {
        float s[kRB];
#pragma unroll
        for (int rr = 0; rr < kRB; ++rr) s[rr] = 0.f;
        if (j < cnt && !none) {
          const T* krow = reinterpret_cast<const T*>(bK + j * rb);
          if (VEC) {
            for (int c = 4 * gl; c < d; c += 16) {
              const float4 kv = ld4(krow + c);
#pragma unroll
              for (int rr = 0; rr < kRB; ++rr) {
                if (r0 + rr >= rep) break;
                const float4 qv =
                    *reinterpret_cast<const float4*>(sQ + (r0 + rr) * d + c);
                s[rr] = fmaf(qv.x, kv.x, s[rr]);
                s[rr] = fmaf(qv.y, kv.y, s[rr]);
                s[rr] = fmaf(qv.z, kv.z, s[rr]);
                s[rr] = fmaf(qv.w, kv.w, s[rr]);
              }
            }
          } else {
            for (int c = gl; c < d; c += 4) {
              const float kv = to_f(krow[c]);
#pragma unroll
              for (int rr = 0; rr < kRB; ++rr) {
                if (r0 + rr >= rep) break;
                s[rr] = fmaf(sQ[(r0 + rr) * d + c], kv, s[rr]);
              }
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < kRB; ++rr) {
          s[rr] += __shfl_xor_sync(~0u, s[rr], 1);
          s[rr] += __shfl_xor_sync(~0u, s[rr], 2);
        }
        if (gl == 0)
#pragma unroll
          for (int rr = 0; rr < kRB; ++rr) {
            if (r0 + rr >= rep) break;
            // past the frontier within this tile: no weight
            sS[(r0 + rr) * kDT + j] =
                j >= cnt ? -INFINITY : (none ? kNegInf : s[rr]);
          }
      }
      __syncthreads();
      // the online softmax, a warp a query row
      for (int r = warp; r < rep; r += kDThreads / 32) {
        const float x = sS[r * kDT + lane];
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float p = expf(x - m_new);
        const float sum = warp_sum(p);
        sS[r * kDT + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          sM[r] = m_new;
          sL[r] = sL[r] * alpha + sum;
          sA[r] = alpha;
        }
      }
      __syncthreads();
      // the outputs: 4 columns (VEC) or 1 of a query row a thread
      const int w = VEC ? 4 : 1, nc = d / w;
      for (int it = tid; it < rep * nc; it += kDThreads) {
        const int r = it / nc, c = (it - r * nc) * w;
        const float alpha = sA[r];
        const float* p = sS + r * kDT;
        if (VEC) {
          float4 acc = *reinterpret_cast<float4*>(sO + r * d + c);
          acc.x *= alpha;
          acc.y *= alpha;
          acc.z *= alpha;
          acc.w *= alpha;
          for (int jj = 0; jj < cnt; ++jj) {
            const float4 vv =
                ld4(reinterpret_cast<const T*>(bV + jj * rb) + c);
            const float pj = p[jj];
            acc.x = fmaf(pj, vv.x, acc.x);
            acc.y = fmaf(pj, vv.y, acc.y);
            acc.z = fmaf(pj, vv.z, acc.z);
            acc.w = fmaf(pj, vv.w, acc.w);
          }
          *reinterpret_cast<float4*>(sO + r * d + c) = acc;
        } else {
          float acc = sO[r * d + c] * alpha;
          for (int jj = 0; jj < cnt; ++jj)
            acc = fmaf(p[jj],
                       to_f(reinterpret_cast<const T*>(bV + jj * rb)[c]), acc);
          sO[r * d + c] = acc;
        }
      }
      __syncthreads();  // the buffer is consumed before it is refilled
    }
    // this split's partial
    const long long at = (long long)blockIdx.y * rep;
    for (int r = tid; r < rep; r += kDThreads) {
      part_ml[(at + r) * 2] = sM[r];
      part_ml[(at + r) * 2 + 1] = sL[r];
    }
    for (int e = tid; e < rd; e += kDThreads) part_acc[at * d + e] = sO[e];
  }
  // the last block of this kv head to finish merges
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[grp], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) tickets[grp] = 0;  // re-armed for the next call
  __threadfence();
  const int n_act = (n + split_len - 1) / split_len;  // splits not empty
  T* ob = o + ((long long)b * H + (long long)hk * rep) * d;
  // w outputs of one query row a thread (4 where d % 4 == 0), the splits
  // in split order, their loads unrolled
  constexpr int w = VEC ? 4 : 1;
  for (int e = tid * w; e < rd; e += kDThreads * w) {
    const int r = e / d;
    const float* ml = part_ml + 2 * r;
    float m = -INFINITY;
#pragma unroll 4
    for (int i = 0; i < n_act; ++i) m = fmaxf(m, __ldcg(ml + 2LL * i * rep));
    float l = 0.f, acc[w];
#pragma unroll
    for (int c = 0; c < w; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_act; ++i) {
      const float a = expf(__ldcg(ml + 2LL * i * rep) - m);
      l = fmaf(__ldcg(ml + 2LL * i * rep + 1), a, l);
      const float* pa = part_acc + (long long)i * rd + e;
      if constexpr (VEC) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(pa));
        acc[0] = fmaf(x.x, a, acc[0]);
        acc[1] = fmaf(x.y, a, acc[1]);
        acc[2] = fmaf(x.z, a, acc[2]);
        acc[3] = fmaf(x.w, a, acc[3]);
      } else {
        acc[0] = fmaf(__ldcg(pa), a, acc[0]);
      }
    }
#pragma unroll
    for (int c = 0; c < w; ++c) store_f(&ob[e + c], acc[c] / fmaxf(l, 1e-30f));
  }
}

// ------------------------------------------------------------ launch ----

// the most shared memory K6 takes at head dims d (q, k) and dv (v): the
// 8-warp tile up to max(d, dv) = 128
size_t flash_smem(int d, int dv) {
  return max(d, dv) > 128 ? flash_smem_t<4, 16>(d, dv)
                          : flash_smem_t<8, 32>(d, dv);
}

size_t decode_smem(int rep, int d, int size) {
  return (size_t)4 * kDT * decode_row_bytes(d, size) +
         sizeof(float) * ((size_t)2 * rep * d + (size_t)rep * kDT + 3 * rep);
}

template <typename T, int DMAX, int WARPS, int KEYS>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int S, int S_kv, int H, int Hk,
                         int d, int dv, int causal, int window,
                         float sm_scale, cudaStream_t stream) {
  using F = FlashTile<WARPS, KEYS>;
  const size_t smem = flash_smem_t<WARPS, KEYS>(d, dv);
  auto kern = flash_kernel<T, DMAX, WARPS, KEYS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int vec = sizeof(T) == 4 && d % 4 == 0 && dv % 4 == 0 &&
                  ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + F::kBQ - 1) / F::kBQ));
  kern<<<grid, F::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, S_kv, H, Hk, d,
      dv, causal, window, sm_scale, vec);
  return cudaGetLastError();
}

// K6's tile for head dims (the larger of d and dv) up to DMAX: 8 warps (128
// query rows) over 32 keys up to D = 128 where those blocks fill the card's
// sms SMs twice;
// 4 warps (64 rows) over kSmallBK keys where they do not (the serve
// path's prefill, B=4, S=128: 160 blocks of 128 rows, one to an SM,
// would run in two waves, the second a fifth full); 4 warps over 16 keys
// above D = 128, where the 8-warp tile's shared memory does not fit
template <typename T, int DMAX>
cudaError_t launch_flash_tile(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int S, int S_kv,
                              int H, int Hk, int d, int dv, int causal,
                              int window, float sm_scale, int sms,
                              cudaStream_t stream) {
  if constexpr (DMAX > 128) {
    return launch_flash<T, DMAX, 4, 16>(q, k, v, o, lse, B, S, S_kv, H, Hk, d,
                                        dv, causal, window, sm_scale, stream);
  } else {
    if ((long long)B * H * ((S + 127) / 128) >= 2LL * sms)
      return launch_flash<T, DMAX, 8, 32>(q, k, v, o, lse, B, S, S_kv, H, Hk,
                                          d, dv, causal, window, sm_scale,
                                          stream);
    return launch_flash<T, DMAX, 4, kSmallBK>(q, k, v, o, lse, B, S, S_kv, H,
                                              Hk, d, dv, causal, window,
                                              sm_scale, stream);
  }
}

// the tile template from the larger head dim: minicpm3's MLA prefill (q, k
// 96, v 64) takes DMAX 128
template <typename T>
cudaError_t launch_flash_d(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int S_kv, int H,
                           int Hk, int d, int dv, int causal, int window,
                           float sm_scale, int sms, cudaStream_t stream) {
  const int dm = max(d, dv);
  if (dm <= 32)
    return launch_flash_tile<T, 32>(q, k, v, o, lse, B, S, S_kv, H, Hk, d, dv,
                                    causal, window, sm_scale, sms, stream);
  if (dm <= 64)
    return launch_flash_tile<T, 64>(q, k, v, o, lse, B, S, S_kv, H, Hk, d, dv,
                                    causal, window, sm_scale, sms, stream);
  if (dm <= 128)
    return launch_flash_tile<T, 128>(q, k, v, o, lse, B, S, S_kv, H, Hk, d,
                                     dv, causal, window, sm_scale, sms,
                                     stream);
  return launch_flash_tile<T, 256>(q, k, v, o, lse, B, S, S_kv, H, Hk, d, dv,
                                   causal, window, sm_scale, sms, stream);
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, float* part,
                          int* tickets, int B, int C, int H, int Hk, int d,
                          float sm_scale, int sms, cudaStream_t stream) {
  const int rep = H / Hk;
  const size_t smem = decode_smem(rep, d, sizeof(T));
  const DecodeSplit sp = decode_split(B * Hk, C, sms);
  const int row = d * (int)sizeof(T);
  const uintptr_t at = (uintptr_t)k | (uintptr_t)v;
  const int cp = row % 16 == 0 && at % 16 == 0  ? 16
                 : row % 4 == 0 && at % 4 == 0 ? 4
                                               : 0;
  auto kern = d % 4 == 0 ? decode_kernel<T, true> : decode_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * Hk), (unsigned)sp.n_split);
  kern<<<grid, kDThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, part, tickets, C,
      H, Hk, d, sp.len, cp, sm_scale);
  return cudaGetLastError();
}

bool shapes_ok(int B, int H, int Hk, int d) {
  return B > 0 && Hk > 0 && H >= Hk && H % Hk == 0 && d > 0 && d <= kMaxD;
}

size_t dtype_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float16, 2 bfloat16. q (B, S, H, d), k (B, S_kv, Hk,
// d), v (B, S_kv, Hk, dv), o (B, S, H, dv), all contiguous; lse null (not
// written) or (B, H, S) float32, each row's m + log(max(l, 1e-30)) over its
// scaled scores (the backward's residual; o's bits do not depend on it);
// S, S_kv >= 1 and
// S <= 65535 * 64; window 0 (none) or the sliding window (keys j > i -
// window); sms the card's SM count (the tile's choice). Returns a
// cudaError_t (0 = launched).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, void* lse_, int B, int S,
                           int S_kv, int H, int Hk, int d, int dv, int causal,
                           int window, float sm_scale, int sms,
                           void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  float* lse = (float*)lse_;
  if (!shapes_ok(B, H, Hk, d) || dv < 1 || dv > kMaxD || S < 1 ||
      S_kv < 1 || sms < 1 || window < 0 || (S + 63) / 64 > 65535 ||
      flash_smem(d, dv) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch_flash_d<float>(q, k, v, o, lse, B, S, S_kv, H, Hk, d,
                                        dv, causal, window, sm_scale, sms,
                                        stream);
    case 1:
      return (int)launch_flash_d<__half>(q, k, v, o, lse, B, S, S_kv, H, Hk, d,
                                         dv, causal, window, sm_scale, sms,
                                         stream);
    case 2:
      return (int)launch_flash_d<__nv_bfloat16>(q, k, v, o, lse, B, S, S_kv, H,
                                                Hk, d, dv, causal, window,
                                                sm_scale, sms, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The number of splits K7 takes over C positions at B * Hk kv heads on a
// card of sms SMs; the positions a split covers go to *len.
int decode_attention_splits(int B, int C, int Hk, int sms, int* len) {
  const DecodeSplit sp = decode_split(B * Hk, C, sms);
  *len = sp.len;
  return sp.n_split;
}

// float32 words of K7's partials a call needs: per (b, kv head, split), its
// rep x d output sums, and its running max and sum per query row.
long long decode_attention_scratch_floats(int B, int C, int H, int Hk, int d,
                                         int sms) {
  const long long n_split = decode_split(B * Hk, C, sms).n_split;
  return (long long)B * Hk * n_split * (H / Hk) * (2 + (long long)d);
}

// q (B, H, d), caches (B, C, Hk, d), lengths (B,) int32, o (B, H, d), all
// contiguous, C >= 1; part holds decode_attention_scratch_floats words and
// tickets B * Hk int32 words that are 0 (each call leaves them 0); sms the
// card's SM count, as given to decode_attention_scratch_floats. Returns a
// cudaError_t (0 = launched).
int decode_attention_launch(int dtype, const void* q, const void* k,
                            const void* v, const int* lengths, void* o,
                            void* part, void* tickets, int B, int C, int H,
                            int Hk, int d, float sm_scale, int sms,
                            void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (!shapes_ok(B, H, Hk, d) || C < 1 || sms < 1 ||
      decode_smem(H / Hk, d, dtype_size(dtype)) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  float* p = (float*)part;
  int* t = (int*)tickets;
  switch (dtype) {
    case 0:
      return (int)launch_decode<float>(q, k, v, lengths, o, p, t, B, C, H, Hk,
                                       d, sm_scale, sms, stream);
    case 1:
      return (int)launch_decode<__half>(q, k, v, lengths, o, p, t, B, C, H,
                                        Hk, d, sm_scale, sms, stream);
    case 2:
      return (int)launch_decode<__nv_bfloat16>(q, k, v, lengths, o, p, t, B,
                                               C, H, Hk, d, sm_scale, sms,
                                               stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* attention_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
