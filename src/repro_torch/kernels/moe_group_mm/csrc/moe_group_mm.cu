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
// with w (E, d_in, d_out), sums in float32 and out written in x's type
// (float32, float16 or bfloat16; x and w share it). As the TPU kernel does,
// every row block is computed, pad rows and trailing blocks included (pad
// rows of x are zero, so their outputs are zero). Expert ids are clipped to
// [0, E) so that no id reads outside w (the dispatcher's are in range).
//
// Design: the products on the tensor cores. The TPU kernel scalar-prefetches
// the expert ids; here each thread block owns a tile of out inside one row
// block, reads that block's expert id itself, and walks d_in a stage at a
// time. The grid is one-dimensional, row tiles fastest: the row blocks that
// share an expert (neighbours after the monotonic sort) and a column strip of
// its weights run together, so the strip is read from device memory once and
// from L2 after. block_t is any positive size: a row block shorter than the
// tile, or its ragged last tile, is masked (the model uses 128, the
// reference's tests 8, 16 and 32); d_in and d_out are masked too.
//
// - float32: 3xTF32 on wgmma (gmm_tf32_kernel). Each operand is split into
//   hi = tf32(x) and lo = tf32(x - hi), rounded as cvt.rna.tf32.f32 rounds,
//   and a product is lo*hi + hi*lo + hi*hi, summed in float32 by the tensor
//   cores. The split keeps ~2^-21 a product where one TF32 pass keeps ~2^-11
//   (tests/test_torch_moe_tf32.py emulates both on the CPU with exact
//   products at phi3.5-moe's widths: three passes 3.7e-7 off, one 1.2e-3).
//   On the card the tensor cores' float32 accumulation sets the error, not
//   the split: 1.8e-4 (w_in) and 2.6e-4 (w_out) against cuBLAS on outputs of
//   about 1, inside the float32 dot-product bound 2 gamma_(d_in) |x||w| and
//   under half of the tighter TF32 limit chip_smoke.py also holds the kernel
//   to, which one pass misses. Summing the two small products apart from the
//   big one cut it to 6.6e-5, but needs 64 more registers a thread, spilled
//   and ran 30% slower. A block of two warpgroups computes a
//   128 (d_out) x 128 (rows) tile transposed, D' = w^T x^T, with
//   wgmma.m64n128k8: wgmma takes a TF32 operand from shared memory only
//   K-major, which x's rows are and w's are not, so x is the shared-memory
//   operand (split into hi and lo tiles in the 128-byte swizzle layout) and
//   w the register operand (each thread loads and splits its own fragment
//   words). Both tiles go through registers, not through staging buffers:
//   wgmma's reads of the x tiles use half of shared memory's 128 bytes a
//   clock at the tensor cores' full rate, and a design that staged both
//   tiles by cp.async and read them back was bound by shared-memory bandwidth
//   at half the tensor cores' rate. While the tensor cores run one stage,
//   the threads split the next (loaded during the one before) and load the
//   one after.
// - float16, bfloat16: mma.sync.m16n8k16 with float32 accumulators
//   (group_matmul_kernel); their products are exact in float32. A 128 x 128
//   tile a block, 8 warps of 64 x 32; the x tile (row-major, k contiguous)
//   and the w tile (k rows, columns contiguous) stream through a ring of
//   kStages shared-memory buffers by cp.async, 16-byte copies zero-filled
//   past the row block, d_in and d_out (plain loads where d_in, d_out or the
//   pointers do not allow 16-byte copies); A fragments by ldmatrix, B by
//   ldmatrix.trans.
//
// Bound. Operations: 2 * T_pad * d_in * d_out flops; at phi3.5-moe's prefill
// (4 x 128 tokens, top-2: T_pad = 3072, d_in = 4096, d_out = 6400) 161 GFLOP,
// which at the accuracy kept (3xTF32) is 3 x 161 GFLOP at the TF32 tensor
// cores' 495 TFLOP/s, 0.98 ms (in float32 on the CUDA cores, 67 TFLOP/s, 2.41
// ms); its bytes (the experts' weights once, 1.68 GB, x and out) take 0.54 ms.
// 1200 tiles on 132 SMs, one block an SM, run in 10 rounds, the last a tenth
// full.
//
// Plain C interface (no PyTorch headers): the wrapper in ../kernel.py passes
// data_ptr()s and the current stream through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;  // rows of a tile
constexpr int kBN = 128;  // columns of a tile
constexpr int kBK = 32;   // d_in a buffer
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 8 warps: 2 along the rows, 4 along columns
constexpr int kWM = 64, kWN = 32;  // a warp's piece of the tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;  // its mma tiles

// shared row strides of the half types' tiles, in elements: x rows padded to
// 80 bytes and w rows to 272, so the 8 row addresses of an ldmatrix hit 8
// distinct 16-byte bank groups
template <typename T>
struct Strides {
  static constexpr int kA = kBK + 8;
  static constexpr int kB = kBN + 8;
  static constexpr size_t kABytes = sizeof(T) * kBM * kA;
  static constexpr size_t kBytes = kABytes + sizeof(T) * kBK * kB;
};

template <typename T>
constexpr size_t gmm_smem() {
  return kStages * Strides<T>::kBytes;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes from src, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// one buffer's products in float16 or bfloat16: the warp's 4 x 4 mma tiles
// over kBK of d_in, the x tile at shared address sa (row-major, stride
// Strides<T>::kA) and the w tile at sb (k rows, stride Strides<T>::kB)
template <typename T>
__device__ __forceinline__ void multiply(float (&acc)[kMT][kNT][4],
                                         unsigned sa, const T* sb, int lane,
                                         int wm, int wn) {
  using S = Strides<T>;
  // ldmatrix: lane l gives the address of row l % 16 of the mma tile, at the
  // first (l < 16) or second 8 elements of the k step; ldmatrix.trans: k row
  // l % 16 of n tile 2p + l / 16
  const unsigned a_lane =
      sa + ((wm * kWM + (lane & 15)) * S::kA) * sizeof(T) + (lane >> 4) * 16;
  const unsigned sb_addr = (unsigned)__cvta_generic_to_shared(sb);
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    unsigned a[kMT][4], b[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      ldmatrix_x4(a[mt], a_lane + (mt * 16 * S::kA + ks * 16) * 2);
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
      unsigned r[4];
      ldmatrix_x4_trans(
          r, sb_addr + ((ks * 16 + (lane & 15)) * S::kB + wn * kWN +
                        (2 * p + (lane >> 4)) * 8) * 2);
      b[2 * p][0] = r[0], b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_16816<T>(acc[mt][nt], a[mt], b[nt]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    group_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ block_expert,
                        T* __restrict__ out, int d_in, int d_out,
                        int n_experts, int block_t, int tiles_per_block,
                        int n_row_tiles, int vec) {
  using S = Strides<T>;
  constexpr int XV = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int AQ = kBK / XV, BQ = kBN / XV;  // copies a row of each tile
  static_assert((kBM * AQ) % kThreads == 0 && (kBK * BQ) % kThreads == 0,
                "every thread makes as many copies");
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const int row_tile = blockIdx.x % n_row_tiles;  // row tiles fastest
  const int c0 = (blockIdx.x / n_row_tiles) * kBN;
  const int blk = row_tile / tiles_per_block;
  const int r0 = blk * block_t + (row_tile % tiles_per_block) * kBM;
  const int r_end = (blk + 1) * block_t;
  const int rows = r_end - r0 < kBM ? r_end - r0 : kBM;
  int e = block_expert[blk];
  e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
  const T* __restrict__ xr = x + (size_t)r0 * d_in;
  const T* __restrict__ we = w + (size_t)e * d_in * d_out;

  // d_in [k0, k0 + kBK) of the x and w tiles into buffer `stage`, zeros past
  // the row block, d_in and d_out
  auto load = [&](int k0, int stage) {
    T* sa = reinterpret_cast<T*>(smem + stage * S::kBytes);
    T* sb = reinterpret_cast<T*>(smem + stage * S::kBytes + S::kABytes);
    if (vec) {  // d_in and d_out whole copies, pointers 16-byte aligned
#pragma unroll
      for (int j = 0; j < kBM * AQ / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / AQ, k = k0 + (i % AQ) * XV;
        const bool ok = r < rows && k < d_in;
        cp_async16(sa + r * S::kA + (i % AQ) * XV,
                   ok ? xr + (size_t)r * d_in + k : x, ok);
      }
#pragma unroll
      for (int j = 0; j < kBK * BQ / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int kr = i / BQ, col = c0 + (i % BQ) * XV;
        const bool ok = k0 + kr < d_in && col < d_out;
        cp_async16(sb + kr * S::kB + (i % BQ) * XV,
                   ok ? we + (size_t)(k0 + kr) * d_out + col : w, ok);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, k = k0 + i % kBK;
        sa[r * S::kA + i % kBK] = r < rows && k < d_in
                                      ? xr[(size_t)r * d_in + k]
                                      : from_f<T>(0.0f);
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int kr = i / kBN, col = c0 + i % kBN;
        sb[kr * S::kB + i % kBN] = k0 + kr < d_in && col < d_out
                                       ? we[(size_t)(k0 + kr) * d_out + col]
                                       : from_f<T>(0.0f);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_k = (d_in + kBK - 1) / kBK;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_k) load(i * kBK, i);
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // buffer kt landed; the one of kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < n_k) load(next * kBK, next % kStages);
    cp_commit();
    char* buf = smem + (kt % kStages) * S::kBytes;
    multiply<T>(acc, (unsigned)__cvta_generic_to_shared(buf),
                reinterpret_cast<const T*>(buf + S::kABytes), lane, wm, wn);
  }

  // c0, c1 at (row g, columns 2 t4, 2 t4 + 1), c2, c3 at row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * kWM + mt * 16 + g + 8 * hh;
      if (r >= rows) continue;
      T* __restrict__ orow = out + (size_t)(r0 + r) * d_out;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = c0 + wn * kWN + nt * 8 + 2 * t4;
        if (col < d_out) orow[col] = from_f<T>(acc[mt][nt][2 * hh]);
        if (col + 1 < d_out) orow[col + 1] = from_f<T>(acc[mt][nt][2 * hh + 1]);
      }
    }
}

// ---------------------------------------------------- float32: wgmma ----

constexpr int kFN = 128;  // d_out a block: two warpgroups of 64 rows of D'
constexpr int kFM = 128;  // x rows a block: the wgmma's N
constexpr int kFK = 32;   // d_in a stage: one 128-byte swizzle row of x
constexpr int kFXBytes = kFM * kFK * 4;  // an x tile, 16 KB
constexpr int kFSmem = 1024 + 4 * kFXBytes;  // two hi and two lo x tiles

// the bits cvt.rna.tf32.f32 gives (to nearest, ties away from zero) for every
// finite input, in two integer instructions (the cvt adds a NaN test)
__device__ __forceinline__ unsigned tf32_rna(unsigned x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, each a TF32 value: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_rna(unsigned x, unsigned& hi,
                                          unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

// the byte offset of x element (row r, k) in a 128-byte-swizzled tile: rows
// of 32 words, the 16-byte chunk index XORed with r % 8 (what wgmma's
// 128-byte swizzle mode reads, from a 1024-byte-aligned tile)
__device__ __forceinline__ int swz(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// a wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle mode: 8-row groups 1024 bytes apart (SBO), the leading offset
// unused (1)
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128, float32, in registers) += A (64 x 8, tf32, registers) *
// B (8 x 128, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until this warpgroup's wgmma groups are done
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma fence or wait
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// a thread's A fragments of one stage: 4 k steps of 8, hi and lo words
struct AFrags {
  unsigned hi[kFK / 8][4], lo[kFK / 8][4];
};

// a thread's words of one stage, loaded into registers: 16 of x (row
// tid / 2, d_in [16 (tid % 2), + 16) of the stage) and its 16 A-fragment
// words of w
struct Raw {
  float4 x[4];
  float w[kFK / 8][4];
};

// float32 out = x @ w[e] in 3xTF32 on wgmma, computed transposed: D' (d_out
// x rows) = w[e]^T x^T (see the notes at the top). Each stage is 3 x 4
// wgmma.m64n128k8 a warpgroup, w_lo.x_hi, w_hi.x_lo, w_hi.x_hi, on the x
// tiles of one of two slots; while the tensor cores run stage kt, the
// threads split stage kt + 1 (loaded into registers during stage kt - 1)
// into the other slot and their next fragments, and load stage kt + 2.
__global__ void __launch_bounds__(kThreads, 1)
    gmm_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ block_expert,
                    float* __restrict__ out, int d_in, int d_out,
                    int n_experts, int block_t, int tiles_per_block,
                    int n_row_tiles, int vec) {
  extern __shared__ __align__(16) char fsmem[];
  // 1024-byte aligned base: the hi tiles [2], then the lo tiles [2]
  const unsigned raw_base = (unsigned)__cvta_generic_to_shared(fsmem);
  const unsigned base = (raw_base + 1023u) & ~1023u;
  char* sm = fsmem + (base - raw_base);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_tile = blockIdx.x % n_row_tiles;  // row tiles fastest
  const int n0 = (blockIdx.x / n_row_tiles) * kFN;
  const int blk = row_tile / tiles_per_block;
  const int r0 = blk * block_t + (row_tile % tiles_per_block) * kFM;
  const int r_end = (blk + 1) * block_t;
  const int rows = r_end - r0 < kFM ? r_end - r0 : kFM;
  int e = block_expert[blk];
  e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
  const float* __restrict__ we = w + (size_t)e * d_in * d_out;

  // this thread's x words: row xrow, d_in [xk, xk + 16) of the stage
  const int xrow = tid >> 1, xk = (tid & 1) * 16;
  const float* __restrict__ xp = x + (size_t)(r0 + xrow) * d_in;
  const bool xrow_ok = xrow < rows;
  // its A-fragment words: D' rows (d_out) nr, nr + 8
  const int nr = (warp >> 2) * 64 + (warp & 3) * 16 + g;

  // stage kt's words into registers, zeros past the row block, d_in, d_out
  auto fetch = [&](int kt, Raw& r) {
    const int k0 = kt * kFK + xk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec) {
        if (xrow_ok && k < d_in) v = *reinterpret_cast<const float4*>(xp + k);
      } else if (xrow_ok) {
        if (k < d_in) v.x = xp[k];
        if (k + 1 < d_in) v.y = xp[k + 1];
        if (k + 2 < d_in) v.z = xp[k + 2];
        if (k + 3 < d_in) v.w = xp[k + 3];
      }
      r.x[q] = v;
    }
#pragma unroll
    for (int ks = 0; ks < kFK / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0 (g, t4), a1 (g + 8, t4), a2, a3 (k + 4)
        const int k = kt * kFK + ks * 8 + t4 + 4 * (i >> 1);
        const int n = n0 + nr + 8 * (i & 1);
        r.w[ks][i] = k < d_in && n < d_out ? we[(size_t)k * d_out + n] : 0.f;
      }
  };
  // stage words r split: x into hi/lo tiles `slot`, w into fragments f
  auto split = [&](const Raw& r, int slot, AFrags& f) {
    char* hi = sm + slot * kFXBytes;
    char* lo = sm + (2 + slot) * kFXBytes;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 h, l;
      split_rna(__float_as_uint(r.x[q].x), h.x, l.x);
      split_rna(__float_as_uint(r.x[q].y), h.y, l.y);
      split_rna(__float_as_uint(r.x[q].z), h.z, l.z);
      split_rna(__float_as_uint(r.x[q].w), h.w, l.w);
      const int o = swz(xrow, (xk >> 2) + q);
      *reinterpret_cast<uint4*>(hi + o) = h;
      *reinterpret_cast<uint4*>(lo + o) = l;
    }
#pragma unroll
    for (int ks = 0; ks < kFK / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_rna(__float_as_uint(r.w[ks][i]), f.hi[ks][i], f.lo[ks][i]);
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  const int n_k = (d_in + kFK - 1) / kFK;
  Raw raw;
  AFrags fa, fb;
  fetch(0, raw);
  split(raw, 0, fa);
  if (n_k > 1) fetch(1, raw);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // stage kt: the products on tiles kt % 2 with fragments `cur`; while the
  // tensor cores work, stage kt + 1 (in `raw`) split into tiles (kt + 1) % 2
  // and `nxt`, and stage kt + 2 loaded into `raw`
  auto stage = [&](int kt, const AFrags& cur, AFrags& nxt) {
    const unsigned xh = base + (kt & 1) * kFXBytes;
    const unsigned xl = base + (2 + (kt & 1)) * kFXBytes;
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(d[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kFK / 8; ++ks) {
      wgmma_tf32(d, cur.lo[ks], desc_sw128(xh + ks * 32));
      wgmma_tf32(d, cur.hi[ks], desc_sw128(xl + ks * 32));
      wgmma_tf32(d, cur.hi[ks], desc_sw128(xh + ks * 32));
    }
    wgmma_commit();
    if (kt + 1 < n_k) {
      split(raw, (kt + 1) & 1, nxt);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (kt + 2 < n_k) fetch(kt + 2, raw);
    }
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(d[i]);
    __syncthreads();  // tiles kt + 1 visible; tiles kt free
  };
  for (int kt = 0; kt < n_k; kt += 2) {
    stage(kt, fa, fb);
    if (kt + 1 < n_k) stage(kt + 1, fb, fa);
  }

  // d[4j + 2h + c]: D' row nr + 8h (d_out column n0 + nr + 8h), column
  // 8j + 2 t4 + c (x row r0 + 8j + 2 t4 + c)
  const int col_a = n0 + nr, col_b = col_a + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = 8 * j + 2 * t4 + c;
      if (r >= rows) continue;
      float* orow = out + (size_t)(r0 + r) * d_out;
      if (col_a < d_out) orow[col_a] = d[4 * j + c];
      if (col_b < d_out) orow[col_b] = d[4 * j + 2 + c];
    }
}

cudaError_t launch_f32(const float* x, const float* w, const int* block_expert,
                       float* out, int t_pad, int d_in, int d_out,
                       int n_experts, int block_t, cudaStream_t stream) {
  const int tiles_per_block = (block_t + kFM - 1) / kFM;
  const long long n_row_tiles =
      (long long)(t_pad / block_t) * tiles_per_block;
  const long long blocks = n_row_tiles * ((d_out + kFN - 1) / kFN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (e != cudaSuccess) return e;
  const int vec = d_in % 4 == 0 && (uintptr_t)x % 16 == 0;
  gmm_tf32_kernel<<<(unsigned)blocks, kThreads, kFSmem, stream>>>(
      x, w, block_expert, out, d_in, d_out, n_experts, block_t,
      tiles_per_block, (int)n_row_tiles, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* block_expert,
                   void* out, int t_pad, int d_in, int d_out, int n_experts,
                   int block_t, cudaStream_t stream) {
  constexpr int XV = 16 / sizeof(T);
  const int tiles_per_block = (block_t + kBM - 1) / kBM;
  const long long n_row_tiles =
      (long long)(t_pad / block_t) * tiles_per_block;
  const long long blocks = n_row_tiles * ((d_out + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kern = group_matmul_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gmm_smem<T>());
  if (e != cudaSuccess) return e;
  const int vec = d_in % XV == 0 && d_out % XV == 0 &&
                  ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
  kern<<<(unsigned)blocks, kThreads, gmm_smem<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), block_expert,
      static_cast<T*>(out), d_in, d_out, n_experts, block_t, tiles_per_block,
      (int)n_row_tiles, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (T_pad, d_out) = the grouped product of contiguous x (T_pad, d_in) and
// w (E, d_in, d_out), both of type `dtype` (0 float32, 1 float16, 2
// bfloat16), with int32 block_expert (T_pad / block_t,), on `stream`. The
// wrapper asks for T_pad a positive multiple of block_t, d_in, d_out, E >= 1.
// Returns a cudaError_t (0 = launched), or cudaErrorInvalidValue for another
// dtype, cudaErrorInvalidConfiguration for 2**31 tiles or more.
int group_matmul_launch(int dtype, const void* x, const void* w,
                        const int* block_expert, void* out, int t_pad,
                        int d_in, int d_out, int n_experts, int block_t,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_f32(static_cast<const float*>(x),
                             static_cast<const float*>(w), block_expert,
                             static_cast<float*>(out), t_pad, d_in, d_out,
                             n_experts, block_t, st);
    case 1:
      return (int)launch<__half>(x, w, block_expert, out, t_pad, d_in, d_out,
                                 n_experts, block_t, st);
    case 2:
      return (int)launch<__nv_bfloat16>(x, w, block_expert, out, t_pad, d_in,
                                        d_out, n_experts, block_t, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* group_matmul_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
