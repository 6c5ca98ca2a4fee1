// The tensor-core product shared by the bottleneck kernels of this directory
// (bottleneck_encode.cu, bottleneck_decode.cu).
//
// Both kernels multiply a token matrix by a weight: encode z = x . W_enc
// (x (T, d), W_enc (d, r)), decode y = codes . W_dec (codes (T, r), W_dec
// (r, d)). Each is computed transposed, z^T = W^T . x^T, so that
//   * A (64-row wgmma tiles) is W^T: its rows are the weight's columns,
//     contiguous in memory. The CTA copies W's rows into shared memory as
//     stored (float32 or bf16); each thread reads its fragments from there
//     and splits a float32 value in registers into three bf16 parts, hi +
//     mid + lo (hi = rn(w), mid = rn(w - hi), lo = rn(w - hi - mid); each
//     difference is exact in float32, so the parts hold w's 24 bits). No
//     split weight is written anywhere: the launch interface takes W as it
//     is.
//   * B is the tokens' rows, K-major (depth contiguous), staged by the
//     CTA's threads into shared memory as bf16 in the 128-byte swizzle
//     wgmma reads: x as it is, int8 codes converted (exact), a float32 x
//     split into three parts like W.
//   * wgmma (m64 nBN k16, bf16 in, float32 accumulation) multiplies each
//     A part by each B part whose product can reach float32's precision
//     (part indices i + j <= 2): 3 products for a float32 W and bf16 x or
//     codes, 1 for bf16 W and x, 6 for float32 W and x. A product of two
//     bf16 values is exact in float32, so the sum differs from a float32
//     dot only in the order and precision of the tensor cores' adds. With
//     a float32 x the five correction products keep an accumulator of
//     their own (corrections()), added to hi . hi's in the epilogue.
//
// A CTA of two warpgroups owns a tile of kTileM = 256 weight columns (M:
// encode's rank, decode's output width; 128 a warpgroup as two m64 tiles)
// by BN = 64, 80 or 96 tokens (N), and walks the depth in stages of kTileK =
// 64, two stages in shared memory: the A stage by cp.async (AStage), the B
// stage through registers, each issued a stage ahead. A k-step is one
// group of wgmmas, waited for before the next k-step's fragments are
// split; the two warpgroups' groups interleave. The z tile stays in
// registers (BN floats a thread) for the kernel's epilogue. Layout of the
// accumulator (wgmma's): thread (warp w of warpgroup wg, lane = 4 g + tq)
// holds, for m tile mt, acc[mt][4 j + e] = z at weight column m0 + wg*128
// + mt*64 + w*16 + g + 8 (e / 2) and token n0 + 8 j + 2 tq + e % 2.
//
// What bounds it on the card (chip_smoke.py, PERF.md): the products alone
// run at about three quarters of an SM's peak a CTA; each CTA copies its W
// tile (1.3 MB of float32 at 256 columns) for its own tokens, and those
// copies' issue, the B staging and the tail of a grid that does not fill
// its last round of SMs take the rest. BN sets the last two: the kernels
// take the token tile whose grid comes closest under whole rounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bottleneck {

constexpr int kThreads = 256;    // two warpgroups
constexpr int kTileM = 256;      // weight columns a CTA
constexpr int kTileK = 64;       // depth a stage: a 128-byte bf16 row
constexpr int kStages = 2;
constexpr int kWarps = kThreads / 32;

// the bf16 parts a float32 operand is split into, and one for bf16 (or
// int8 codes, exact in bf16)
template <typename T>
__host__ __device__ constexpr int parts() { return sizeof(T) == 4 ? 3 : 1; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// two float32 values as a bf16 pair (rounded to nearest even), a in the
// low half
__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f32(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// The bf16 parts of the pair (a, b): out[0] = rn(a, b), then rn of what
// remains, P of them (1 or 3). Each remainder is exact in float32.
template <int P>
__device__ __forceinline__ void split(float a, float b, uint32_t (&out)[P]) {
  out[0] = pack(a, b);
  if constexpr (P == 3) {
    a = __fsub_rn(a, lo_f32(out[0]));
    b = __fsub_rn(b, hi_f32(out[0]));
    out[1] = pack(a, b);
    out[2] = pack(__fsub_rn(a, lo_f32(out[1])), __fsub_rn(b, hi_f32(out[1])));
  }
}

// byte offset of bf16 element (token n, depth k) in a B part: rows of 128
// bytes, 16-byte chunks swizzled within 8-row groups
__device__ __forceinline__ int swz(int n, int k) {
  return n * 128 + ((((k >> 3) ^ (n & 7))) << 4) + (k & 7) * 2;
}

// The shared-memory matrix descriptor of a K-major B part at k-step s (16
// of its 64 columns): start address, leading offset (not read with this
// swizzle), 8-row groups 1 KB apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t b_desc(const unsigned char* part, int s) {
  const uint64_t a = smem_addr(part + s * 32);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// the threads' shared-memory stores, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's register
// operands across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64) += a . b: a (64 x 16) in registers, b (16 x 64) K-major in
// shared memory, by its descriptor
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 96) += a . b: a (64 x 16) in registers, b (16 x 96) K-major in
// shared memory, by its descriptor
__device__ __forceinline__ void wgmma_n96(float (&d)[48],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 80) += a . b: a (64 x 16) in registers, b (16 x 80) K-major in
// shared memory, by its descriptor
__device__ __forceinline__ void wgmma_n80(float (&d)[40],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 96) wgmma_n96(d, a, b);
  if constexpr (BN == 80) wgmma_n80(d, a, b);
  if constexpr (BN == 64) wgmma_n64(d, a, b);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// cp.async of 16 bytes from device into shared memory, of which the first
// `src_bytes` are read and the rest zero-filled
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The weight W (depth, m_cols) with row stride rs, read as A (W^T).
// kShift: its rows are not all 16-byte aligned (AStage).
template <typename TW, bool kShift>
struct Weight {
  const TW* p;
  long long rs;
  int m_cols;
};

// (host) f(std::true_type()) if W's rows at `w`, `row_bytes` apart, are not
// all 16-byte aligned, else f(std::false_type())
template <typename F>
int with_shift(const void* w, long long row_bytes, F&& f) {
  if (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    return f(std::false_type());
  }
  return f(std::true_type());
}

// An A stage holds W rows k0 .. k0 + kTileK - 1, columns m0 .. m0 + kTileM
// - 1, one row a pitch of kRowBytes + 16 (the 16 bytes of padding keep a
// warp's fragment reads on 32 banks), copied in 16-byte chunks. Where W's
// rows are not all 16-byte aligned (kShift), each row is copied from the
// 16-byte boundary at or below its first column, and its columns start
// `shift` bytes into its pitch: that row's address modulo 16 (the rows of
// a float32 weight of r = 1278 columns alternate between 0 and 8). So
// every copy is 16 bytes whatever W's row stride.
template <typename TW, bool kShift>
struct AStage {
  static constexpr int kRowBytes = kTileM * static_cast<int>(sizeof(TW));
  static constexpr int kPitch = kRowBytes + 16;

  // the shift of row k (only the low 4 bits of its address matter)
  __device__ __forceinline__ static uint32_t shift(
      const Weight<TW, kShift>& w, int m0, int k) {
    if constexpr (!kShift) return 0;
    const uint32_t a = static_cast<uint32_t>(
        reinterpret_cast<uintptr_t>(w.p + m0));
    const uint32_t rs = static_cast<uint32_t>(w.rs) * sizeof(TW);
    return (a + static_cast<uint32_t>(k) * rs) & 15u;
  }

  // the copies of the stage at depth k0 into `stage`, zero past depth and
  // past m_cols: a thread copies chunk j of every kStep-th row, walking
  // its row address (the copies' issue is a third of the loop's time if
  // each recomputes its address); shifted rows' last chunks after
  __device__ __forceinline__ static void copy(const Weight<TW, kShift>& w,
                                              int depth, int m0, int k0,
                                              unsigned char* stage) {
    constexpr int kPerRow = kRowBytes / 16;
    constexpr int kStep = kThreads / kPerRow;
    const int j = threadIdx.x % kPerRow, row0 = threadIdx.x / kPerRow;
    const long long rsb = w.rs * static_cast<long long>(sizeof(TW));
    const char* tile = reinterpret_cast<const char*>(w.p + m0);
    // the bytes of a row from its first column to m_cols
    const long long cols = (long long)(w.m_cols - m0) * sizeof(TW);
    const char* row = tile + (k0 + row0) * rsb;
    uint32_t dst = smem_addr(stage) + row0 * kPitch + 16 * j;
#pragma unroll 4
    for (int i = 0; i < kTileK / kStep; ++i) {
      const int sh = kShift ? static_cast<int>(
                                  reinterpret_cast<uintptr_t>(row) & 15)
                            : 0;
      const long long left = cols + sh - 16 * j;
      const int bytes = k0 + row0 + i * kStep < depth
                            ? static_cast<int>(left <= 0 ? 0
                                               : left >= 16 ? 16 : left)
                            : 0;
      copy16(dst, bytes > 0 ? row - sh + 16 * j : tile, bytes);
      row += kStep * rsb;
      dst += kStep * kPitch;
    }
    if constexpr (kShift) {
      if (threadIdx.x < kTileK) {
        const int k = k0 + threadIdx.x;
        const char* r = tile + k * rsb;
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(r) & 15);
        const long long left = cols + sh - 16 * kPerRow;
        const int bytes = k < depth ? static_cast<int>(
                                          left <= 0 ? 0
                                          : left >= 16 ? 16 : left)
                                    : 0;
        copy16(smem_addr(stage) + threadIdx.x * kPitch + 16 * kPerRow,
               bytes > 0 ? r - sh + 16 * kPerRow : tile, bytes);
      }
    }
  }
};

// The tokens' rows as B: element (n, k) of a (T, depth) matrix of T_ with
// row stride rs, staged in pairs (k even). `pairs`: the pair loads are
// aligned and in bounds (depth and rs even, the base aligned to a pair).
template <typename T_>
struct Rows {
  const T_* p;
  long long rs;
  int T, depth;
  bool pairs;
};

// raw bits of elements (n, k) and (n, k + 1), 0 past the edges
__device__ __forceinline__ uint32_t load_pair(const Rows<__nv_bfloat16>& s,
                                              long long off, bool in0,
                                              bool in1) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(s.p);
  if (s.pairs) {
    return in0 ? __ldg(reinterpret_cast<const unsigned int*>(q + off)) : 0u;
  }
  const uint32_t lo = in0 ? __ldg(q + off) : 0u;
  const uint32_t hi = in1 ? __ldg(q + off + 1) : 0u;
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t load_pair(const Rows<signed char>& s,
                                              long long off, bool in0,
                                              bool in1) {
  const unsigned char* q = reinterpret_cast<const unsigned char*>(s.p);
  if (s.pairs) {
    return in0 ? __ldg(reinterpret_cast<const unsigned short*>(q + off))
               : 0u;
  }
  const uint32_t lo = in0 ? __ldg(q + off) : 0u;
  const uint32_t hi = in1 ? __ldg(q + off + 1) : 0u;
  return lo | (hi << 8);
}
__device__ __forceinline__ float2 load_pair(const Rows<float>& s,
                                            long long off, bool in0,
                                            bool in1) {
  if (s.pairs) {
    return in0 ? __ldg(reinterpret_cast<const float2*>(s.p + off))
               : make_float2(0.f, 0.f);
  }
  return make_float2(in0 ? __ldg(s.p + off) : 0.f,
                     in1 ? __ldg(s.p + off + 1) : 0.f);
}

// a loaded pair as its bf16 parts
__device__ __forceinline__ void to_parts(uint32_t raw, uint32_t (&out)[1],
                                         const __nv_bfloat16*) {
  out[0] = raw;
}
__device__ __forceinline__ void to_parts(uint32_t raw, uint32_t (&out)[1],
                                         const signed char*) {
  out[0] = pack(static_cast<float>(static_cast<signed char>(raw & 0xff)),
                static_cast<float>(static_cast<signed char>(raw >> 8)));
}
__device__ __forceinline__ void to_parts(float2 raw, uint32_t (&out)[3],
                                         const float*) {
  split<3>(raw.x, raw.y, out);
}

template <typename T_>
using Raw = decltype(load_pair(Rows<T_>{}, 0, false, false));

// a thread's pairs of a B stage of BN tokens
template <int BN>
__host__ __device__ constexpr int pairs_of() {
  return BN * kTileK / 2 / kThreads;
}

// stage k0 .. k0 + kTileK - 1 of tokens n0 .. n0 + BN - 1 into registers:
// pair i is token e / 32, depth 2 (e % 32), e = threadIdx.x + i * kThreads
// (a warp reads one row's 64 elements)
template <int BN, typename T_>
__device__ __forceinline__ void fetch_b(const Rows<T_>& src, int n0, int k0,
                                        Raw<T_> (&raw)[pairs_of<BN>()]) {
  // pair i is kThreads / 32 rows below pair i - 1: one running offset
  const int n = n0 + threadIdx.x / 32, k = k0 + 2 * (threadIdx.x % 32);
  const bool in0 = k < src.depth, in1 = k + 1 < src.depth;
  long long off = (long long)n * src.rs + k;
  const long long step = (long long)(kThreads / 32) * src.rs;
#pragma unroll
  for (int i = 0; i < pairs_of<BN>(); ++i, off += step) {
    const bool row = n + i * (kThreads / 32) < src.T;
    raw[i] = load_pair(src, off, row && in0, row && in1);
  }
}

// the registers of fetch_b into a stage's PB parts (each `part` bytes)
template <int BN, typename T_, int PB>
__device__ __forceinline__ void store_b(unsigned char* stage, int part,
                                        const Raw<T_> (&raw)[pairs_of<BN>()]) {
#pragma unroll
  for (int i = 0; i < pairs_of<BN>(); ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int off = swz(e / 32, 2 * (e % 32));
    uint32_t v[PB];
    to_parts(raw[i], v, static_cast<const T_*>(nullptr));
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      *reinterpret_cast<uint32_t*>(stage + p * part + off) = v[p];
    }
  }
}

// Dynamic shared memory of a kernel with weight type TW, BN tokens a tile
// and a B of PB parts: the A stages (a k row of kTileM weights, padded 16
// bytes so that a warp's fragment reads hit 32 banks), the B stages (1 KB
// aligned), then (encode) the cluster's token maxima (one row a rank), the
// tile's token scales and an mbarrier; 1 KB of slack to align the base to
// the swizzle's 1,024-byte period. After a tile's product, the encode
// kernel's warps put their token maxima (kWarps x BN floats) over the B
// stages.
template <typename TW, int BN, int PB>
struct Smem {
  static constexpr int kAStage = kTileK * AStage<TW, false>::kPitch;
  static constexpr int kPart = BN * kTileK * 2;     // one bf16 part of B
  static constexpr int kBStage = PB * kPart;
  static constexpr int kB = kStages * kAStage;
  static constexpr int kRed = kB;
  static constexpr int kPeers = kB + kStages * kBStage;
  static constexpr int kScale = kPeers + 8 * BN * 4;
  static constexpr int kBar = kScale + BN * 4;
  static constexpr int kBytes = kBar + 16 + 1024;
  static_assert(kB % 1024 == 0 && kPart % 1024 == 0, "B stages aligned");
  static_assert(kWarps * BN * 4 <= kStages * kBStage, "maxima fit");
};

// A thread's place in the accumulator's layout (see the head of this file)
struct Lane {
  int wg, warp, g, tq;
  __device__ __forceinline__ Lane()
      : wg(threadIdx.x / 128), warp(threadIdx.x % 128 / 32),
        g(threadIdx.x % 32 / 4), tq(threadIdx.x % 4) {}
  // the weight column of row half h of m tile mt, in a tile at m0
  __device__ __forceinline__ int m(int m0, int mt, int h) const {
    return m0 + wg * 128 + mt * 64 + warp * 16 + h * 8 + g;
  }
  // the token of accumulator element 4 j + e, in a tile at n0
  __device__ __forceinline__ int n(int n0, int j, int e) const {
    return n0 + 8 * j + 2 * tq + (e & 1);
  }
};

// A thread's A fragments of m tile mt at k-step s of the A stage at depth
// k0, split into PA bf16 parts: af[part][f], fragment f = row half f % 2,
// depth 16 s + 2 tq + 8 (f / 2) and the next
template <int PA, typename TW, bool kShift>
__device__ __forceinline__ void a_fragments(const unsigned char* stage,
                                            const Weight<TW, kShift>& w,
                                            int m0, int k0, const Lane& ln,
                                            int s, int mt,
                                            uint32_t (&af)[PA][4]) {
  using A = AStage<TW, kShift>;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int k = 16 * s + 2 * ln.tq + 8 * (f / 2);
    const TW* p = reinterpret_cast<const TW*>(
                      stage + k * A::kPitch + A::shift(w, m0, k0 + k))
                  + ln.m(0, mt, f % 2);
    const TW* q = reinterpret_cast<const TW*>(
                      stage + (k + 1) * A::kPitch
                      + A::shift(w, m0, k0 + k + 1))
                  + ln.m(0, mt, f % 2);
    uint32_t v[PA];
    split<PA>(to_f32(*p), to_f32(*q), v);
#pragma unroll
    for (int i = 0; i < PA; ++i) af[i][f] = v[i];
  }
}

// Where B is a float32 x (three parts), the products of parts other than
// hi . hi go into an accumulator of their own, added to hi . hi's once, in
// the epilogue, as CUTLASS's 3xTF32 keeps its corrections. The tensor cores
// add into an accumulator short of a float32 add, with a bias toward zero
// that grows with the adds onto one running sum: six products a k-step
// into one accumulator (480 adds at d = 1280) read a float32 x's max |z|
// up to 1e-5 relative short of a float64 product, and its scales beyond
// SCALES_TOL of the plain version's (chip_smoke.py phase 3, PERF.md). The
// corrections' own sum is 2^-8 of z, so its bias is too; hi . hi keeps 80
// adds. Nothing reads an accumulator between groups, so ptxas keeps the
// wgmmas in flight. A bf16 x (the serving path) keeps its three products
// a k-step in one accumulator.
template <int PB>
__host__ __device__ constexpr bool corrections() { return PB == 3; }

// The wgmmas of m tile mt at k-step s: each product of A part i and B part
// j with i + j <= 2, the smallest first, as one group: into acc, or, for a
// correction (corrections(), i + j > 0), into corr.
template <int BN, int PA, int PB, int NC>
__device__ __forceinline__ void products(float (&acc)[BN / 2],
                                         float (&corr)[NC],
                                         const uint32_t (&af)[PA][4],
                                         const unsigned char* b_stage,
                                         int part, int s) {
  wgmma_fence();
#pragma unroll
  for (int sum = 2; sum >= 0; --sum) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = sum - i;
      if (j < 0 || j >= PB) continue;
      if constexpr (corrections<PB>()) {
        if (sum > 0) {
          wgmma<BN>(corr, af[i], b_desc(b_stage + j * part, s));
          continue;
        }
      }
      wgmma<BN>(acc, af[i], b_desc(b_stage + j * part, s));
    }
  }
  wgmma_commit();
}

// acc[mt] = W^T . B^T over the whole depth for weight columns m0 .. m0 +
// kTileM - 1 and tokens n0 .. n0 + BN - 1; columns past m_cols and depth
// past src.depth read as 0. `sm` is the 1 KB-aligned shared memory of
// Smem<TW, BN, parts<T_>()>. Every thread of the CTA calls it; it returns
// with the stages free (after a barrier).
template <int BN, typename TW, bool kShift, typename T_>
__device__ __forceinline__ void tile_product(float (&acc)[2][BN / 2],
                                             const Weight<TW, kShift>& w,
                                             int m0,
                                             const Rows<T_>& src, int n0,
                                             unsigned char* sm) {
  constexpr int PA = parts<TW>(), PB = parts<T_>();
  // the corrections' accumulator (corrections()); one unused float else
  constexpr int NC = corrections<PB>() ? BN / 2 : 1;
  using S = Smem<TW, BN, PB>;
  const Lane ln;
  const int depth = src.depth;
  float corr[2][NC];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    fence_regs(acc[mt]);        // zeroed before the first group is issued
    if constexpr (corrections<PB>()) {
#pragma unroll
      for (int i = 0; i < NC; ++i) corr[mt][i] = 0.f;
      fence_regs(corr[mt]);
    }
  }
  const int n_stages = (depth + kTileK - 1) / kTileK;
  Raw<T_> braw[pairs_of<BN>()];
  AStage<TW, kShift>::copy(w, depth, m0, 0, sm);
  copy_commit();
  fetch_b<BN>(src, n0, 0, braw);
  store_b<BN, T_, PB>(sm + S::kB, S::kPart, braw);
  fence_proxy_async();
  // The k-steps form one chain across the stages, two groups of wgmmas
  // in flight: each m tile's group of a k-step is issued once that m
  // tile's group of the k-step before is done, so that a tile's fragments
  // are read and split while the other tile's group runs. The
  // accumulators are not touched while a group runs (ptxas would
  // serialise the wgmmas).
  uint32_t af[2][PA][4];       // [mt][part][fragment]
  for (int kt = 0; kt < n_stages; ++kt) {
    const bool more = kt + 1 < n_stages;
    if (more) {
      AStage<TW, kShift>::copy(w, depth, m0, (kt + 1) * kTileK,
                               sm + ((kt + 1) % kStages) * S::kAStage);
      copy_commit();
      fetch_b<BN>(src, n0, (kt + 1) * kTileK, braw);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();            // stage kt's A and B are in for all threads
    const unsigned char* a_st = sm + (kt % kStages) * S::kAStage;
    const unsigned char* b_st = sm + S::kB + (kt % kStages) * S::kBStage;
#pragma unroll
    for (int s = 0; s < kTileK / 16; ++s) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        wgmma_wait<1>();        // this m tile's group of the last k-step
#pragma unroll
        for (int i = 0; i < PA; ++i) fence_regs(af[mt][i]);
        a_fragments<PA>(a_st, w, m0, kt * kTileK, ln, s, mt, af[mt]);
        products<BN, PA, PB>(acc[mt], corr[mt], af[mt], b_st, S::kPart, s);
      }
    }
    if (more) {
      // every warpgroup's groups of stage kt - 1, which read the B stage
      // refilled here, are done
      __syncthreads();
      store_b<BN, T_, PB>(sm + S::kB + ((kt + 1) % kStages) * S::kBStage,
                          S::kPart, braw);
      fence_proxy_async();
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  if constexpr (corrections<PB>()) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      fence_regs(corr[mt]);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[mt][i] = __fadd_rn(acc[mt][i], corr[mt][i]);
      }
    }
  }
  __syncthreads();              // the stages are free
}

}  // namespace bottleneck
