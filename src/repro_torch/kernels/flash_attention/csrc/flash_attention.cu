// Blocked GQA attention over the full sequence for Hopper (sm_90a): q
// (B, S, H, hd) against k/v (B, S, K, hd), causal or not.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:flash_call
//   (body _flash_kernel, wrapper ops.py:flash_attention).
// It computes the same function: scores q.k in float32, times 1/sqrt(hd);
// keys at or past S masked (the reference's valid_len), and keys after the
// query masked when causal, both with the finite NEG_INF = -1e30; the
// running max, sum and probabilities in float32, P.V accumulated in
// float32, the division by max(l, 1e-30); kv tiles wholly above the
// diagonal skipped; one rounding of the output to q's dtype. Query head h
// reads kv head h / (H / K).
//
// What bounds it on this card: at LISA-7B's prefill (S = 204, hd = 128,
// bf16, causal) bytes. q, k, v and the output are 4 * B*S*H*hd elements,
// read or written once; the causal product is 4 * B*H*hd * S(S+1)/2 flops,
// about 51 flops a byte, far below the tensor cores' ~295 flops/byte
// balance point. Past about 1,000 keys at hd = 128 the operations bind.
//
// The bf16 kernel (flash_wgmma_kernel), one design for every S:
//   * One warpgroup (four warps) a CTA, one CTA per (64-query tile, query
//     head, batch row); warp w owns query rows 16w..16w+15.
//   * Both products on the tensor cores with wgmma (bf16 in, float32
//     accumulate): q.k^T as m64n64k16 with q and k read from shared memory,
//     P.V as m64n{hd}k16 with P from registers and v read transposed from
//     shared memory. A warpgroup reads each k and v fragment once for its
//     64 rows, where mma.sync would read them once a warp of 16 rows and be
//     bound by shared-memory bandwidth (measured: PERF.md). Products of
//     bf16 values are exact in float32, so q.k differs from the reference's
//     float32 dot only in the order of the sum.
//   * P.V at the reference's precision: each float32 probability is split
//     into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both go through a
//     wgmma against the same bf16 v tile. That keeps about 16 bits of p
//     where one bf16 P (as FlashAttention rounds it) would add up to 2^-9
//     relative error a probability. Measured (PERF.md): one bf16 P is no
//     faster at the prefill's shapes and about 20 % faster past 1,000 keys,
//     but fails the per-launch check against the plain version.
//   * Softmax in registers: each thread keeps the running max and sum of
//     its two rows, the max reduced across the quad that shares a row; the
//     scale is applied inside the exponent (2^(q.k c - m c), c = scale *
//     log2 e), the accumulator is rescaled when the max moves, the quad's
//     partial sums are added once at the end and the output multiplied by
//     the reciprocal of max(l, 1e-30). Only the diagonal tile and the tile
//     holding S are masked.
//   * The tensor cores are kept busy while the softmax runs: q.k of tile
//     j + 1 and P.V of tile j are issued together, tile j + 1's softmax
//     runs while P.V does, and the last tile's P.V is peeled off the loop so
//     that no wgmma is issued under a condition (ptxas then does not
//     serialise them).
//   * Copies by TMA, issued by one thread: tensor maps over q, k and v read
//     in place through the caller's batch and sequence strides (no
//     transpose, no padding of S), with the row extent S, so rows at or past
//     S are zero-filled and never read, and what lies past S in the caller's
//     buffer cannot leak in. TMA writes the 128-byte swizzle wgmma reads. k
//     and v tiles of 64 keys go through two stages each, an mbarrier a
//     stage: the next v tile and the k tile after next load while a step
//     runs. TMA needs 16-byte aligned rows, so the wrapper refuses other
//     pointers and strides.
//   * CTAs start in order of their q tile's work (the tiles nearest S, with
//     the most kv tiles under causal masking, first) across all heads and
//     batch rows.
//   * Deterministic: no atomics, no split of the keys across CTAs or
//     warpgroups. A short grid (B = 1 with few heads) leaves SMs idle.
//   * Each warp stages its output rows in shared memory and stores them as
//     16-byte rows.
// float32 inputs (small test shapes, not on LISA-7B's path) take the online
// kernel on the CUDA cores (flash_online_kernel): the TPU kernel's running
// (m, l, acc) per row over kv tiles with one tile's scores in shared memory,
// within float32 summation order of the plain version. It is not redesigned.
// Both kernels take more than the 48 KB default of shared memory at
// hd = 128, so the launcher opts each instantiation in once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: the online kernel on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;          // queries per CTA
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Row pitch in floats of the q and kv tiles: HD + 4 (float4 reads of
// neighbouring rows fall on different banks); of the score tile kBK + 4.
template <int HD>
__host__ __device__ constexpr int tile_pitch() { return HD + 4; }
constexpr int kScorePitch = kBK + 4;

// q and kv tiles, one tile of scores, and m, l and alpha per row.
template <int HD>
constexpr size_t online_smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + kBK) * tile_pitch<HD>()
                          + (size_t)kBQ * kScorePitch + 3 * kBQ);
}

// Load rows [t0, t0 + rows) of a (.., S, heads, HD) operand into `dst`
// (rows x pitch floats), zeros at or past S.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long s_stride, int t0,
                                          int rows, int S) {
  constexpr int P = tile_pitch<HD>();
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r;
    dst[r * P + d] = t < S ? src[(long long)t * s_stride + d] : 0.f;
  }
}

// Scores of the CTA's rows ty*RPT + i against the kv tile's keys
// tx + 16*j, times scale, stored at s_s[row * kScorePitch + tx + 16*j].
template <int HD>
__device__ __forceinline__ void score_tile(const float* q_s,
                                           const float* kv_s, float* s_s,
                                           float scale) {
  constexpr int P = tile_pitch<HD>();
  constexpr int RPT = kBQ / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[RPT], c[4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = ld4(&q_s[(ty * RPT + i) * P + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = ld4(&kv_s[(tx + 16 * j) * P + d]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_s[(ty * RPT + i) * kScorePitch + tx + 16 * j] = s[i][j] * scale;
    }
  }
}

// acc += P.V over the tile's first n_keys keys, for rows ty*RPT + i and
// columns g*16*VW + tx*VW + e.
template <int HD>
__device__ __forceinline__ void pv_tile(float (&acc)[kBQ / 16][HD / 16],
                                        const float* p_s, const float* kv_s,
                                        int n_keys) {
  constexpr int P = tile_pitch<HD>();
  constexpr int RPT = kBQ / 16;
  constexpr int CPT = HD / 16;
  constexpr int VW = CPT < 4 ? CPT : 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int c = 0; c < n_keys; ++c) {
    float pp[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      pp[i] = p_s[(ty * RPT + i) * kScorePitch + c];
    }
    const float* vr = &kv_s[c * P + tx * VW];
#pragma unroll
    for (int g = 0; g < CPT / VW; ++g) {
      float vv[VW];
      if constexpr (VW == 4) {
        const float4 x = ld4(vr + g * 16 * VW);
        vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) vv[e] = vr[g * 16 * VW + e];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc[i][g * VW + e] = fmaf(pp[i], vv[e], acc[i][g * VW + e]);
        }
      }
    }
  }
}

// The TPU kernel's running (m, l, acc) per row over kv tiles, one tile's
// scores in shared memory at a time, for any S. q (B, S, H, HD), k/v
// (B, S, K, HD): unit stride over HD, stride HD over heads, batch and
// sequence strides as given (elements). out (B, S, H, HD) contiguous.
// Grid (ceil(S / kBQ), H, B).
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_online_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int S, int H, int K, long long q_sb, long long q_ss,
                    long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, float scale) {
  constexpr int P = tile_pitch<HD>();
  constexpr int RPT = kBQ / 16;
  constexpr int CPT = HD / 16;
  constexpr int VW = CPT < 4 ? CPT : 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // kBQ x P
  float* kv_s = q_s + kBQ * P;          // kBK x P: a k tile, then a v tile
  float* s_s = kv_s + kBK * P;          // kBQ x kScorePitch: scores/probs
  float* m_s = s_s + kBQ * kScorePitch; // kBQ: running max
  float* l_s = m_s + kBQ;               // kBQ: running sum
  float* a_s = l_s + kBQ;               // kBQ: this tile's rescale factor

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const float* kb = k + (long long)b * k_sb + (long long)kh * HD;
  const float* vb = v + (long long)b * v_sb + (long long)kh * HD;
  // keys [0, kv_end): with causal masking, the tiles wholly above the
  // diagonal of this q tile are skipped
  const int kv_end = CAUSAL ? min(q0 + kBQ, S) : S;

  load_tile<HD>(q_s, q + (long long)b * q_sb + (long long)h * HD, q_ss, q0,
                kBQ, S);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[RPT][HD / 16] = {};
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // kv_s and s_s are free
    load_tile<HD>(kv_s, kb, k_ss, k0, kBK, S);
    __syncthreads();
    score_tile<HD>(q_s, kv_s, s_s, scale);
    __syncthreads();                    // scores written, kv_s is free
    // warp w over rows w, w + kWarps, ...: keys past S, and after the
    // query when causal, masked with NEG_INF; m' = max(m, tile max),
    // p = exp(s - m'), alpha = exp(m - m'), l' = alpha l + sum p. Every
    // row sees key 0 in the first tile, so m' is finite from there on.
    for (int r = warp; r < kBQ; r += kWarps) {
      const int n = CAUSAL ? min(q0 + r + 1, S) : S;
      float* row = s_s + r * kScorePitch;
      const float x0 = k0 + lane < n ? row[lane] : kNegInf;
      const float x1 = k0 + lane + 32 < n ? row[lane + 32] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float l = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = fmaf(alpha, l_s[r], l);
        a_s[r] = alpha;
      }
    }
    load_tile<HD>(kv_s, vb, v_ss, k0, kBK, S);
    __syncthreads();                    // probs, alpha and the v tile
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] *= alpha;
    }
    pv_tile<HD>(acc, s_s, kv_s, min(kBK, kv_end - k0));
  }
  // row ty*RPT + i: acc / max(l, 1e-30); rows at or past S not written
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int t = q0 + r;
    if (t >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    float* o = out + (((long long)b * S + t) * H + h) * HD + tx * VW;
#pragma unroll
    for (int g = 0; g < CPT / VW; ++g) {
#pragma unroll
      for (int e = 0; e < VW; ++e) o[g * 16 * VW + e] = acc[i][g * VW + e] / l;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;          // rows of every tile: the CTA's queries,
                                   // the keys of a kv tile
constexpr int kWThreads = 128;     // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row tile in shared memory: blocks of 64 columns (128 bytes a row),
// each 64 rows x 128 bytes, 16-byte chunks swizzled within 8-row groups
// (chunk c of row r at c ^ (r % 8)), the layout wgmma reads with a
// 128-byte swizzle. At hd = 32 TMA fills the upper half of each row with
// zeros.
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * 128 * ((HD + 63) / 64);
}

// the q tile, two stages of k tiles and two of v tiles, the barriers, and
// 1 KB to align the first tile to the swizzle's 1,024-byte period
template <int HD>
constexpr size_t wg_smem_bytes() {
  return 1024 + 5 * ((size_t)tile_bytes<HD>() + 8);
}

// byte offset of element (row, col) in a tile
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 64) * (kTile * 128) + row * 128
         + ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Arm the barrier for `bytes` of copies; the one arrival completes its
// phase once they have landed.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Rows [t0, t0 + 64) of head `head`, batch row b, of a tensor map's
// operand into a tile: one box of 64 columns a 128-byte block (TMA writes
// the 128-byte swizzle itself; rows at or past S, and columns past hd,
// are zero-filled and not read).
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint32_t bar,
                                         int head, int t0, int b) {
  mbar_expect(bar, tile_bytes<HD>());
#pragma unroll
  for (int cb = 0; cb < (HD + 63) / 64; ++cb) {
    tma_load(smem_addr(dst + cb * kTile * 128), map, bar, cb * 64, head,
             t0, b);
  }
}

// The shared-memory matrix descriptor of wgmma: start address, leading
// and stride byte offsets, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major (q, k: hd contiguous): k-step kk's 16 columns. 8-row groups
// 1 KB apart; the leading offset is not read with this swizzle.
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile,
                                                int kk) {
  return smem_desc(tile + (kk / 4) * (kTile * 128) + (kk % 4) * 32, 16,
                   1024);
}

// MN-major (v read as keys x hd, hd contiguous): k-step kk's 16 keys;
// 64-column blocks 8 KB apart, 8-key groups 1 KB apart.
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile,
                                                 int kk) {
  return smem_desc(tile + kk * 16 * 128, kTile * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of wgmma are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's register
// operands across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
  }
}

// d (64 x 64) = a . b (+ d if accumulate): a (64 x 16) and b (64 x 16)
// both K-major in shared memory, by their descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) = a . b (+ d if accumulate): a (64 x 16) in registers,
// b (16 x 32) MN-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64) = a . b (+ d if accumulate): a (64 x 16) in registers,
// b (16 x 64) MN-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128) = a . b (+ d if accumulate): a (64 x 16) in registers,
// b (16 x 128) MN-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, b, 1);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, b, 1);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b, 1);
}

// 2^x (MUFU.EX2; results below 2^-126 flush to 0, against a largest
// probability of 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two float32 probabilities (the lower column first) as their bf16 high
// parts and the bf16 rounding of what remains, each pair by one
// conversion.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Mask and the online softmax of one tile's scores, in place: s[4n + e] is
// row row0 + (e / 2) * 8, key k0 + 8n + 2tq + e % 2, its q.k on entry and
// its probability exp(x - max x) on exit, x = q.k * scale. The scale is
// applied inside the exponent: with c = scale * log2(e), exp(x - m) =
// 2^(q.k c - m' c), where m' (m, updated here) is the rows' running max of
// q.k, NEG_INF where masked (2^(NEG_INF c) = 0). l (this thread's part of
// the rows' sums) is updated; returns the factor exp(m_old - m_new) for the
// rows' accumulator.
template <bool CAUSAL>
__device__ __forceinline__ float2 softmax_tile(float (&s)[32], float (&m)[2],
                                               float (&l)[2], float c,
                                               bool masked, int k0, int row0,
                                               int tq, int S) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * tq + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (key >= S || (CAUSAL && key > row)) s[i] = kNegInf;
    }
  }
  // the rows' maxima by a tree: t[e] over the scores with i % 4 == e
  float t[4] = {s[0], s[1], s[2], s[3]};
#pragma unroll
  for (int i = 4; i < 32; ++i) t[i % 4] = fmaxf(t[i % 4], s[i]);
  float mx[2] = {fmaxf(m[0], fmaxf(t[0], t[1])),
                 fmaxf(m[1], fmaxf(t[2], t[3]))};
  float alpha[2], mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2((m[r] - mx[r]) * c);
    m[r] = mx[r];
    mc[r] = m[r] * c;
    l[r] *= alpha[r];
  }
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    sum[i % 4] += s[i];
  }
  l[0] += sum[0] + sum[1];
  l[1] += sum[2] + sum[3];
  return make_float2(alpha[0], alpha[1]);
}

// s = q . k^T over the tile's hd / 16 k-steps (issued, not waited for)
template <int HD>
__device__ __forceinline__ void qk_wgmma(float (&s)[32],
                                         const unsigned char* q_tile,
                                         const unsigned char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_ss_n64(s, kmajor_desc(q_tile, kk), kmajor_desc(k_tile, kk),
                 kk > 0);
  }
}

// o += (p_hi + p_lo) . v over the tile's 4 k-steps of 16 keys (issued, not
// waited for)
template <int HD>
__device__ __forceinline__ void pv_wgmma(float (&o)[HD / 2],
                                         const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4],
                                         const unsigned char* v_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_pv<HD>(o, ph[kk], mnmajor_desc(v_tile, kk));
    wgmma_pv<HD>(o, pl[kk], mnmajor_desc(v_tile, kk));
  }
}

// o *= alpha of its row (rows +0, +8 by (i / 2) % 2), fenced for the
// P.V wgmma that follows
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float2 alpha) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= (i >> 1) & 1 ? alpha.y : alpha.x;
  fence_regs(o);
}

// The probabilities s as wgmma A fragments of p_hi and p_lo: k-step kk,
// fragment f holds rows +0 / +8 (f % 2) and keys 16kk + 2tq (+ 8 for
// f / 2).
__device__ __forceinline__ void to_fragments(const float (&s)[32],
                                             uint32_t (&ph)[4][4],
                                             uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = (2 * kk + f / 2) * 4 + (f % 2) * 2;
      split_pair(s[i], s[i + 1], ph[kk][f], pl[kk][f]);
    }
  }
}

// q, k and v through their tensor maps (tensor_map below), out (B, S, H,
// HD) contiguous. Grid (ceil(S / 64), H, B); one CTA of one warpgroup per
// 64-query tile. Warp w owns query rows 16w..16w+15.
//
// The loop keeps the tensor cores busy while the softmax runs: at step i
// the warpgroup issues q.k of tile i + 1 and P.V of tile i together,
// waits for the scores only, runs tile i + 1's softmax while P.V does, and
// only then waits for P.V. One thread issues the copies (TMA), each
// completing on its stage's barrier: at step i, v tile i + 1 and k tile
// i + 2, into the stages that tile i - 1 left.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWThreads, 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ out, int S, int H, int K,
                   float scale) {
  constexpr int TB = tile_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                   & 1023);
  // the modulo is a no-op on a 128-thread block, but tells ptxas that
  // tid < 128; without it the prefill's shapes run 5-9 % slower
  const int tid = threadIdx.x % kWThreads;
  // 2 k stages then 2 v stages; a tile in stage i % 2
  unsigned char* k_s = q_s + TB;
  unsigned char* v_s = k_s + 2 * TB;
  // barriers: the q tile's, then the k stages' and v stages'; a stage's
  // n-th tile completes its barrier's phase n % 2
  const uint32_t bar_q = smem_addr(q_s + 5 * TB);
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 16;

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;   // fragment row and column
  const bool leader = tid == 0;            // issues the copies
  // CTAs start in the order of their linear index; under causal masking
  // the q tiles nearest S have the most kv tiles, so the first H * B CTAs
  // take the last q tile of every (head, row), the next H * B the one
  // before, and so on
  const int hb_count = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y
                                            * blockIdx.z);
  const int q0 = (gridDim.x - 1 - lin / hb_count) * kTile;
  const int h = lin % hb_count % H;
  const int b = lin % hb_count / H;
  const int kh = h / (H / K);
  const int kv_end = CAUSAL ? min(q0 + kTile, S) : S;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int row0 = q0 + warp * 16 + g;     // this thread's rows: +0, +8
  // only the diagonal tile and the tile holding S need masking
  auto masked = [&](int k0) {
    return (CAUSAL && k0 + kTile > q0) || k0 + kTile > S;
  };
  // k or v tile i into its stage, and the wait for it
  auto load_kv = [&](const CUtensorMap* map, unsigned char* stages,
                     uint32_t bars, int i) {
    tma_tile<HD>(stages + (i & 1) * TB, map, bars + (i & 1) * 8, kh,
                 i * kTile, b);
  };
  auto wait_kv = [&](uint32_t bars, int i) {
    mbar_wait(bars + (i & 1) * 8, (i >> 1) & 1);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(bar_q + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (leader) {
    tma_tile<HD>(q_s, &tm_q, bar_q, h, q0, b);
    load_kv(&tm_k, k_s, bar_k, 0);
    load_kv(&tm_v, v_s, bar_v, 0);
    if (n_tiles > 1) load_kv(&tm_k, k_s, bar_k, 1);
  }

  float o[HD / 2];                 // 64 x HD accumulator
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}; // running max of rows row0, row0 + 8
  float l[2] = {0.f, 0.f};         // this thread's part of their sums
  const float c = scale * kLog2e;
  {
    float s[32] = {};              // 64 x 64 scores, then probabilities
    uint32_t ph[4][4], pl[4][4];   // p_hi, p_lo as wgmma A fragments
    // tile 0's scores and probabilities
    mbar_wait(bar_q, 0);
    wait_kv(bar_k, 0);
    fence_regs(s);
    wgmma_fence();
    qk_wgmma<HD>(s, q_s, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float2 alpha = softmax_tile<CAUSAL>(s, m, l, c, masked(0), 0, row0,
                                        tq, S);
    // step i: tile i's probabilities are in s, and o still waits for tile
    // i's rescale factor alpha
    for (int i = 0; i + 1 < n_tiles; ++i) {
      to_fragments(s, ph, pl);
      __syncthreads();             // every warp is done with tile i - 1
      if (leader) {
        load_kv(&tm_v, v_s, bar_v, i + 1);
        if (i + 2 < n_tiles) load_kv(&tm_k, k_s, bar_k, i + 2);
      }
      wait_kv(bar_k, i + 1);
      fence_regs(s);               // s = q . k^T of tile i + 1
      wgmma_fence();
      qk_wgmma<HD>(s, q_s, k_s + ((i + 1) & 1) * TB);
      wgmma_commit();
      fence_regs(s);
      rescale(o, alpha);           // o = alpha o + (p_hi + p_lo) . v
      fence_regs(ph);
      fence_regs(pl);
      wait_kv(bar_v, i);
      wgmma_fence();
      pv_wgmma<HD>(o, ph, pl, v_s + (i & 1) * TB);
      wgmma_commit();
      fence_regs(o);
      wgmma_wait<1>();             // the scores; P.V may still run
      fence_regs(s);
      const int k1 = (i + 1) * kTile;
      alpha = softmax_tile<CAUSAL>(s, m, l, c, masked(k1), k1, row0, tq, S);
      wgmma_wait<0>();
      fence_regs(o);
    }
    // the last tile's P.V
    to_fragments(s, ph, pl);
    rescale(o, alpha);
    fence_regs(ph);
    fence_regs(pl);
    wait_kv(bar_v, n_tiles - 1);
    wgmma_fence();
    pv_wgmma<HD>(o, ph, pl, v_s + ((n_tiles - 1) & 1) * TB);
    wgmma_commit();
    fence_regs(o);
    wgmma_wait<0>();
    fence_regs(o);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {    // the rows' sums
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // o times 1 / max(l, 1e-30), rounded once to bf16; each warp stages its
  // 16 rows in its rows of the q tile (no wgmma reads it any more) and
  // stores them as 16-byte rows
  l[0] = 1.f / fmaxf(l[0], 1e-30f);
  l[1] = 1.f / fmaxf(l[1], 1e-30f);
  __syncthreads();
  const int r0 = warp * 16;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(q_s + swz(r0 + g, col)) =
        __floats2bfloat162_rn(o[4 * n] * l[0], o[4 * n + 1] * l[0]);
    *reinterpret_cast<__nv_bfloat162*>(q_s + swz(r0 + g + 8, col)) =
        __floats2bfloat162_rn(o[4 * n + 2] * l[1], o[4 * n + 3] * l[1]);
  }
  __syncwarp();
  constexpr int CH = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = r0 + e / CH, c16 = e % CH;
    const int t = q0 + r;
    if (t < S) {
      *reinterpret_cast<uint4*>(out + (((long long)b * S + t) * H + h) * HD
                                + c16 * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz(r, c16 * 8));
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Opt `kernel` in to `bytes` of dynamic shared memory, once per
// instantiation.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

template <int HD, bool CAUSAL>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               int B, int S, int H, int K, long long q_sb, long long q_ss,
               long long k_sb, long long k_ss, long long v_sb,
               long long v_ss, float scale, cudaStream_t stream) {
  static bool opted_in = false;
  constexpr size_t bytes = online_smem_bytes<HD>();
  const cudaError_t err =
      opt_in(flash_online_kernel<HD, CAUSAL>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_online_kernel<HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, S, H, K, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The tensor map of a (B, S, heads, HD) bf16 operand read in place: dims
// (HD, heads, S, B) with the caller's sequence and batch strides, boxes of
// 64 columns x 64 rows of one head, 128-byte swizzle, zeros outside (rows
// at or past S, columns past HD).
template <int HD>
cudaError_t tensor_map(CUtensorMap* map, const bf16* base, int heads, int S,
                       int B, long long s_stride, long long b_stride) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * sizeof(bf16),
                                 (cuuint64_t)s_stride * sizeof(bf16),
                                 (cuuint64_t)b_stride * sizeof(bf16)};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, bool CAUSAL>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                int B, int S, int H, int K, long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long v_sb,
                long long v_ss, float scale, cudaStream_t stream) {
  // TMA reads 16-byte aligned rows: base pointers and strides must keep
  // them so (the wrapper refuses other layouts first)
  const long long strides = q_sb | q_ss | k_sb | k_ss | v_sb | v_ss;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q)
                         | reinterpret_cast<uintptr_t>(k)
                         | reinterpret_cast<uintptr_t>(v);
  if ((strides % 8) != 0 || (ptrs % 16) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = tensor_map<HD>(&tm_q, q, H, S, B, q_ss, q_sb);
  if (err == cudaSuccess) err = tensor_map<HD>(&tm_k, k, K, S, B, k_ss, k_sb);
  if (err == cudaSuccess) err = tensor_map<HD>(&tm_v, v, K, S, B, v_ss, v_sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in = false;
  constexpr size_t bytes = wg_smem_bytes<HD>();
  err = opt_in(flash_wgmma_kernel<HD, CAUSAL>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_wgmma_kernel<HD, CAUSAL><<<grid, kWThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, out, S, H, K, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool CAUSAL>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int dtype, int B, int S, int H, int K, long long q_sb,
                 long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, float scale,
                 cudaStream_t stream) {
  if (dtype == 0) {
    return launch_f32<HD, CAUSAL>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), B, S, H, K,
        q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
  }
  if (dtype == 1) {
    return launch_bf16<HD, CAUSAL>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), B, S, H, K,
        q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int dtype, int B, int S, int H, int K, int causal,
              long long q_sb, long long q_ss, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, float scale,
              cudaStream_t stream) {
  if (causal) {
    return launch_typed<HD, true>(q, k, v, out, dtype, B, S, H, K, q_sb,
                                  q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                  stream);
  }
  return launch_typed<HD, false>(q, k, v, out, dtype, B, S, H, K, q_sb, q_ss,
                                 k_sb, k_ss, v_sb, v_ss, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error of the launch (0 on success); the caller raises on anything
// else.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int H, int K, int hd, int causal, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, out, dtype, B, S, H, K, causal, q_sb,
                           q_ss, k_sb, k_ss, v_sb, v_ss, scale, s);
    case 64:
      return launch_hd<64>(q, k, v, out, dtype, B, S, H, K, causal, q_sb,
                           q_ss, k_sb, k_ss, v_sb, v_ss, scale, s);
    case 128:
      return launch_hd<128>(q, k, v, out, dtype, B, S, H, K, causal, q_sb,
                            q_ss, k_sb, k_ss, v_sb, v_ss, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
