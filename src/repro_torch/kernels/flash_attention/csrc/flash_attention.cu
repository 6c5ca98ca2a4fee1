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
// bf16 takes one of two kernels, by the launch plan the wrapper passes
// (kernels/flash_attention/ops.py:flash_plan, measured on the card:
// PERF.md §6). Both compute the same function to the same rounding; what
// they share comes first.
//
// flash_wgmma_kernel (one warpgroup a CTA; plan WGMMA):
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
//
// flash_ws_kernel (plans WS_HALVES and, where G is even, WS_PAIRS; kv
// tiles of 128 keys, of 96 at hd = 192): the same products, P
// split, softmax and copies, warp-specialised. What held the
// kernel above back at the wide head sizes and long sequences: its one
// warpgroup both copied and computed (thread 0 issued the TMA, a
// __syncthreads began every kv step), only its own P.V hid its softmax,
// and at hd = 192 (124 KB) an SM held one such CTA, so nothing ran while
// it did softmax; q.k as m64n64k16 reads 4 KB of shared memory for 32
// clocks of products, the SM's whole 128 bytes a clock.
//   * Three warpgroups a CTA. Warpgroup 2 is the producer: one thread
//     issues every TMA copy (the two q halves, then each kv tile's k and v
//     into a ring of two stages). Warpgroups 0 and 1 are the consumers, 64
//     query rows each, sharing every k and v tile: either two 64-row
//     halves of one head's 128-query tile, which works at any G (zamba2,
//     SAM and LLaMA-7B's heads have G = 1), or, where G is even, the same
//     64 rows of two query heads that read one kv head. Both were
//     measured (PERF.md §6): under causal masking both halves
//     walk the second half's extent, so the first, whose rows end 64 keys
//     earlier, computes up to one tile its mask zeroes, where two heads
//     share one extent; that took nemotron's prefill from 0.233 to 0.224
//     ms.
//   * No CTA-wide barrier after set-up. Each stage has a full barrier (the
//     producer's expected bytes, completed by TMA) and an empty one (one
//     arrival from each consumer once its products that read the stage
//     have completed); the producer waits on empty before it refills.
//   * setmaxnreg: the launch gives 168 registers a thread (384 x 168); the
//     producer drops to 40 and the consumers rise to 232, which holds
//     hd = 192's 96 accumulators, 48 scores and 48 words of p_hi / p_lo
//     without spilling (ptxas: PERF.md §6).
//   * Ping-pong: named barriers 1 and 2 order the consumers' turns. A
//     consumer waits for its turn, issues q.k of tile i + 1 and P.V of
//     tile i, and passes the turn; so one consumer's softmax, rescale and
//     hi/lo split run while the other's products occupy the tensor cores.
//     Within a consumer the overlap of the kernel above stays: tile
//     i + 1's softmax runs while its own P.V does, and the last P.V is
//     peeled off the loop, so no wgmma is issued under a condition.
//   * kv tiles of 128 keys (96 at hd = 192, where 128 would not fit the
//     registers): q.k as m64n128k16 (m64n96k16) reads 6 KB for 64 clocks
//     (5 KB for 48) of products.
//   * Both consumers walk the CTA's kv tiles. Letting the first of two
//     halves stop at its own extent was measured (PERF.md §6): the CTA
//     still ends with the second half's last tile, and the turns under a
//     condition cost 2-5 %.
//   * A 128-row tile at S = 1 or 65 leaves the second consumer's rows
//     wholly past S: TMA zero-fills them, they compute finite values, and
//     no row at or past S is written. Its mbarrier waits are bounded: a
//     copy or release that never comes traps (a launch error) rather than
//     hanging the card.
//   * An FP8 second product (p_lo against an FP8 copy of v, at twice the
//     bf16 rate) is not taken: p_lo is below 2^-9 of p, so FP8's range
//     needs it scaled, and a product at another scale needs its own
//     accumulator: hd / 2 more registers a thread, 96 at hd = 192.
//
// flash_tf32_kernel (float32: the reference's fp32 tests, lisa-mini and the
// float32 reduced configs under use_flash; plan TF32): split TF32 products
// on the tensor cores. The first float32 kernel, on the CUDA cores, reached
// 16 TFLOP/s, a quarter of their 67: every product an FFMA with shared memory
// read every few FMAs, copies through registers between four
// __syncthreads a tile, 32-row CTAs each streaming all of K and V.
//   * Precision: each float32 operand x = hi + lo, hi = tf32(x) and
//     lo = tf32(x - hi) (to nearest), each product hi.hi + hi.lo + lo.hi by
//     wgmma m64nNk8 .tf32 into one float32 accumulator: the dropped lo.lo
//     and lo's rounding stay below 2^-21 of a product, where one TF32
//     product keeps 2^-11 and misses the reference's fp32 tolerance
//     (PERF.md §6). Three products at 495 TFLOP/s make 165 TFLOP/s
//     of float32, 2.5x the CUDA cores' peak.
//   * tf32 wgmma reads its shared-memory operands K-major only. q.k fits
//     (q and k are hd-contiguous, K = hd); P.V does not (v lands keys x hd,
//     its K is keys). So a transform warpgroup beside the consumers splits
//     each landed k tile in place into its high part and its low part, and
//     writes v's high and low parts transposed (hd rows of keys, 128-byte
//     swizzle); a proxy fence and an mbarrier then hand the stage to the
//     consumers. Its thread 0 issues every TMA copy.
//   * P comes from registers. A thread holds keys 2tq and 2tq + 1 of each
//     8-key block where the tf32 A fragment wants columns tq and tq + 4,
//     so the transposed v keeps each 8-key block's keys in that order
//     (tf_key_pos) and P needs no shuffle.
//   * Shape by head size (TfShape): up to hd = 80 two consumer warpgroups
//     (two halves of a head's 128 rows, taking turns as flash_ws_kernel's
//     do) with q's high and low parts as A fragments in registers, so that
//     q.k reads only k's parts from shared memory; above, one consumer
//     with q's parts in shared memory. kv tiles of 64 keys at hd 32 and
//     64, of 32 elsewhere; two stages of k and v, one at hd = 192 (q, k, v
//     and their low parts take 216 KB there).
//   * Deterministic: no split of the keys across CTAs; CTAs in order of
//     their causal work, as flash_wgmma_kernel orders them.
// The kernels take more than the 48 KB default of shared memory at
// hd = 128, so the launcher opts each instantiation in once.
//
// Head sizes: 32, 64, 80, 112, 128 and 192 (every causal GQA config of the
// repo: zamba2-7b 112, nemotron-4-340b 192; SAM and hubert-xlarge 80). A
// bf16 tile is blocks of 64 columns and TMA zero-fills a box's columns past
// hd, so at hd = 80 and 112 the second block holds 16 or 48 real columns
// and zeros, and no column of the next head is read. q.k takes hd / 16
// k-steps; P.V one m64n{hd}k16 a k-step at the head size's own width,
// which reads its last block in part through the same descriptor, as
// hd = 32 already does; P.V at the padded width (n128 over the zero
// columns) would cost 1.6x / 1.14x the products at hd = 80 / 112. At
// hd = 192 a tile is three blocks, flash_wgmma_kernel takes 124 KB of
// shared memory (one CTA an SM) and flash_ws_kernel 193 KB, and the
// accumulator is 96 floats a thread. A float32 tile is blocks of 32
// columns (three at hd = 80, four at 112, zeros past hd), and the float32
// P.V runs in column slices of 64, 32 and 16 (80 = 64 + 16, 112 = 64 + 32 +
// 16).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// the shared memory a block may use on the H100 (227 KB); each launcher
// asserts its kernel's size against it
constexpr size_t kBlockSmem = 232448;

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;          // rows of every tile: the CTA's queries,
                                   // the keys of a kv tile
constexpr int kWThreads = 128;     // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// A tile of ROWS rows (64: a q tile or a kv tile of flash_wgmma_kernel) in
// shared memory: blocks of 64 columns (128 bytes a row), each ROWS rows x
// 128 bytes, 16-byte chunks swizzled within 8-row groups (chunk c of row r
// at c ^ (r % 8)), the layout wgmma reads with a 128-byte swizzle. At
// hd = 32 TMA fills the upper half of each row with zeros.
template <int HD, int ROWS = kTile>
__host__ __device__ constexpr int tile_bytes() {
  return ROWS * 128 * ((HD + 63) / 64);
}

// the q tile, two stages of k tiles and two of v tiles, the barriers, and
// 1 KB to align the first tile to the swizzle's 1,024-byte period
template <int HD>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return 1024 + 5 * ((size_t)tile_bytes<HD>() + 8);
}

// CTAs an SM holds: two while both fit in the 227 KB a block may use (up
// to hd = 128: 2 x 83 KB); at hd = 192 one (124 KB). With 128 threads the
// register cap is 255 either way.
template <int HD>
__host__ __device__ constexpr int wg_ctas_per_sm() {
  return 2 * wg_smem_bytes<HD>() <= kBlockSmem ? 2 : 1;
}

// byte offset of element (row, col) in a tile
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 64) * (kTile * 128) + row * 128
         + ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier whose phase completes after `count` arrivals (and the bytes
// armed with mbar_expect)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// The same wait, bounded: after 2^26 polls that find the phase open it
// traps, so a fault in the warp-specialised kernel's protocol ends the
// launch with an error instead of hanging the card. A poll returns within
// the hardware's suspend window, so the bound is seconds, far past any
// copy or product a CTA waits for.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nadd.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n@p bra.uni WAIT;\ntrap;\nDONE:\n}\n"
      ::"r"(bar), "r"(parity)
      : "memory");
}

// named barrier `id` of N threads: wait for all N, or count these threads
// in without waiting
template <int N>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
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

// Rows [t0, t0 + ROWS) of head `head`, batch row b, of a tensor map's
// operand (boxes of ROWS rows) into a tile: one box of COLS columns (64
// bf16 or 32 float32) a 128-byte block (TMA writes the 128-byte swizzle
// itself; rows at or past S, and columns past hd, are zero-filled and not
// read).
template <int HD, int ROWS = kTile, int COLS = 64>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint32_t bar,
                                         int head, int t0, int b) {
  constexpr int blocks = (HD + COLS - 1) / COLS;
  mbar_expect(bar, ROWS * 128 * blocks);
#pragma unroll
  for (int cb = 0; cb < blocks; ++cb) {
    tma_load(smem_addr(dst + cb * ROWS * 128), map, bar, cb * COLS, head,
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

// K-major (q, k: hd contiguous) in a tile of ROWS rows: k-step kk's 16
// columns. 8-row groups 1 KB apart; the leading offset is not read with
// this swizzle.
template <int ROWS = kTile>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile,
                                                int kk) {
  return smem_desc(tile + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16,
                   1024);
}

// MN-major (v read as keys x hd, hd contiguous) in a tile of ROWS keys:
// k-step kk's 16 keys; 64-column blocks ROWS x 128 bytes apart, 8-key
// groups 1 KB apart.
template <int ROWS = kTile>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile,
                                                 int kk) {
  return smem_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
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

// d (64 x 96) = a . b (+ d if accumulate): a (64 x 16) and b (96 x 16)
// both K-major in shared memory, by their descriptors
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) = a . b (+ d if accumulate): a (64 x 16) and b (128 x 16)
// both K-major in shared memory, by their descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// q . k^T for a kv tile of BN keys: m64n{BN}k16, both from shared memory
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (BN == 64) wgmma_ss_n64(d, a, b, accumulate);
  if constexpr (BN == 96) wgmma_ss_n96(d, a, b, accumulate);
  if constexpr (BN == 128) wgmma_ss_n128(d, a, b, accumulate);
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

// d (64 x 80) = a . b (+ d if accumulate): a (64 x 16) in registers,
// b (16 x 80) MN-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 112) = a . b (+ d if accumulate): a (64 x 16) in registers,
// b (16 x 112) MN-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
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
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 192) = a . b (+ d if accumulate): a (64 x 16) in registers,
// b (16 x 192) MN-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// o += p . v at the head size's own width: m64n{HD}k16. At hd = 80 and 112
// the instruction reads one whole 64-column block of v and part of the
// next (16 or 48 of its columns), through the same descriptor (blocks 8 KB
// apart); hd = 32 already reads part of one block that way.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, b, 1);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, b, 1);
  if constexpr (HD == 80) wgmma_rs_n80(d, a, b, 1);
  if constexpr (HD == 112) wgmma_rs_n112(d, a, b, 1);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b, 1);
  if constexpr (HD == 192) wgmma_rs_n192(d, a, b, 1);
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

// Mask and the online softmax of one tile's scores (BN keys), in place:
// s[4n + e] is row row0 + (e / 2) * 8, key k0 + 8n + 2tq + e % 2, its q.k
// on entry and
// its probability exp(x - max x) on exit, x = q.k * scale. The scale is
// applied inside the exponent: with c = scale * log2(e), exp(x - m) =
// 2^(q.k c - m' c), where m' (m, updated here) is the rows' running max of
// q.k, NEG_INF where masked (2^(NEG_INF c) = 0). l (this thread's part of
// the rows' sums) is updated; returns the factor exp(m_old - m_new) for the
// rows' accumulator.
template <bool CAUSAL, int BN = kTile>
__device__ __forceinline__ float2 softmax_tile(float (&s)[BN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float c, bool masked, int k0,
                                               int row0, int tq, int S) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * tq + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (key >= S || (CAUSAL && key > row)) s[i] = kNegInf;
    }
  }
  // the rows' maxima by a tree: t[e] over the scores with i % 4 == e
  float t[4] = {s[0], s[1], s[2], s[3]};
#pragma unroll
  for (int i = 4; i < BN / 2; ++i) t[i % 4] = fmaxf(t[i % 4], s[i]);
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
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
    sum[i % 4] += s[i];
  }
  l[0] += sum[0] + sum[1];
  l[1] += sum[2] + sum[3];
  return make_float2(alpha[0], alpha[1]);
}

// s = q . k^T over the tile's hd / 16 k-steps, a 64-row q tile against a
// kv tile of BN keys (issued, not waited for)
template <int HD, int BN = kTile>
__device__ __forceinline__ void qk_wgmma(float (&s)[BN / 2],
                                         const unsigned char* q_tile,
                                         const unsigned char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_qk<BN>(s, kmajor_desc(q_tile, kk), kmajor_desc<BN>(k_tile, kk),
                 kk > 0);
  }
}

// o += (p_hi + p_lo) . v over the tile's BN / 16 k-steps of 16 keys
// (issued, not waited for)
template <int HD, int BN = kTile>
__device__ __forceinline__ void pv_wgmma(float (&o)[HD / 2],
                                         const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4],
                                         const unsigned char* v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    wgmma_pv<HD>(o, ph[kk], mnmajor_desc<BN>(v_tile, kk));
    wgmma_pv<HD>(o, pl[kk], mnmajor_desc<BN>(v_tile, kk));
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
template <int BN = kTile>
__device__ __forceinline__ void to_fragments(const float (&s)[BN / 2],
                                             uint32_t (&ph)[BN / 16][4],
                                             uint32_t (&pl)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
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
__global__ void __launch_bounds__(kWThreads, wg_ctas_per_sm<HD>())
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
// bf16, warp-specialised: a producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWsRows = 128;       // query rows a CTA: 64 a consumer
constexpr int kWsThreads = 384;    // consumer warpgroups 0 and 1, producer 2
// setmaxnreg: the launch gives every thread 168 registers (65,536 / 384);
// the producer gives most of its share to the consumers: 128 x 40 +
// 256 x 232 = 384 x 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// the q tile (two 64-row halves), ST stages of k tiles and ST of v tiles
// (BN rows each), the barriers (q halves; k and v full; k and v empty),
// and 1 KB to align the first tile to the swizzle's period
template <int HD, int BN, int ST>
__host__ __device__ constexpr size_t ws_smem_bytes() {
  return 1024 + 2 * (size_t)tile_bytes<HD>()
         + 2 * ST * (size_t)tile_bytes<HD, BN>() + 8 * (2 + 4 * ST);
}

// Keys a kv tile of flash_ws_kernel holds: 128, so that q.k runs as
// m64n128k16 (its two operands 6 KB of shared memory for 64 clocks of
// products, where m64n64k16's 4 KB for 32 clocks is the SM's whole 128
// bytes a clock); at hd = 192 96, which keeps a consumer's 96 accumulators,
// 48 scores and 48 words of p_hi / p_lo under its 232 registers.
template <int HD>
__host__ __device__ constexpr int ws_kv_rows() {
  return HD == 192 ? 96 : 128;
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// q, k and v through their tensor maps, out (B, S, H, HD) contiguous. The
// two consumers take two 64-row halves of one head's 128-query tile (grid
// (ceil(S / 128), H, B)), or with HEADS the same 64 query rows of two
// heads that read one kv head (G even; grid (ceil(S / 64), H / 2, B)).
//
// Warpgroup 2 is the producer: after giving up its registers, one thread
// loads the two q halves and then, for each kv tile i, k tile i and v tile
// i into stage i % ST, each after both consumers have given that stage
// back (its empty barrier, two arrivals) and each completing its stage's
// full barrier (TMA's bytes). Warpgroups 0 and 1 are the consumers, 64
// query rows each, warp v of a consumer rows 16v.. + 15 of those. Both
// walk the same kv tiles: of two halves, the CTA's causal extent is the
// second half's, so the first computes at most one tile that its mask
// zeroes; that keeps every wgmma out of conditional code and both
// consumers in step. Two heads share their rows and so their extent.
// Each consumer runs flash_wgmma_kernel's overlap within itself (q.k of
// tile i + 1 beside P.V of tile i; the softmax of tile i + 1 while P.V
// runs; the last P.V peeled), and the two take turns issuing their
// products through two
// named barriers: consumer w waits on barrier 1 + w, issues q.k and P.V,
// then arrives on the other's. So one consumer's softmax, rescale and
// hi/lo split run while the other's products occupy the tensor cores.
template <int HD, bool CAUSAL, int BN, int ST, bool HEADS>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ out, int S, int H, int K, float scale) {
  constexpr int TB = tile_bytes<HD>();       // a q half
  constexpr int KB = tile_bytes<HD, BN>();   // a k or v tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                   & 1023);
  unsigned char* k_s = q_s + 2 * TB;     // ST k stages, then ST v stages
  unsigned char* v_s = k_s + ST * KB;
  // barriers: the q halves', then full k, full v, empty k, empty v (ST
  // each); a stage's n-th tile completes its barriers' phase n % 2
  const uint32_t bar_q = smem_addr(v_s + ST * KB);
  const uint32_t full_k = bar_q + 16, full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST, empty_v = empty_k + 8 * ST;

  // the q tiles nearest S first, as flash_wgmma_kernel orders them
  const int hb_count = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y
                                            * blockIdx.z);
  constexpr int kRows = HEADS ? kTile : kWsRows;  // rows of each head
  const int q0 = (gridDim.x - 1 - lin / hb_count) * kRows;
  const int h = (lin % hb_count % gridDim.y) * (HEADS ? 2 : 1);  // first
  const int b = lin % hb_count / gridDim.y;
  const int kh = h / (H / K);
  const int kv_end = CAUSAL ? min(q0 + kRows, S) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2 + 2 * ST; ++i) mbar_init(bar_q + 8 * i, 1);
#pragma unroll
    for (int i = 0; i < 2 * ST; ++i) mbar_init(empty_k + 8 * i, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      tma_tile<HD>(q_s, &tm_q, bar_q, h, q0, b);
      tma_tile<HD>(q_s + TB, &tm_q, bar_q + 8, HEADS ? h + 1 : h,
                   HEADS ? q0 : q0 + kTile, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % ST;
        // the stage's previous tile, i - ST, completed empty phase
        // (i / ST - 1) % 2
        const uint32_t parity = ((i / ST) & 1) ^ 1;
        if (i >= ST) mbar_wait_bounded(empty_k + 8 * st, parity);
        tma_tile<HD, BN>(k_s + st * KB, &tm_k, full_k + 8 * st, kh, i * BN,
                         b);
        if (i >= ST) mbar_wait_bounded(empty_v + 8 * st, parity);
        tma_tile<HD, BN>(v_s + st * KB, &tm_v, full_v + 8 * st, kh, i * BN,
                         b);
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    // the modulo tells ptxas that tid < 128 (see flash_wgmma_kernel)
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;   // fragment row and column
    unsigned char* q_w = q_s + wg * TB;      // this consumer's q half
    const int rows0 = HEADS ? q0 : q0 + wg * kTile;
    const int hw = HEADS ? h + wg : h;       // this consumer's head
    const int row0 = rows0 + warp * 16 + g;  // this thread's rows: +0, +8
    auto masked = [&](int k0) {
      return (CAUSAL && k0 + BN > rows0) || k0 + BN > S;
    };
    auto wait_full = [&](uint32_t bars, int i) {
      mbar_wait_bounded(bars + (i % ST) * 8, (i / ST) & 1);
    };
    // one arrival a consumer, after its wait for the products that read
    // the stage
    auto release = [&](uint32_t bars, int i) {
      if (tid == 0) mbar_arrive(bars + (i % ST) * 8);
    };
    // the turns: consumer 0 issues first; every turn taken is passed on,
    // but consumer 1's last, which no turn of consumer 0 waits for
    auto take_turn = [&] { bar_sync<256>(1 + wg); };
    auto pass_turn = [&] { bar_arrive<256>(2 - wg); };
    if (wg == 1) pass_turn();

    float o[HD / 2];                 // 64 x HD accumulator
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}; // running max of rows row0, row0 + 8
    float l[2] = {0.f, 0.f};         // this thread's part of their sums
    const float c = scale * kLog2e;
    {
      float s[BN / 2] = {};          // 64 x BN scores, then probabilities
      // p_hi, p_lo as wgmma A fragments
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
      // tile 0's scores and probabilities
      mbar_wait_bounded(bar_q + 8 * wg, 0);
      wait_full(full_k, 0);
      take_turn();
      fence_regs(s);
      wgmma_fence();
      qk_wgmma<HD, BN>(s, q_w, k_s);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k, 0);
      float2 alpha = softmax_tile<CAUSAL, BN>(s, m, l, c, masked(0), 0,
                                              row0, tq, S);
      // step i: tile i's probabilities are in s, and o still waits for
      // tile i's rescale factor alpha
      for (int i = 0; i + 1 < n_tiles; ++i) {
        to_fragments<BN>(s, ph, pl);
        rescale(o, alpha);
        fence_regs(ph);
        fence_regs(pl);
        wait_full(full_k, i + 1);
        wait_full(full_v, i);
        take_turn();
        fence_regs(s);               // s = q . k^T of tile i + 1
        wgmma_fence();
        qk_wgmma<HD, BN>(s, q_w, k_s + ((i + 1) % ST) * KB);
        wgmma_commit();
        fence_regs(s);
        pv_wgmma<HD, BN>(o, ph, pl, v_s + (i % ST) * KB);
        wgmma_commit();
        pass_turn();
        fence_regs(o);
        wgmma_wait<1>();             // the scores; P.V may still run
        fence_regs(s);
        release(empty_k, i + 1);
        const int k1 = (i + 1) * BN;
        alpha = softmax_tile<CAUSAL, BN>(s, m, l, c, masked(k1), k1, row0,
                                         tq, S);
        wgmma_wait<0>();
        fence_regs(o);
        release(empty_v, i);
      }
      // the last tile's P.V
      to_fragments<BN>(s, ph, pl);
      rescale(o, alpha);
      fence_regs(ph);
      fence_regs(pl);
      wait_full(full_v, n_tiles - 1);
      take_turn();
      wgmma_fence();
      pv_wgmma<HD, BN>(o, ph, pl, v_s + ((n_tiles - 1) % ST) * KB);
      wgmma_commit();
      if (wg == 0) pass_turn();
      fence_regs(o);
      wgmma_wait<0>();
      fence_regs(o);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // the rows' sums
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    // o times 1 / max(l, 1e-30), rounded once to bf16; once the whole
    // consumer is done with its q half, each warp stages its 16 rows there
    // and stores them as 16-byte rows
    l[0] = 1.f / fmaxf(l[0], 1e-30f);
    l[1] = 1.f / fmaxf(l[1], 1e-30f);
    bar_sync<128>(3 + wg);
    const int r0 = warp * 16;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(q_w + swz(r0 + g, col)) =
          __floats2bfloat162_rn(o[4 * n] * l[0], o[4 * n + 1] * l[0]);
      *reinterpret_cast<__nv_bfloat162*>(q_w + swz(r0 + g + 8, col)) =
          __floats2bfloat162_rn(o[4 * n + 2] * l[1], o[4 * n + 3] * l[1]);
    }
    __syncwarp();
    constexpr int CH = HD / 8;
#pragma unroll
    for (int i = 0; i < 16 * CH / 32; ++i) {
      const int e = lane + 32 * i;
      const int r = r0 + e / CH, c16 = e % CH;
      const int t = rows0 + r;
      if (t < S) {
        *reinterpret_cast<uint4*>(out + (((long long)b * S + t) * H + hw)
                                  * HD + c16 * 8) =
            *reinterpret_cast<const uint4*>(q_w + swz(r, c16 * 8));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

// The float32 kernel's shape at head size HD: C consumer warpgroups of 64
// query rows each (two halves of one head's 128 rows, or one), BN keys a kv
// tile, ST stages of k tiles and ST of v tiles. Its shared memory holds,
// besides the stages, q's tf32 high and low parts and v's landing tile, so
// the wide head sizes take one consumer and fewer or narrower tiles (the
// launcher asserts the fit against kBlockSmem).
template <int HD>
struct TfShape {
  static constexpr int C = HD <= 80 ? 2 : 1;
  static constexpr int BN = HD == 32 || HD == 64 ? 64 : 32;
  static constexpr int ST = HD == 192 ? 1 : 2;
  // q's high and low parts as A fragments in registers (hd words a thread)
  // rather than in shared memory: q.k then reads only k's parts there
  static constexpr bool QREG = C == 2;
};

// a float32 tile of ROWS rows: blocks of 32 columns, each ROWS rows x 128
// bytes with wgmma's 128-byte swizzle (tile_bytes' layout, 32 float32
// columns a block); columns past HD zero
template <int HD, int ROWS>
__host__ __device__ constexpr int tf_tile_bytes() {
  return ROWS * 128 * ((HD + 31) / 32);
}

// q's high and low parts for each consumer; ST stages of k's high and low
// parts (BN rows each); ST stages of v's high and low parts transposed
// (HD rows of BN keys each, K-major for P.V); v's landing tile; the
// barriers; and 1 KB to align the first tile to the swizzle's period
template <int HD>
__host__ __device__ constexpr size_t tf32_smem_bytes() {
  using T = TfShape<HD>;
  return 1024 + 2 * T::C * (size_t)tf_tile_bytes<HD, kTile>()
         + (2 * T::ST + 1) * (size_t)tf_tile_bytes<HD, T::BN>()
         + 2 * T::ST * (size_t)HD * T::BN * 4
         + 8 * (T::C + 5 * T::ST + 1);
}

// setmaxnreg where C = 2: the launch gives every thread 168 registers
// (65,536 / 384); the transform warpgroup keeps 56 and the consumers rise to
// 224 (128 x 56 + 256 x 224 = 384 x 168). With C = 1 (256 threads) each
// thread may take 255.
constexpr int kTfTransformRegs = 56;
constexpr int kTfConsumerRegs = 224;

// threads a CTA: the consumers and one transform warpgroup
template <int HD>
__host__ __device__ constexpr int tf_threads() {
  return 128 * (TfShape<HD>::C + 1);
}

// byte offset of element (row, col) in a float32 tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ int swz_f32(int row, int col) {
  return (col / 32) * (ROWS * 128) + row * 128
         + ((((col % 32) / 4) ^ (row % 8)) * 16) + (col % 4) * 4;
}

// x rounded to tf32 (to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds): half a unit of the 13 dropped bits added to the magnitude bits,
// then those bits cleared. Two integer operations; the conversion
// instruction gave the same words 10-12 % slower at every timed shape
// (PERF.md §6).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (below 2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// p, hidden from the compiler at this point: the wgmma descriptors derived
// from it are computed where a kv step uses them, not hoisted out of the kv
// loop and held in registers (at hd = 192, with one stage, every q, k and v
// descriptor is loop-invariant, and holding them spilled 360 bytes)
template <typename P>
__device__ __forceinline__ P* opaque(P* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// order the generic proxy's shared-memory writes of this thread before the
// async proxy's (wgmma, TMA) accesses that follow a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 32) = a . b (+ d if accumulate), tf32: a (64 x 8) and b (32 x 8)
// both K-major in shared memory, by their descriptors
__device__ __forceinline__ void wgmma_tf32_ss_n32(float* d, uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = a . b (+ d if accumulate), tf32: a (64 x 8) and b (64 x 8)
// both K-major in shared memory, by their descriptors
__device__ __forceinline__ void wgmma_tf32_ss_n64(float* d, uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16) = a . b (+ d if accumulate), tf32: a (64 x 8) in registers,
// b (16 x 8) K-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_tf32_rs_n16(float* d,
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 32) = a . b (+ d if accumulate), tf32: a (64 x 8) in registers,
// b (32 x 8) K-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_tf32_rs_n32(float* d,
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 64) = a . b (+ d if accumulate), tf32: a (64 x 8) in registers,
// b (64 x 8) K-major in shared memory, by its descriptor
__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d,
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t a,
                                              uint64_t b, int accumulate) {
  if constexpr (N == 32) wgmma_tf32_ss_n32(d, a, b, accumulate);
  if constexpr (N == 64) wgmma_tf32_ss_n64(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d,
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  if constexpr (N == 16) wgmma_tf32_rs_n16(d, a, b, accumulate);
  if constexpr (N == 32) wgmma_tf32_rs_n32(d, a, b, accumulate);
  if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, b, accumulate);
}

// s = q . k^T over hd / 8 k-steps: q_hi.k_hi + q_hi.k_lo + q_lo.k_hi, a
// 64-row q tile against a kv tile of BN keys, one float32 accumulator
// (issued, not waited for)
template <int HD, int BN>
__device__ __forceinline__ void qk_tf32(float (&s)[BN / 2],
                                        const unsigned char* q_hi,
                                        const unsigned char* q_lo,
                                        const unsigned char* k_hi,
                                        const unsigned char* k_lo) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint64_t qh = kmajor_desc(q_hi, kk), ql = kmajor_desc(q_lo, kk);
    const uint64_t kh = kmajor_desc<BN>(k_hi, kk);
    wgmma_tf32_ss<BN>(s, qh, kh, kk > 0);
    wgmma_tf32_ss<BN>(s, qh, kmajor_desc<BN>(k_lo, kk), 1);
    wgmma_tf32_ss<BN>(s, ql, kh, 1);
  }
}

// The same with q's parts as A fragments in registers (q_fragments)
template <int HD, int BN>
__device__ __forceinline__ void qk_tf32(float (&s)[BN / 2],
                                        const uint32_t (&qh)[HD / 8][4],
                                        const uint32_t (&ql)[HD / 8][4],
                                        const unsigned char* k_hi,
                                        const unsigned char* k_lo) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const uint64_t kh = kmajor_desc<BN>(k_hi, kk);
    wgmma_tf32_rs<BN>(s, qh[kk], kh, kk > 0);
    wgmma_tf32_rs<BN>(s, qh[kk], kmajor_desc<BN>(k_lo, kk), 1);
    wgmma_tf32_rs<BN>(s, ql[kk], kh, 1);
  }
}

// A warp's 16 rows (r0 = 16 warp) of a landed 64-row q tile as the tf32 A
// fragments of its high and low parts: k-step kk, fragment f holds row
// r0 + g (+ 8 for f odd), column 8kk + tq (+ 4 for f >= 2)
template <int HD>
__device__ __forceinline__ void q_fragments(const unsigned char* q_tile,
                                            int r0, int g, int tq,
                                            uint32_t (&qh)[HD / 8][4],
                                            uint32_t (&ql)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = r0 + g + (f & 1) * 8, col = 8 * kk + tq + (f >> 1) * 4;
      split_tf32(*reinterpret_cast<const float*>(
                     q_tile + swz_f32<kTile>(row, col)),
                 qh[kk][f], ql[kk][f]);
    }
  }
}

// o[D0 / 2 ..] += (p_hi + p_lo) . (v_hi + v_lo) without p_lo . v_lo, for
// k-step kk of 8 keys, over columns D0.. of HD in slices of 64, 32 and 16
// (so every head size is whole slices: 80 = 64 + 16, 112 = 64 + 32 + 16)
template <int HD, int BN, int D0 = 0>
__device__ __forceinline__ void pv_tf32_step(float (&o)[HD / 2],
                                             const uint32_t (&ph)[4],
                                             const uint32_t (&pl)[4],
                                             const unsigned char* v_hi,
                                             const unsigned char* v_lo,
                                             int kk) {
  if constexpr (D0 < HD) {
    constexpr int N = HD - D0 >= 64 ? 64 : HD - D0 >= 32 ? 32 : 16;
    const uint64_t vh = kmajor_desc<HD>(v_hi + D0 * 128, kk);
    const uint64_t vl = kmajor_desc<HD>(v_lo + D0 * 128, kk);
    float* d = o + D0 / 2;
    if constexpr (N == 64) {
      wgmma_tf32_rs_n64(d, ph, vh, 1);
      wgmma_tf32_rs_n64(d, ph, vl, 1);
      wgmma_tf32_rs_n64(d, pl, vh, 1);
    } else if constexpr (N == 32) {
      wgmma_tf32_rs_n32(d, ph, vh, 1);
      wgmma_tf32_rs_n32(d, ph, vl, 1);
      wgmma_tf32_rs_n32(d, pl, vh, 1);
    } else {
      wgmma_tf32_rs_n16(d, ph, vh, 1);
      wgmma_tf32_rs_n16(d, ph, vl, 1);
      wgmma_tf32_rs_n16(d, pl, vh, 1);
    }
    pv_tf32_step<HD, BN, D0 + N>(o, ph, pl, v_hi, v_lo, kk);
  }
}

// o += P . V over the tile's BN / 8 k-steps (issued, not waited for)
template <int HD, int BN>
__device__ __forceinline__ void pv_tf32(float (&o)[HD / 2],
                                        const uint32_t (&ph)[BN / 8][4],
                                        const uint32_t (&pl)[BN / 8][4],
                                        const unsigned char* v_hi,
                                        const unsigned char* v_lo) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    pv_tf32_step<HD, BN>(o, ph[kk], pl[kk], v_hi, v_lo, kk);
  }
}

// The probabilities s as tf32 A fragments of p_hi and p_lo. A thread holds
// keys 2tq and 2tq + 1 of each 8-key block j (s[4j + e], rows +0 / +8 by
// e / 2), where the A fragment wants columns tq and tq + 4; so column c of
// k-step j is key 2c (c < 4) or 2(c - 4) + 1, and v's transposed tiles keep
// the keys of each 8-key block in that order (tf_key_pos).
template <int BN>
__device__ __forceinline__ void tf32_fragments(const float (&s)[BN / 2],
                                               uint32_t (&ph)[BN / 8][4],
                                               uint32_t (&pl)[BN / 8][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    split_tf32(s[4 * j], ph[j][0], pl[j][0]);
    split_tf32(s[4 * j + 2], ph[j][1], pl[j][1]);
    split_tf32(s[4 * j + 1], ph[j][2], pl[j][2]);
    split_tf32(s[4 * j + 3], ph[j][3], pl[j][3]);
  }
}

// the column of key r of a kv tile in v's transposed tiles (tf32_fragments)
__device__ __forceinline__ int tf_key_pos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// Split a landed float32 tile of `bytes` bytes in place into its tf32 high
// part, and its low part into `lo` (the same layout), by one warpgroup's
// 128 threads (t = 0..127), 16 bytes a thread at a time.
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo, int bytes,
                                           int t) {
  for (int e = t; e < bytes / 16; e += 128) {
    float4* h = reinterpret_cast<float4*>(hi) + e;
    const float4 x = *h;
    uint32_t a[4], b[4];
    split_tf32(x.x, a[0], b[0]);
    split_tf32(x.y, a[1], b[1]);
    split_tf32(x.z, a[2], b[2]);
    split_tf32(x.w, a[3], b[3]);
    *reinterpret_cast<uint4*>(h) = make_uint4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<uint4*>(lo)[e] = make_uint4(b[0], b[1], b[2], b[3]);
  }
}

// Split v's landed tile (BN keys x HD, swizzled float32 blocks) into its
// tf32 high and low parts transposed: HD rows of BN keys, K-major for the
// P.V wgmma, each 8-key block in tf_key_pos order. Warp w of the
// transform warpgroup takes units w, w + 4, ... of (32 keys, 4 columns);
// its lane reads one key's 16 bytes and writes 4 rows, the warp's 32
// writes of a row to 32 banks.
template <int HD, int BN>
__device__ __forceinline__ void transpose_v(const unsigned char* land,
                                            unsigned char* v_hi,
                                            unsigned char* v_lo, int t) {
  const int warp = t / 32, lane = t % 32;
  for (int u = warp; u < (BN / 32) * (HD / 4); u += 4) {
    const int r = (u / (HD / 4)) * 32 + lane, c = (u % (HD / 4)) * 4;
    const float4 x =
        *reinterpret_cast<const float4*>(land + swz_f32<BN>(r, c));
    const int p = tf_key_pos(r);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split_tf32(xs[e], hi, lo);
      const int off = swz_f32<HD>(c + e, p);
      *reinterpret_cast<uint32_t*>(v_hi + off) = hi;
      *reinterpret_cast<uint32_t*>(v_lo + off) = lo;
    }
  }
}

// q, k and v (float32) through their tensor maps (tensor_map below, boxes
// of 32 columns), out (B, S, H, HD) contiguous. Grid (ceil(S / 64C), H, B)
// with C = TfShape<HD>::C consumers, q tiles nearest S first.
//
// Warpgroup C is the transform warpgroup. Its thread 0 issues every TMA
// copy: the consumers' q tiles, k tile i into k stage i % ST (after both
// consumers have released the stage's previous tile) and v tile i into the
// one landing tile. All its 128 threads then, for each kv tile i, split k
// in place into its tf32 high part and its low part, and split v into its
// high and low parts transposed into v stage i % ST (after its previous
// tile's release), each followed by a proxy fence and one arrival on the
// stage's ready barrier. Warpgroups 0 .. C - 1 are the consumers: each
// splits its q tile once, then runs flash_ws_kernel's loop on split TF32
// products (q.k of tile i + 1 beside P.V of tile i, the softmax of tile
// i + 1 while P.V runs, the last P.V peeled), taking turns through named
// barriers 1 / 2 where C = 2, and releasing k stage i + 1 after its q.k and
// v stage i after its P.V.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(tf_threads<HD>(), 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  float* __restrict__ out, int S, int H, int K,
                  float scale) {
  using T = TfShape<HD>;
  constexpr int C = T::C, BN = T::BN, ST = T::ST;
  constexpr int QB = tf_tile_bytes<HD, kTile>();   // a q part
  constexpr int KB = tf_tile_bytes<HD, BN>();      // a k part, the landing
  constexpr int VB = HD * BN * 4;                  // a transposed v part
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                   & 1023);
  unsigned char* k_s = q_s + 2 * C * QB;   // stage j: hi at 2j, lo at 2j + 1
  unsigned char* v_s = k_s + 2 * ST * KB;
  unsigned char* land = v_s + 2 * ST * VB;
  // barriers: the q tiles'; k full, k ready, k empty (ST each); v landed;
  // v ready, v empty (ST each). A stage's n-th tile completes its
  // barriers' phase n % 2.
  const uint32_t bar_q = smem_addr(land + KB);
  const uint32_t k_full = bar_q + 8 * C, k_ready = k_full + 8 * ST;
  const uint32_t k_empty = k_ready + 8 * ST, v_land = k_empty + 8 * ST;
  const uint32_t v_ready = v_land + 8, v_empty = v_ready + 8 * ST;

  const int hb_count = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y
                                            * blockIdx.z);
  constexpr int kRows = kTile * C;
  const int q0 = (gridDim.x - 1 - lin / hb_count) * kRows;
  const int h = lin % hb_count % H;
  const int b = lin % hb_count / H;
  const int kh = h / (H / K);
  const int kv_end = CAUSAL ? min(q0 + kRows, S) : S;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < C + 2 * ST; ++i) mbar_init(bar_q + 8 * i, 1);
#pragma unroll
    for (int i = 0; i < ST; ++i) mbar_init(k_empty + 8 * i, C);
    mbar_init(v_land, 1);
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      mbar_init(v_ready + 8 * i, 1);
      mbar_init(v_empty + 8 * i, C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C) {
    if constexpr (C == 2) regs_dealloc<kTfTransformRegs>();
    const int t = threadIdx.x % 128;
    const bool leader = t == 0;
    auto load_k = [&](int j) {
      tma_tile<HD, BN, 32>(k_s + 2 * (j % ST) * KB, &tm_k,
                           k_full + 8 * (j % ST), kh, j * BN, b);
    };
    if (leader) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        tma_tile<HD, kTile, 32>(q_s + 2 * c * QB, &tm_q, bar_q + 8 * c, h,
                                q0 + c * kTile, b);
      }
      for (int j = 0; j + 1 < ST && j < n_tiles; ++j) load_k(j);
      tma_tile<HD, BN, 32>(land, &tm_v, v_land, kh, 0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      // k tile i + ST - 1 into its stage, once the stage's previous tile
      // is released
      const int j = i + ST - 1;
      if (leader && j < n_tiles) {
        if (j >= ST) {
          mbar_wait_bounded(k_empty + 8 * (j % ST), ((j / ST) - 1) & 1);
        }
        load_k(j);
      }
      unsigned char* kt = k_s + 2 * (i % ST) * KB;
      mbar_wait_bounded(k_full + 8 * (i % ST), (i / ST) & 1);
      split_tile(kt, kt + KB, KB, t);
      fence_proxy_async();
      bar_sync<128>(5);
      if (leader) mbar_arrive(k_ready + 8 * (i % ST));
      unsigned char* vt = v_s + 2 * (i % ST) * VB;
      if (i >= ST) {
        mbar_wait_bounded(v_empty + 8 * (i % ST), ((i / ST) - 1) & 1);
      }
      mbar_wait_bounded(v_land, i & 1);
      transpose_v<HD, BN>(land, vt, vt + VB, t);
      fence_proxy_async();
      bar_sync<128>(5);              // every thread is done with the landing
      if (leader) {
        mbar_arrive(v_ready + 8 * (i % ST));
        if (i + 1 < n_tiles) {
          tma_tile<HD, BN, 32>(land, &tm_v, v_land, kh, (i + 1) * BN, b);
        }
      }
    }
  } else {
    if constexpr (C == 2) regs_alloc<kTfConsumerRegs>();
    // the modulo tells ptxas that tid < 128 (see flash_wgmma_kernel)
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;   // fragment row and column
    unsigned char* q_hi = q_s + 2 * wg * QB;
    unsigned char* q_lo = q_hi + QB;
    const int rows0 = q0 + wg * kTile;
    const int row0 = rows0 + warp * 16 + g;  // this thread's rows: +0, +8
    auto masked = [&](int k0) {
      return (CAUSAL && k0 + BN > rows0) || k0 + BN > S;
    };
    auto k_tile = [&](int i) { return k_s + 2 * (i % ST) * KB; };
    auto v_tile = [&](int i) { return v_s + 2 * (i % ST) * VB; };
    auto wait_ready = [&](uint32_t bars, int i) {
      mbar_wait_bounded(bars + 8 * (i % ST), (i / ST) & 1);
    };
    auto release = [&](uint32_t bars, int i) {
      if (tid == 0) mbar_arrive(bars + 8 * (i % ST));
    };
    // the turns (flash_ws_kernel's); one consumer takes none
    auto take_turn = [&] {
      if constexpr (C == 2) bar_sync<256>(1 + wg);
    };
    auto pass_turn = [&] {
      if constexpr (C == 2) bar_arrive<256>(2 - wg);
    };
    if (wg == 1) pass_turn();

    // this consumer's q tile split once into its high and low parts: in
    // registers (QREG) or in shared memory
    uint32_t qh[T::QREG ? HD / 8 : 1][4], ql[T::QREG ? HD / 8 : 1][4];
    mbar_wait_bounded(bar_q + 8 * wg, 0);
    if constexpr (T::QREG) {
      q_fragments<HD>(q_hi, warp * 16, g, tq, qh, ql);
    } else {
      split_tile(q_hi, q_lo, QB, tid);
      fence_proxy_async();
      bar_sync<128>(3 + wg);
    }
    auto qk = [&](float (&s)[BN / 2], int i) {
      unsigned char* kt = opaque(k_tile(i));
      if constexpr (T::QREG) {
        qk_tf32<HD, BN>(s, qh, ql, kt, kt + KB);
      } else {
        qk_tf32<HD, BN>(s, opaque(q_hi), opaque(q_lo), kt, kt + KB);
      }
    };

    float o[HD / 2];                 // 64 x HD accumulator
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}; // running max of rows row0, row0 + 8
    float l[2] = {0.f, 0.f};         // this thread's part of their sums
    const float c = scale * kLog2e;
    auto pv = [&](const uint32_t (&ph)[BN / 8][4],
                  const uint32_t (&pl)[BN / 8][4], int i) {
      unsigned char* vt = opaque(v_tile(i));
      pv_tf32<HD, BN>(o, ph, pl, vt, vt + VB);
    };
    {
      float s[BN / 2] = {};          // 64 x BN scores, then probabilities
      uint32_t ph[BN / 8][4], pl[BN / 8][4];   // p_hi, p_lo A fragments
      wait_ready(k_ready, 0);
      take_turn();
      fence_regs(s);
      wgmma_fence();
      qk(s, 0);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty, 0);
      float2 alpha = softmax_tile<CAUSAL, BN>(s, m, l, c, masked(0), 0,
                                              row0, tq, S);
      for (int i = 0; i + 1 < n_tiles; ++i) {
        tf32_fragments<BN>(s, ph, pl);
        rescale(o, alpha);
        fence_regs(ph);
        fence_regs(pl);
        wait_ready(k_ready, i + 1);
        wait_ready(v_ready, i);
        take_turn();
        fence_regs(s);               // s = q . k^T of tile i + 1
        wgmma_fence();
        qk(s, i + 1);
        wgmma_commit();
        fence_regs(s);
        pv(ph, pl, i);
        wgmma_commit();
        pass_turn();
        fence_regs(o);
        wgmma_wait<1>();             // the scores; P.V may still run
        fence_regs(s);
        release(k_empty, i + 1);
        const int k1 = (i + 1) * BN;
        alpha = softmax_tile<CAUSAL, BN>(s, m, l, c, masked(k1), k1, row0,
                                         tq, S);
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty, i);
      }
      // the last tile's P.V
      tf32_fragments<BN>(s, ph, pl);
      rescale(o, alpha);
      fence_regs(ph);
      fence_regs(pl);
      wait_ready(v_ready, n_tiles - 1);
      take_turn();
      wgmma_fence();
      pv(ph, pl, n_tiles - 1);
      wgmma_commit();
      if (wg == 0) pass_turn();
      fence_regs(o);
      wgmma_wait<0>();
      fence_regs(o);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // the rows' sums
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // o / max(l, 1e-30), rows at or past S not written; a quad writes 32
    // contiguous bytes of a row
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f),
                          1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      if (t >= S) continue;
      float* orow = out + (((long long)b * S + t) * H + h) * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[4 * n + 2 * r] * inv[r],
                        o[4 * n + 2 * r + 1] * inv[r]);
      }
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

// The tensor map of a (B, S, heads, HD) bf16 or float32 operand read in
// place: dims (HD, heads, S, B) with the caller's sequence and batch
// strides, boxes of 128 bytes of columns (64 bf16, 32 float32) x `rows`
// rows of one head, 128-byte swizzle, zeros outside (rows at or past S,
// columns past HD).
template <int HD, typename T>
cudaError_t tensor_map(CUtensorMap* map, const T* base, int heads, int S,
                       int B, long long s_stride, long long b_stride,
                       int rows = kTile) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * sizeof(T),
                                 (cuuint64_t)s_stride * sizeof(T),
                                 (cuuint64_t)b_stride * sizeof(T)};
  const cuuint32_t box[4] = {128 / sizeof(T), 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<T*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch plan (ops.py:FlashPlan, chosen by ops.py:flash_plan): which
// kernel runs; each kernel's tiles and stages follow from it here. The
// launcher refuses any other plan, a plan of the other dtype, and
// kWsPairs at an odd G.
enum Plan : int {
  kWgmma = 1,      // bf16: flash_wgmma_kernel
  kWsHalves = 2,   // bf16: flash_ws_kernel, two halves of a head's 128 rows
  kWsPairs = 3,    // bf16: flash_ws_kernel, 64 rows of two heads (G even)
  kTf32 = 4,       // float32: flash_tf32_kernel
};

// TMA reads 16-byte aligned rows: base pointers and strides (elements of
// `es` bytes) must keep them so (the wrapper refuses other layouts first)
inline bool rows_aligned(const void* q, const void* k, const void* v,
                         long long strides, int es) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q)
                         | reinterpret_cast<uintptr_t>(k)
                         | reinterpret_cast<uintptr_t>(v);
  return (strides * es) % 16 == 0 && ptrs % 16 == 0;
}

template <int HD, bool CAUSAL>
int launch_tf32(const float* q, const float* k, const float* v, float* out,
                int B, int S, int H, int K, long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long v_sb,
                long long v_ss, float scale, cudaStream_t stream) {
  using T = TfShape<HD>;
  if (!rows_aligned(q, k, v, q_sb | q_ss | k_sb | k_ss | v_sb | v_ss, 4)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = tensor_map<HD>(&tm_q, q, H, S, B, q_ss, q_sb);
  if (err == cudaSuccess) {
    err = tensor_map<HD>(&tm_k, k, K, S, B, k_ss, k_sb, T::BN);
  }
  if (err == cudaSuccess) {
    err = tensor_map<HD>(&tm_v, v, K, S, B, v_ss, v_sb, T::BN);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in = false;
  constexpr size_t bytes = tf32_smem_bytes<HD>();
  static_assert(bytes <= kBlockSmem, "over the 227 KB a block may use");
  err = opt_in(flash_tf32_kernel<HD, CAUSAL>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = kTile * T::C;
  const dim3 grid((S + rows - 1) / rows, H, B);
  flash_tf32_kernel<HD, CAUSAL><<<grid, tf_threads<HD>(), bytes, stream>>>(
      tm_q, tm_k, tm_v, out, S, H, K, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool CAUSAL, bool HEADS, int BN = ws_kv_rows<HD>()>
int launch_ws(const bf16* k, const bf16* v, const CUtensorMap& tm_q,
              bf16* out, int B, int S, int H, int K, long long k_sb,
              long long k_ss, long long v_sb, long long v_ss, float scale,
              cudaStream_t stream) {
  constexpr int ST = 2;
  CUtensorMap tm_k, tm_v;
  cudaError_t err = tensor_map<HD>(&tm_k, k, K, S, B, k_ss, k_sb, BN);
  if (err == cudaSuccess) {
    err = tensor_map<HD>(&tm_v, v, K, S, B, v_ss, v_sb, BN);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in = false;
  constexpr size_t bytes = ws_smem_bytes<HD, BN, ST>();
  static_assert(bytes <= kBlockSmem, "over the 227 KB a block may use");
  err = opt_in(flash_ws_kernel<HD, CAUSAL, BN, ST, HEADS>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = HEADS ? kTile : kWsRows;
  const dim3 grid((S + rows - 1) / rows, HEADS ? H / 2 : H, B);
  flash_ws_kernel<HD, CAUSAL, BN, ST, HEADS>
      <<<grid, kWsThreads, bytes, stream>>>(tm_q, tm_k, tm_v, out, S, H, K,
                                            scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool CAUSAL>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                int B, int S, int H, int K, long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long v_sb,
                long long v_ss, float scale, int plan, cudaStream_t stream) {
  const bool pairs = plan == kWsPairs && (H / K) % 2 == 0;
  const bool ws = plan == kWsHalves || pairs;
  if (!(plan == kWgmma || ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!rows_aligned(q, k, v, q_sb | q_ss | k_sb | k_ss | v_sb | v_ss, 2)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  CUtensorMap tm_q;
  cudaError_t err = tensor_map<HD>(&tm_q, q, H, S, B, q_ss, q_sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ws) {
    return pairs ? launch_ws<HD, CAUSAL, true>(k, v, tm_q, out, B, S, H, K,
                                               k_sb, k_ss, v_sb, v_ss, scale,
                                               stream)
                 : launch_ws<HD, CAUSAL, false>(k, v, tm_q, out, B, S, H, K,
                                                k_sb, k_ss, v_sb, v_ss,
                                                scale, stream);
  }
  CUtensorMap tm_k, tm_v;
  err = tensor_map<HD>(&tm_k, k, K, S, B, k_ss, k_sb);
  if (err == cudaSuccess) err = tensor_map<HD>(&tm_v, v, K, S, B, v_ss, v_sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted_in = false;
  constexpr size_t bytes = wg_smem_bytes<HD>();
  static_assert(bytes <= kBlockSmem, "over the 227 KB a block may use");
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
                 long long v_sb, long long v_ss, float scale, int plan,
                 cudaStream_t stream) {
  if (dtype == 0 && plan == kTf32) {
    return launch_tf32<HD, CAUSAL>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), B, S, H, K,
        q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, stream);
  }
  if (dtype == 1) {
    return launch_bf16<HD, CAUSAL>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), B, S, H, K,
        q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, plan, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int dtype, int B, int S, int H, int K, int causal,
              long long q_sb, long long q_ss, long long k_sb, long long k_ss,
              long long v_sb, long long v_ss, float scale, int plan,
              cudaStream_t stream) {
  if (causal) {
    return launch_typed<HD, true>(q, k, v, out, dtype, B, S, H, K, q_sb,
                                  q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                  plan, stream);
  }
  return launch_typed<HD, false>(q, k, v, out, dtype, B, S, H, K, q_sb, q_ss,
                                 k_sb, k_ss, v_sb, v_ss, scale, plan,
                                 stream);
}

// the query rows a CTA holds of each of its heads and the keys of a kv
// tile under `plan`
template <int HD>
int plan_tile(int plan, int* rows, int* keys) {
  switch (plan) {
    case kWgmma: *rows = kTile; *keys = kTile; return 0;
    case kWsHalves: *rows = kWsRows; *keys = ws_kv_rows<HD>(); return 0;
    case kWsPairs: *rows = kTile; *keys = ws_kv_rows<HD>(); return 0;
    case kTf32:
      *rows = kTile * TfShape<HD>::C;
      *keys = TfShape<HD>::BN;
      return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. plan: the
// kernel (enum Plan above). Returns the CUDA error of the launch (0 on
// success); the caller raises on anything else.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int H, int K, int hd, int causal, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    float scale, int plan, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define FLASH_HD(N)                                                          \
  case N:                                                                    \
    return launch_hd<N>(q, k, v, out, dtype, B, S, H, K, causal, q_sb, q_ss, \
                        k_sb, k_ss, v_sb, v_ss, scale, plan, s);
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(80)
    FLASH_HD(112)
    FLASH_HD(128)
    FLASH_HD(192)
#undef FLASH_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The query rows a CTA holds of each of its heads (`rows`) and the keys of
// a kv tile (`keys`) of `plan`'s kernel at head size `hd`: what the
// kernel's issued products are counted by (chip_smoke.py's product bound).
// Returns 0, or cudaErrorInvalidValue for an unknown plan or head size.
extern "C" int flash_attention_tile(int plan, int hd, int* rows, int* keys) {
  switch (hd) {
#define FLASH_HD(N) \
  case N:           \
    return plan_tile<N>(plan, rows, keys);
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(80)
    FLASH_HD(112)
    FLASH_HD(128)
    FLASH_HD(192)
#undef FLASH_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
