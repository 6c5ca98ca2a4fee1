// Paged multi-query attention for Hopper (sm_90a), the speculative verify
// step: C chunk queries per (batch row, query head) -- the row's last
// accepted token and its drafted continuations -- against a KV cache that
// lives in a shared page pool, addressed through a per-row page table.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:paged_verify_call
//   (body _paged_verify_kernel, wrapper ops.py:paged_verify_attention).
// It computes the same function over the row's virtual sequence of
// n_pages * page slots (split_decode.cuh in bf16, flash_decode.cuh in
// float32): scores q.k * scale in float32 plus a bias of its own for every
// query, bias[b][c][slot], which carries slot validity and
// causal-within-chunk; a softmax with the finite NEG_INF = -1e30 and the
// clamp max(l, 1e-30); P.V in float32, written once in q's dtype. Every
// table entry must be a valid page id; idle rows point all entries at the
// trash page, and a fully masked query comes out as the mean of v over
// the row's slots, as in the plain version (ref.py). No page is skipped.
//
// What bounds it on this card: bytes. It must read each page a row names
// once per kv head (2 * page * K * hd elements a page) and does about
// 4 * G * C flops per element read (about 5 a byte at LISA-7B's G = 1,
// C = 5), under the card's float32 rate on CUDA cores, so the bound needs
// no tensor cores.
// Rows that share prefix pages read them once each here; a lower bound
// counts each distinct page once. Measured at LISA-7B's B = 4, C = 4 the
// kernel is about 4 us over its C = 1 time, which one copy round instead
// of two or half the shuffles did not move: the set's arithmetic between
// the copies, at 16 warps an SM, is what holds it there.
//
// What the bf16 design does about that (split_decode.cuh, the decode
// kernels' body with a query set of chunk positions):
//   * One cluster serves the G * C (chunk position, query head) queries
//     of a (batch row, kv head), up to kMaxGroup = 8 of them (more are
//     split over clusters, each reading the pages again): each page is read
//     from device memory once per cluster and scored against every chunk
//     position, which is the point of verifying k drafts in one pass. The
//     set sizes the path takes (G * C = 4 and 5 at LISA-7B) have kernels of
//     their own, so their registers stay at what the set needs.
//   * Split-K over the cluster's CTAs: CTA r owns pages [r n / split,
//     (r + 1) n / split), picked at launch from B, K and the row's pages
//     (at B = 4, 128 query sets over 132 SMs: 2 CTAs a set). The partial
//     softmax states merge once in rank 0's shared memory.
//   * Each query's bias row differs (causal within the chunk), so the lanes
//     of a k row split the set's bias rows among them and each adds its
//     query's bias to its part of q.k before the lanes' sum.
//   * The page table is read in place (no limit of its own on a row's
//     pages), each slot's address through the pool's page and slot strides:
//     with pages of 4 a row's page changes every 4 slots, and each copy
//     waits on its table read. 16-byte cp.async copies of a CTA's k and v
//     rows into shared memory; the caller refuses pointers and strides that
//     are not multiples of 16 bytes.
// float32 inputs keep flash_decode.cuh's one-CTA-a-(row, kv head) body with
// the row's table staged in shared memory.
//
// Left for later work: tensor-core products (mma.sync) of a tile's slots
// against the C queries, which would take that arithmetic off the CUDA
// cores; reading a shared prefix page once for every row that names it;
// and a CUDA graph of the verify step.

#include "flash_decode.cuh"
#include "split_decode.cuh"

#include <algorithm>

namespace {

using namespace flash_decode;

// The queries of one CTA or cluster: the flattened pairs j0 .. j0+n-1 of
// the G * C (chunk position c, query head g) pairs of kv head kh, j = c * G
// + g. q and out are (B, C, H, HD) contiguous; the bias row of position c
// is bias_b + c * bias_sc.
struct ChunkQueries {
  static constexpr bool kSharedBias = false;
  int kh, n, j0, G, C, H, b;
  const float* bias_b;
  long long bias_sc;
  __device__ __forceinline__ long long row(int j) const {
    const int jj = j0 + j;
    const int c = jj / G;
    const int g = jj - c * G;
    return ((long long)b * C + c) * H + (long long)kh * G + g;
  }
  __device__ __forceinline__ const float* bias(int j) const {
    return bias_b + (long long)((j0 + j) / G) * bias_sc;
  }
};

// The float32 kernel. CTA grid: blockIdx.x = kv head * ceil(G * C /
// kMaxGroup) + query chunk, blockIdx.y = batch row b. q (B, C, H, HD) contiguous; k_pool/v_pool
// (P, page, K, HD) with unit stride over HD and stride HD over K; table
// (B, n_pages) int32 with unit stride over pages; bias (B, C, n_pages *
// page) float32 with unit stride over slots; out like q. Dynamic shared
// memory: n_pages ints.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_verify_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ table,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int C, int H, int K,
                              int n_pages, int page, long long k_sp,
                              long long k_ss, long long v_sp, long long v_ss,
                              long long table_sb, long long bias_sb,
                              long long bias_sc, float scale) {
  extern __shared__ int sm_table[];
  const int b = blockIdx.y;
  stage_table(sm_table, table + (long long)b * table_sb, n_pages);
  const PagedRows rows{sm_table, page, k_sp, k_ss, v_sp, v_ss};
  const int G = H / K;
  const int nq = G * C;
  const int n_chunks = (nq + kMaxGroup - 1) / kMaxGroup;
  const int j0 = (blockIdx.x % n_chunks) * kMaxGroup;
  const ChunkQueries qs{(int)blockIdx.x / n_chunks, min(kMaxGroup, nq - j0),
                        j0, G, C, H, b, bias + (long long)b * bias_sb,
                        bias_sc};
  attend<T, HD>(q, k_pool, v_pool, out, n_pages * page, rows, qs, scale);
}

// The bf16 kernel: one cluster of `split` CTAs a (kv head, query chunk)
// along x, batch row b along y; CTA r folds the slots of pages
// [r n / split, (r + 1) n / split) for the chunk's queries. Sets of up
// to 4 queries, and of 5 at hd = 128, are held to 128 registers, two CTAs
// an SM, so that LISA-7B's 256 CTAs at B = 4 run in one wave (ptxas fits
// them without spilling; the 5-query set at hd = 64 would spill).
template <int HD, int NG>
__global__ void __launch_bounds__(split_decode::kThreads,
                                  NG <= 4 || (NG == 5 && HD == 128) ? 2 : 1)
split_paged_verify_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_pool,
                                    const __nv_bfloat16* __restrict__ v_pool,
                                    const int* __restrict__ table,
                                    const float* __restrict__ bias,
                                    __nv_bfloat16* __restrict__ out, int C,
                                    int H, int K, int n_pages, int page,
                                    long long k_sp, long long k_ss,
                                    long long v_sp, long long v_ss,
                                    long long table_sb, long long bias_sb,
                                    long long bias_sc, float scale) {
  const int G = H / K;
  const split_decode::Place pl = split_decode::place(G * C);
  const int b = blockIdx.y;
  const PagedRows rows{table + (long long)b * table_sb, page, k_sp, k_ss,
                       v_sp, v_ss};
  const ChunkQueries qs{pl.kh, pl.gc, pl.j0, G, C, H, b,
                        bias + (long long)b * bias_sb, bias_sc};
  split_decode::attend<HD, NG>(
      q, k_pool, v_pool, out, rows, qs,
      split_decode::part(n_pages, pl.rank, pl.split) * page,
      split_decode::part(n_pages, pl.rank + 1, pl.split) * page, pl, scale);
}

template <int HD, int NG>
struct SplitKernel {
  static auto fn() { return &split_paged_verify_attention_kernel<HD, NG>; }
};

// At most one split a page, and one per kMinSlots slots. Query sets of 4
// and 5 (LISA-7B's C = 4 and 5 at G = 1; a smaller set takes the kernel of
// 4) and kMaxGroup.
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const int* table, const float* bias, void* out, int B, int C,
                int H, int K, int n_pages, int page, int hd, long long k_sp,
                long long k_ss, long long v_sp, long long v_ss,
                long long table_sb, long long bias_sb, long long bias_sc,
                float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (!split_decode::aligned16({q, k_pool, v_pool},
                               {k_sp, k_ss, v_sp, v_ss})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long slots = (long long)n_pages * page;
  const int most = static_cast<int>(
      std::min<long long>(n_pages, slots / split_decode::kMinSlots));
  return static_cast<int>(split_decode::launch_split<SplitKernel>(
      split_decode::Sizes<4, 5, split_decode::kMaxGroup>{}, (H / K) * C,
      hd, B, K, most, stream, static_cast<const bf*>(q),
      static_cast<const bf*>(k_pool), static_cast<const bf*>(v_pool), table,
      bias, static_cast<bf*>(out), C, H, K, n_pages, page, k_sp, k_ss, v_sp,
      v_ss, table_sb, bias_sb, bias_sc, scale));
}

template <typename T>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const float* bias, void* out, int B,
                 int C, int H, int K, int n_pages, int page, int hd,
                 long long k_sp, long long k_ss, long long v_sp,
                 long long v_ss, long long table_sb, long long bias_sb,
                 long long bias_sc, float scale, cudaStream_t stream) {
  const int G = H / K;
  const dim3 grid(K * ((G * C + kMaxGroup - 1) / kMaxGroup), B);
  const dim3 block(kWarps * 32);
  const size_t smem = sizeof(int) * (size_t)n_pages;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      paged_verify_attention_kernel<T, 32><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, C, H, K, n_pages, page, k_sp, k_ss,
          v_sp, v_ss, table_sb, bias_sb, bias_sc, scale);
      break;
    case 64:
      paged_verify_attention_kernel<T, 64><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, C, H, K, n_pages, page, k_sp, k_ss,
          v_sp, v_ss, table_sb, bias_sb, bias_sc, scale);
      break;
    case 80:
      paged_verify_attention_kernel<T, 80><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, C, H, K, n_pages, page, k_sp, k_ss,
          v_sp, v_ss, table_sb, bias_sb, bias_sc, scale);
      break;
    case 112:
      paged_verify_attention_kernel<T, 112><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, C, H, K, n_pages, page, k_sp, k_ss,
          v_sp, v_ss, table_sb, bias_sb, bias_sc, scale);
      break;
    case 128:
      paged_verify_attention_kernel<T, 128><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, C, H, K, n_pages, page, k_sp, k_ss,
          v_sp, v_ss, table_sb, bias_sb, bias_sc, scale);
      break;
    case 192:
      paged_verify_attention_kernel<T, 192><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, C, H, K, n_pages, page, k_sp, k_ss,
          v_sp, v_ss, table_sb, bias_sb, bias_sc, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error of the launch (0 on success); the caller raises on anything
// else.
extern "C" int paged_verify_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* out, int dtype, int B, int C, int H, int K,
    int n_pages, int page, int hd, long long k_sp, long long k_ss,
    long long v_sp, long long v_ss, long long table_sb, long long bias_sb,
    long long bias_sc, float scale, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || n_pages <= 0 || page <= 0 ||
      H % K != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tb = static_cast<const int*>(table);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(q, k_pool, v_pool, tb, bf, out, B, C, H, K,
                               n_pages, page, hd, k_sp, k_ss, v_sp, v_ss,
                               table_sb, bias_sb, bias_sc, scale, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k_pool, v_pool, tb, bf, out, B, C, H, K, n_pages,
                       page, hd, k_sp, k_ss, v_sp, v_ss, table_sb, bias_sb,
                       bias_sc, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
