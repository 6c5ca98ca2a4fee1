// Paged flash-decode attention for Hopper (sm_90a): one query token per
// (batch row, query head) against a KV cache that lives in a shared page
// pool, addressed through a per-row page table.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:paged_decode_call
//   (body _paged_decode_kernel, wrapper ops.py:paged_decode_attention).
// It computes the same function as the contiguous kernel over the row's
// virtual sequence of n_pages * page slots (split_decode.cuh in bf16,
// flash_decode.cuh in float32): virtual slot
// s is slot s % page of page table[b][s / page]. Every table entry must be
// a valid page id; idle rows point all entries at the trash page. No page
// is skipped, even when its bias masks it whole, so a fully masked row is
// the mean of v over all its slots, as in the plain version (ref.py).
//
// What bounds it on this card: bytes. Per step it must read each page a
// row names once per kv head (2 * page * K * hd elements a page) and does
// about 4 flops per element read. Rows that share prefix pages read them
// once each here; a lower bound counts each distinct page once. At the
// in-flight step's shape (B = 4, n = 14 pages of 16, K = 32, hd = 128) that
// is 14.7 MB as read, 3.4 microseconds of HBM time: bound, as the
// contiguous kernel is, by the bytes in flight and the chain before the
// last one lands.
//
// What the bf16 design does about that (split_decode.cuh, the contiguous
// kernel's body with a paged addressing policy):
//   * Split-K over a thread-block cluster: each (batch row, kv head, group
//     of up to kMaxGroup query heads) gets `split` CTAs, picked at launch
//     from B, K and the row's pages; CTA r owns pages [r n / split,
//     (r + 1) n / split) and every slot of them. The partial softmax
//     states merge once through distributed shared memory.
//   * The TPU kernel resolves the page table by scalar prefetch into its
//     BlockSpec index maps. Here each lane reads the table entry of the
//     slot it loads and addresses virtual slot s as
//       pool + table[s / page] * stride_page + (s % page) * stride_slot
//            + kv_head * hd,
//     reading the public (P, page, K, hd) pool in place: no gathered copy,
//     no transposed pool. The table is no longer staged in shared memory,
//     so the bf16 kernel has no limit of its own on the pages a row names
//     (MAX_PAGES, ops.py, stays for the verify and float32 kernels).
//   * 16-byte cp.async copies of a CTA's rows into shared memory, kStage
//     rows a lane group a step (64 slots a CTA at hd = 128; at B = 4 a CTA
//     owns 7 pages, 112 slots: two steps, whose copy rounds run one after
//     the other), one maximum, rescale and sum per tile of a lane group's
//     rows, the partial states merged in rank 0's shared memory.
//   * Every table entry must be a valid page id; idle rows point all
//     entries at the trash page. No page is skipped, even when its bias
//     masks it whole, so a fully masked row is the mean of v over all its
//     slots, as in the plain version (ref.py).
// At G > 1 the plan SETS (ops.py:decode_plan) takes the grouped-query body
// (split_decode.cuh:attend_set) with the same paged addressing: one cluster
// a kv head's whole query set, q.k and P.V on the tensor cores.
// float32 inputs keep flash_decode.cuh's one-CTA-a-kv-head body with the
// row's table staged in shared memory.
//
// Left for later work: reading a shared prefix page once for every row
// that names it (rows 0 and 1 of the in-flight step share 13 of 14 pages;
// the byte bound counts them once), overlapping the two copy rounds at
// B = 4 (a ring of two stages, the next step's table reads and copies
// issued before this step is scored, took 7 % off here, but cost the
// contiguous kernel 6 % in the shared body), TMA staging of whole pages,
// and a CUDA graph of the decode step.

#include "flash_decode.cuh"
#include "split_decode.cuh"

#include <algorithm>

namespace {

using namespace flash_decode;

// ops.py:DecodePlan
enum Plan { kFlashDecode = 0, kSplit = 1, kSets = 2 };

// q (B, H, HD) contiguous; k_pool/v_pool (P, page, K, HD) with unit stride
// over HD and stride HD over K; table (B, n_pages) int32 with unit stride
// over pages; bias (B, n_pages * page) float32 with unit stride over slots;
// out like q. Dynamic shared memory: n_pages ints.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ table,
                              const float* __restrict__ bias,
                              T* __restrict__ out, int H, int K, int n_pages,
                              int page, long long k_sp, long long k_ss,
                              long long v_sp, long long v_ss,
                              long long table_sb, long long bias_sb,
                              float scale) {
  extern __shared__ int sm_table[];
  const int b = blockIdx.y;
  stage_table(sm_table, table + (long long)b * table_sb, n_pages);
  const PagedRows rows{sm_table, page, k_sp, k_ss, v_sp, v_ss};
  attend<T, HD>(q, k_pool, v_pool, out, n_pages * page, rows,
                decode_heads(H, K, bias + (long long)b * bias_sb), scale);
}

// The bf16 kernel: one cluster of `split` CTAs a (kv head, head chunk)
// along x, batch row b along y; CTA r folds the slots of pages
// [r n / split, (r + 1) n / split).
template <int HD, int NG>
__global__ void __launch_bounds__(split_decode::kThreads)
split_paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k_pool,
                                    const __nv_bfloat16* __restrict__ v_pool,
                                    const int* __restrict__ table,
                                    const float* __restrict__ bias,
                                    __nv_bfloat16* __restrict__ out, int H,
                                    int K, int n_pages, int page,
                                    long long k_sp, long long k_ss,
                                    long long v_sp, long long v_ss,
                                    long long table_sb, long long bias_sb,
                                    float scale) {
  const split_decode::Place pl = split_decode::place(H / K);
  const int b = blockIdx.y;
  const PagedRows rows{table + (long long)b * table_sb, page, k_sp, k_ss,
                       v_sp, v_ss};
  split_decode::attend<HD, NG>(
      q, k_pool, v_pool, out, rows,
      split_decode::head_queries(pl, H, K, bias + (long long)b * bias_sb),
      split_decode::part(n_pages, pl.rank, pl.split) * page,
      split_decode::part(n_pages, pl.rank + 1, pl.split) * page, pl, scale);
}

template <int HD, int NG>
struct SplitKernel {
  static auto fn() { return &split_paged_decode_attention_kernel<HD, NG>; }
};

// The set kernel (plan SETS): one cluster of `split` CTAs a (kv head, set
// of up to kSetRows of its query heads) along x, batch row b along y; CTA
// r folds the slots of pages [r n / split, (r + 1) n / split).
template <int HD>
__global__ void __launch_bounds__(split_decode::kSetThreads, 2)
set_paged_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k_pool,
                                  const __nv_bfloat16* __restrict__ v_pool,
                                  const int* __restrict__ table,
                                  const float* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ out, int H,
                                  int K, int n_pages, int page,
                                  long long k_sp, long long k_ss,
                                  long long v_sp, long long v_ss,
                                  long long table_sb, long long bias_sb,
                                  float scale) {
  const split_decode::Place pl =
      split_decode::place(H / K, split_decode::kSetRows);
  const int b = blockIdx.y;
  const PagedRows rows{table + (long long)b * table_sb, page, k_sp, k_ss,
                       v_sp, v_ss};
  split_decode::attend_set<HD>(
      q, k_pool, v_pool, out, rows,
      split_decode::head_queries(pl, H, K, bias + (long long)b * bias_sb),
      split_decode::part(n_pages, pl.rank, pl.split) * page,
      split_decode::part(n_pages, pl.rank + 1, pl.split) * page, pl, scale);
}

template <int HD>
struct SetKernel {
  static_assert(split_decode::SetSmem<HD>::kBytes <= split_decode::kBlockSmem,
                "over the 227 KB a block may use");
  static auto fn() { return &set_paged_decode_attention_kernel<HD>; }
};

// plan: ops.py:DecodePlan. SPLIT: Sizes<1, kMaxGroup>, at most one split a
// page and one per kMinSlots slots. SETS: sets of kSetRows, at most one
// split a page and max_split (which SPLIT refuses).
int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const int* table, const float* bias, void* out, int B, int H,
                int K, int n_pages, int page, int hd, long long k_sp,
                long long k_ss, long long v_sp, long long v_ss,
                long long table_sb, long long bias_sb, float scale, int plan,
                int max_split, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (!split_decode::aligned16({q, k_pool, v_pool},
                               {k_sp, k_ss, v_sp, v_ss})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (plan == kSplit && max_split == 0) {
    const long long slots = (long long)n_pages * page;
    const int most = static_cast<int>(
        std::min<long long>(n_pages, slots / split_decode::kMinSlots));
    return static_cast<int>(split_decode::launch_split<SplitKernel>(
        split_decode::Sizes<1, split_decode::kMaxGroup>{}, H / K, hd, B, K,
        most, stream, static_cast<const bf*>(q),
        static_cast<const bf*>(k_pool), static_cast<const bf*>(v_pool),
        table, bias, static_cast<bf*>(out), H, K, n_pages, page, k_sp, k_ss,
        v_sp, v_ss, table_sb, bias_sb, scale));
  }
  if (plan == kSets && max_split >= 1) {
    return static_cast<int>(split_decode::launch_sets<SetKernel>(
        H / K, hd, B, K, std::min(n_pages, max_split), stream,
        static_cast<const bf*>(q), static_cast<const bf*>(k_pool),
        static_cast<const bf*>(v_pool), table, bias, static_cast<bf*>(out),
        H, K, n_pages, page, k_sp, k_ss, v_sp, v_ss, table_sb, bias_sb,
        scale));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const float* bias, void* out, int B,
                 int H, int K, int n_pages, int page, int hd, long long k_sp,
                 long long k_ss, long long v_sp, long long v_ss,
                 long long table_sb, long long bias_sb, float scale,
                 cudaStream_t stream) {
  const int G = H / K;
  const dim3 grid(K * ((G + kMaxGroup - 1) / kMaxGroup), B);
  const dim3 block(kWarps * 32);
  const size_t smem = sizeof(int) * (size_t)n_pages;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      paged_decode_attention_kernel<T, 32><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
      break;
    case 64:
      paged_decode_attention_kernel<T, 64><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
      break;
    case 80:
      paged_decode_attention_kernel<T, 80><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
      break;
    case 112:
      paged_decode_attention_kernel<T, 112><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
      break;
    case 128:
      paged_decode_attention_kernel<T, 128><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
      break;
    case 192:
      paged_decode_attention_kernel<T, 192><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; plan: ops.py:DecodePlan, FLASH_DECODE
// for float32 only, SPLIT or SETS for bf16 (max_split: SETS' most CTAs a
// cluster, 0 for the other plans). Strides are in elements. Returns the
// CUDA error of the launch (0 on success); the caller raises on anything
// else.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* out, int dtype, int B, int H, int K, int n_pages,
    int page, int hd, long long k_sp, long long k_ss, long long v_sp,
    long long v_ss, long long table_sb, long long bias_sb, float scale,
    int plan, int max_split, void* stream) {
  if (B <= 0 || K <= 0 || n_pages <= 0 || page <= 0 || H % K != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tb = static_cast<const int*>(table);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && plan == kFlashDecode && max_split == 0) {
    return launch_typed<float>(q, k_pool, v_pool, tb, bf, out, B, H, K,
                               n_pages, page, hd, k_sp, k_ss, v_sp, v_ss,
                               table_sb, bias_sb, scale, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k_pool, v_pool, tb, bf, out, B, H, K, n_pages,
                       page, hd, k_sp, k_ss, v_sp, v_ss, table_sb, bias_sb,
                       scale, plan, max_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split a SETS launch of B rows, H query heads over K kv heads at head
// dim hd takes with `most` its cap (decode: min(max_split, W); paged:
// min(max_split, n_pages)), into *split; returns the CUDA error of the
// query (0 on success).
extern "C" int paged_decode_attention_set_split(int B, int H, int K,
                                                int hd, int most,
                                                int* split) {
  if (B <= 0 || K <= 0 || H % K != 0 || most < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      split_decode::set_splits<SetKernel>(H / K, hd, B, K, most, split));
}
