// Paged multi-query attention for Hopper (sm_90a), the speculative verify
// step: C chunk queries per (batch row, query head) -- the row's last
// accepted token and its drafted continuations -- against a KV cache that
// lives in a shared page pool, addressed through a per-row page table.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:paged_verify_call
//   (body _paged_verify_kernel, wrapper ops.py:paged_verify_attention).
// It computes the same function (flash_decode.cuh) over the row's virtual
// sequence of n_pages * page slots: scores q.k * scale in float32 plus a
// bias of its own for every query, bias[b][c][slot], which carries slot
// validity and causal-within-chunk; an online softmax whose running
// (m, l, acc) take a leading C axis; the finite NEG_INF = -1e30 and the
// clamp max(l, 1e-30); output in q's dtype. Every table entry must be a
// valid page id; idle rows point all entries at the trash page, and a
// fully masked query comes out as the mean of v over the row's slots, as
// in the plain version (ref.py). No page is skipped.
//
// What bounds it on this card: bytes. It must read each page a row names
// once per kv head (2 * page * K * hd elements a page) and does about
// 4 * G * C flops per element read, still far below the H100's balance
// point for LISA-7B's G = 1, C = 4 or 5. Rows that share prefix pages read
// them once each here; a lower bound counts each distinct page once.
//
// What the design does about that:
//   * One CTA per (batch row, kv head) serves all G * C queries that read
//     that kv head, up to kMaxGroup = 8 of them: each page is read from
//     device memory once per CTA and scored against every chunk position,
//     which is the point of verifying k drafts in one pass instead of k+1
//     decode steps. Where G * C > kMaxGroup the queries are split over
//     ceil(G * C / kMaxGroup) CTAs, each reading the pages again.
//   * The page table is staged in shared memory once per CTA and the
//     public (P, page, K, hd) pool is read in place through its strides,
//     as in paged_decode_attention.cu (PagedRows).
//   * Each query keeps its own q row, bias row pointer and online-softmax
//     state in registers; each warp walks a strided share of the slots
//     with kUnroll loads in flight; partial states merge once through
//     shared memory.
//
// Left for later work: tensor-core products (wgmma) of a page tile against
// the C queries, cp.async/TMA staging of whole pages, split-K over the
// slots when B * K is small, and reading a shared prefix page once for all
// rows that name it.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// The queries of one CTA: the flattened pairs j0 .. j0+n-1 of the G * C
// (chunk position c, query head g) pairs of kv head kh, j = c * G + g.
// q and out are (B, C, H, HD) contiguous; the bias row of position c is
// bias_b + c * bias_sc.
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

// CTA grid: blockIdx.x = kv head * ceil(G * C / kMaxGroup) + query chunk,
// blockIdx.y = batch row b. q (B, C, H, HD) contiguous; k_pool/v_pool
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
    case 128:
      paged_verify_attention_kernel<T, 128><<<grid, block, smem, stream>>>(
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
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, tb, bf, out, B, C,
                                       H, K, n_pages, page, hd, k_sp, k_ss,
                                       v_sp, v_ss, table_sb, bias_sb,
                                       bias_sc, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
