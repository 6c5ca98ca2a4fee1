// Paged flash-decode attention for Hopper (sm_90a): one query token per
// (batch row, query head) against a KV cache that lives in a shared page
// pool, addressed through a per-row page table.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:paged_decode_call
//   (body _paged_decode_kernel, wrapper ops.py:paged_decode_attention).
// It computes the same function as the contiguous kernel over the row's
// virtual sequence of n_pages * page slots (flash_decode.cuh): virtual slot
// s is slot s % page of page table[b][s / page]. Every table entry must be
// a valid page id; idle rows point all entries at the trash page. No page
// is skipped, even when its bias masks it whole, so a fully masked row is
// the mean of v over all its slots, as in the plain version (ref.py).
//
// What bounds it on this card: bytes. Per step it must read each page a
// row names once per kv head (2 * page * K * hd elements a page) and does
// about 4 flops per element read. Rows that share prefix pages read them
// once each here; a lower bound counts each distinct page once.
//
// What the design does about that:
//   * One CTA per (batch row, kv head, group of up to kMaxGroup query
//     heads), as in decode_attention.cu: all query heads of a kv head share
//     each k/v load.
//   * The TPU kernel resolves the page table by scalar prefetch into its
//     BlockSpec index maps. Here the CTA stages its row's n_pages table
//     entries in shared memory once, and each warp computes the address of
//     virtual slot s as
//       pool + table[s / page] * stride_page + (s % page) * stride_slot
//            + kv_head * hd,
//     reading the public (P, page, K, hd) pool in place: no gathered copy,
//     no transposed pool.
//   * Each warp walks a strided share of the virtual slots with kUnroll
//     loads in flight and its own online-softmax state in registers; the
//     partial states are merged once through shared memory.
//
// Left for later work: cp.async/TMA staging of whole pages, and reading a
// shared prefix page once for all rows that name it.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

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
    case 128:
      paged_decode_attention_kernel<T, 128><<<grid, block, smem, stream>>>(
          qt, kt, vt, table, bias, ot, H, K, n_pages, page, k_sp, k_ss, v_sp,
          v_ss, table_sb, bias_sb, scale);
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
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* out, int dtype, int B, int H, int K, int n_pages,
    int page, int hd, long long k_sp, long long k_ss, long long v_sp,
    long long v_ss, long long table_sb, long long bias_sb, float scale,
    void* stream) {
  if (B <= 0 || K <= 0 || n_pages <= 0 || page <= 0 || H % K != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tb = static_cast<const int*>(table);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(q, k_pool, v_pool, tb, bf, out, B, H, K,
                               n_pages, page, hd, k_sp, k_ss, v_sp, v_ss,
                               table_sb, bias_sb, scale, s);
  }
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, tb, bf, out, B, H,
                                       K, n_pages, page, hd, k_sp, k_ss,
                                       v_sp, v_ss, table_sb, bias_sb, scale,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
