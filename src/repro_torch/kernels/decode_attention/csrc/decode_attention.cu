// Flash-decode attention for Hopper (sm_90a): one query token per
// (batch row, query head) against a contiguous ring KV cache.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:decode_call
//   (body _decode_kernel, wrapper ops.py:decode_attention).
// It computes the same function (flash_decode.cuh): scores, an additive
// float32 bias per cache slot, an online softmax with the finite
// NEG_INF = -1e30 and the clamp max(l, 1e-30), then P.V in float32.
//
// What bounds it on this card: bytes. Per step it must read the k and v
// cache once (2 * B * W * K * hd elements) and does about 4 flops per
// element read, far below the H100's ~20 flops/byte float32 balance point.
//
// What the design does about that:
//   * One CTA per (batch row, kv head, group of up to kMaxGroup query
//     heads). All G query heads of a kv head (G <= kMaxGroup) share the CTA,
//     so each k/v slot is read from device memory once per kv head, not once
//     per query head.
//   * The cache is read in place, in the reference's public (B, W, K, hd)
//     layout, through the batch and slot strides: no transposed copy and no
//     padding of W. The ragged tail is masked here (slots >= W are skipped).
//   * Each warp keeps kUnroll slots' loads in flight and its own online-
//     softmax state in registers (flash_decode.cuh).
//
// Left for later work: split-K over W when B * K is small (the grid has
// only B * K CTAs), cp.async/TMA staging, and a CUDA graph over the layers.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// Slot t of batch row b: a batch stride and a slot stride, in elements.
struct RingRows {
  int b;
  long long k_sb, k_st, v_sb, v_st;
  __device__ __forceinline__ long long k(int t) const {
    return (long long)b * k_sb + (long long)t * k_st;
  }
  __device__ __forceinline__ long long v(int t) const {
    return (long long)b * v_sb + (long long)t * v_st;
  }
};

// q (B, H, HD) contiguous; k/v (B, W, K, HD) with unit stride over HD and
// stride HD over K; bias (B, W) float32 with unit stride over W; out like q.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int H, int K, int W, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, long long bias_sb,
                        float scale) {
  const int b = blockIdx.y;
  const RingRows rows{b, k_sb, k_st, v_sb, v_st};
  attend<T, HD>(q, k, v, out, W, rows,
                decode_heads(H, K, bias + (long long)b * bias_sb), scale);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const float* bias, void* out, int B, int H, int K, int W,
                 int hd, long long k_sb, long long k_st, long long v_sb,
                 long long v_st, long long bias_sb, float scale,
                 cudaStream_t stream) {
  const int G = H / K;
  const dim3 grid(K * ((G + kMaxGroup - 1) / kMaxGroup), B);
  const dim3 block(kWarps * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32:
      decode_attention_kernel<T, 32><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
      break;
    case 64:
      decode_attention_kernel<T, 64><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
      break;
    case 128:
      decode_attention_kernel<T, 128><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
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
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int B, int H, int K, int W, int hd, long long k_sb,
    long long k_st, long long v_sb, long long v_st, long long bias_sb,
    float scale, void* stream) {
  if (B <= 0 || K <= 0 || W <= 0 || H % K != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(q, k, v, bf, out, B, H, K, W, hd, k_sb, k_st,
                               v_sb, v_st, bias_sb, scale, s);
  }
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(q, k, v, bf, out, B, H, K, W, hd,
                                       k_sb, k_st, v_sb, v_st, bias_sb, scale,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
