// Flash-decode attention for Hopper (sm_90a): one query token per
// (batch row, query head) against a contiguous ring KV cache.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:decode_call
//   (body _decode_kernel, wrapper ops.py:decode_attention).
// It computes the same function (split_decode.cuh in bf16, flash_decode.cuh
// in float32): scores, an additive float32 bias per cache slot, a softmax
// with the finite NEG_INF = -1e30 and the clamp max(l, 1e-30), then P.V in
// float32.
//
// What bounds it on this card: bytes. Per step it must read the k and v
// cache once (2 * B * W * K * hd elements) and does about 4 flops per
// element read, far below the H100's ~20 flops/byte float32 balance point.
// At LISA-7B's decode (B = 4 or 1, K = 32, hd = 128, W = 208) that is
// 13.6 MB or 3.4 MB, 4 or 1 microseconds of HBM time: a launch this short
// is bound by how many bytes the card has in flight and by the chain of
// steps before its last byte lands, not by the rate.
//
// What the bf16 design does about that (split_decode.cuh):
//   * Split-K over a thread-block cluster: each (batch row, kv head, group
//     of up to kMaxGroup query heads) gets `split` CTAs, picked at launch
//     from B, K and W (LISA-7B B = 1: 32 x 8 CTAs, where one CTA a kv head
//     gave 32 for 132 SMs). Each CTA owns a contiguous range of slots and
//     sends its partial softmax state into rank 0's shared memory, which
//     merges the states in rank order; the other ranks leave at once.
//   * Bytes in flight without registers: a CTA's rows are copied into
//     shared memory by 16-byte cp.async (a whole 256-byte row per 16
//     lanes), kStage rows a lane group a step (64 slots a CTA at hd = 128),
//     so a CTA needs 56-64 registers at hd = 64 and 128 and the card
//     holds every CTA of the launch at once. At B = 4 a CTA owns 104
//     slots: two steps, whose copy rounds run one after the other (the
//     second is issued once the first is scored).
//   * One maximum, one rescale and one sum per tile of a lane group's
//     rows, the scale folded into a base-2 exponent; eight warps a CTA
//     share the arithmetic.
//   * All G query heads of a kv head (G <= kMaxGroup) share a cluster, so
//     each k/v slot is read once per kv head, not once per query head.
// The plan (ops.py:DecodePlan, picked by ops.py:decode_plan): SPLIT is the
// design above, in query sets of up to kMaxGroup = 8 on CUDA cores, and
// takes every G = 1 shape (LISA-7B's). SETS (split_decode.cuh:attend_set)
// takes G > 1: one cluster serves a kv head's whole query set (up to 16;
// nemotron-4-340b's G = 12 had taken two clusters of 8 and 4 under SPLIT,
// each reading the rows again), with q.k and P.V as tensor-core products
// (mma.sync m16n8k16, the set's queries as the 16 rows).
//   * The cache is read in place, in the reference's public (B, W, K, hd)
//     layout, through the batch and slot strides: no transposed copy and no
//     padding of W. The ragged tail is masked here. The strides and base
//     pointers must keep rows 16-byte aligned (the wrapper refuses others).
// float32 inputs (small test shapes, not on LISA-7B's path) keep the
// one-CTA-a-kv-head body of flash_decode.cuh: a warp a slot, kUnroll slots
// in flight a warp, partial states merged through shared memory.
//
// Head sizes 32, 64, 80, 112, 128 and 192 (zamba2-7b 112; nemotron-4-340b
// 192): SPLIT pads a row's lane group to a power of two of lanes, SETS
// takes every head size as whole k-steps of 16, and
// flash_decode.cuh's last load of a row covers part of a warp and, at
// hd = 192, merges its warps' accumulators in two rounds of query heads.
//
// Left for later work: what does not move with the bytes (about 4 us of
// launch, prologue, second copy round and merge at B = 4; a ring of two
// copy stages was measured and did not pay here), TMA copies (one 2-D box
// per CTA in place of its threads' cp.async), and a CUDA graph over the
// layers.

#include "flash_decode.cuh"
#include "split_decode.cuh"

namespace {

using namespace flash_decode;

// ops.py:DecodePlan
enum Plan { kFlashDecode = 0, kSplit = 1, kSets = 2 };

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

// The bf16 kernel: one cluster of `split` CTAs a (kv head, head chunk)
// along x, batch row b along y; CTA r folds slots [r W / split,
// (r + 1) W / split).
template <int HD, int NG>
__global__ void __launch_bounds__(split_decode::kThreads)
split_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int H, int K,
                              int W, long long k_sb, long long k_st,
                              long long v_sb, long long v_st,
                              long long bias_sb, float scale) {
  const split_decode::Place pl = split_decode::place(H / K);
  const int b = blockIdx.y;
  const RingRows rows{b, k_sb, k_st, v_sb, v_st};
  split_decode::attend<HD, NG>(
      q, k, v, out, rows,
      split_decode::head_queries(pl, H, K, bias + (long long)b * bias_sb),
      split_decode::part(W, pl.rank, pl.split),
      split_decode::part(W, pl.rank + 1, pl.split), pl, scale);
}

template <int HD, int NG>
struct SplitKernel {
  static auto fn() { return &split_decode_attention_kernel<HD, NG>; }
};

// The set kernel (plan SETS): one cluster of `split` CTAs a (kv head, set
// of up to kSetRows of its query heads) along x, batch row b along y; CTA
// r folds slots [r W / split, (r + 1) W / split).
template <int HD>
__global__ void __launch_bounds__(split_decode::kSetThreads, 2)
set_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, int H, int K,
                            int W, long long k_sb, long long k_st,
                            long long v_sb, long long v_st,
                            long long bias_sb, float scale) {
  const split_decode::Place pl =
      split_decode::place(H / K, split_decode::kSetRows);
  const int b = blockIdx.y;
  const RingRows rows{b, k_sb, k_st, v_sb, v_st};
  split_decode::attend_set<HD>(
      q, k, v, out, rows,
      split_decode::head_queries(pl, H, K, bias + (long long)b * bias_sb),
      split_decode::part(W, pl.rank, pl.split),
      split_decode::part(W, pl.rank + 1, pl.split), pl, scale);
}

template <int HD>
struct SetKernel {
  static_assert(split_decode::SetSmem<HD>::kBytes <= split_decode::kBlockSmem,
                "over the 227 KB a block may use");
  static auto fn() { return &set_decode_attention_kernel<HD>; }
};

// plan: ops.py:DecodePlan (SPLIT: Sizes<1, kMaxGroup>, the split at most
// one CTA per kMinSlots slots; SETS: sets of kSetRows, the split at most
// max_split, which SPLIT refuses).
int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, void* out, int B, int H, int K, int W,
                int hd, long long k_sb, long long k_st, long long v_sb,
                long long v_st, long long bias_sb, float scale, int plan,
                int max_split, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (!split_decode::aligned16({q, k, v}, {k_sb, k_st, v_sb, v_st})) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (plan == kSplit && max_split == 0) {
    return static_cast<int>(split_decode::launch_split<SplitKernel>(
        split_decode::Sizes<1, split_decode::kMaxGroup>{}, H / K, hd, B, K,
        W / split_decode::kMinSlots, stream,
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), bias, static_cast<bf*>(out), H, K, W, k_sb,
        k_st, v_sb, v_st, bias_sb, scale));
  }
  if (plan == kSets && max_split >= 1) {
    return static_cast<int>(split_decode::launch_sets<SetKernel>(
        H / K, hd, B, K, max_split < W ? max_split : W, stream,
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), bias, static_cast<bf*>(out), H, K, W, k_sb,
        k_st, v_sb, v_st, bias_sb, scale));
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
    case 80:
      decode_attention_kernel<T, 80><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
      break;
    case 112:
      decode_attention_kernel<T, 112><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
      break;
    case 128:
      decode_attention_kernel<T, 128><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
      break;
    case 192:
      decode_attention_kernel<T, 192><<<grid, block, 0, stream>>>(
          qt, kt, vt, bias, ot, H, K, W, k_sb, k_st, v_sb, v_st, bias_sb,
          scale);
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
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int B, int H, int K, int W, int hd, long long k_sb,
    long long k_st, long long v_sb, long long v_st, long long bias_sb,
    float scale, int plan, int max_split, void* stream) {
  if (B <= 0 || K <= 0 || W <= 0 || H % K != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && plan == kFlashDecode && max_split == 0) {
    return launch_typed<float>(q, k, v, bf, out, B, H, K, W, hd, k_sb, k_st,
                               v_sb, v_st, bias_sb, scale, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k, v, bf, out, B, H, K, W, hd, k_sb, k_st, v_sb,
                       v_st, bias_sb, scale, plan, max_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split a SETS launch of B rows, H query heads over K kv heads at head
// dim hd takes with `most` its cap (decode: min(max_split, W); paged:
// min(max_split, n_pages)), into *split; returns the CUDA error of the
// query (0 on success).
extern "C" int decode_attention_set_split(int B, int H, int K,
                                          int hd, int most,
                                          int* split) {
  if (B <= 0 || K <= 0 || H % K != 0 || most < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      split_decode::set_splits<SetKernel>(H / K, hd, B, K, most, split));
}
