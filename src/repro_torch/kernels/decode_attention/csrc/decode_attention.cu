// Flash-decode attention for Hopper (sm_90a): one query token per
// (batch row, query head) against a contiguous ring KV cache.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py:decode_call
//   (body _decode_kernel, wrapper ops.py:decode_attention).
// It computes the same function: scores q.k * scale in float32, plus an
// additive float32 bias per cache slot, an online softmax with the finite
// NEG_INF = -1e30 and the clamp max(l, 1e-30), then P.V in float32, written
// once in q's dtype. A fully masked row therefore comes out finite: the mean
// of v over the row's W slots, as in the plain version (ref.py).
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
//   * A warp owns one slot at a time; lane i holds elements i, i+32, ... of
//     the head dimension, so each load instruction of the warp reads 32
//     neighbouring elements. Each warp keeps kUnroll slots' loads in flight
//     and its own running (m, l, acc) in float32 registers; the kWarps
//     partial states are merged once through shared memory at the end.
//
// Left for later work: split-K over W when B * K is small (the grid has
// only B * K CTAs), cp.async/TMA staging, and a CUDA graph over the layers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // warps per CTA
constexpr int kUnroll = 4;     // cache slots each warp has in flight
constexpr int kMaxGroup = 8;   // query heads served by one CTA
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// q (B, H, HD) contiguous; k/v (B, W, K, HD) with unit stride over HD and
// stride HD over K; bias (B, W) float32 with unit stride over W; out like q.
// Query head h = kh * G + g reads kv head kh (kv-major grouping).
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int H, int K, int W, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, long long bias_sb,
                        float scale) {
  constexpr int VEC = HD / 32;
  const int G = H / K;
  const int n_chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int kh = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x % n_chunks) * kMaxGroup;
  const int gc = min(kMaxGroup, G - g0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long head0 = (long long)b * H + (long long)kh * G + g0;

  float qr[kMaxGroup][VEC];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][VEC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[g][i] = g < gc ? to_f32(q[(head0 + g) * HD + i * 32 + lane]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const T* kb = k + (long long)b * k_sb + (long long)kh * HD;
  const T* vb = v + (long long)b * v_sb + (long long)kh * HD;
  const float* bb = bias + (long long)b * bias_sb;

  for (int t0 = warp * kUnroll; t0 < W; t0 += kWarps * kUnroll) {
    float kx[kUnroll][VEC], vx[kUnroll][VEC], bx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      bx[u] = kNegInf;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        kx[u][i] = 0.f;
        vx[u][i] = 0.f;
      }
      if (t < W) {
        const T* kr = kb + (long long)t * k_st;
        const T* vr = vb + (long long)t * v_st;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kx[u][i] = to_f32(kr[i * 32 + lane]);
          vx[u][i] = to_f32(vr[i * 32 + lane]);
        }
        bx[u] = bb[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < W) {  // uniform across the warp
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < gc) {
            float d = 0.f;
#pragma unroll
            for (int i = 0; i < VEC; ++i) d = fmaf(qr[g][i], kx[u][i], d);
            const float s = warp_sum(d) * scale + bx[u];
            const float m_new = fmaxf(m[g], s);
            const float alpha = expf(m[g] - m_new);
            const float p = expf(s - m_new);
            l[g] = l[g] * alpha + p;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              acc[g][i] = fmaf(p, vx[u][i], acc[g][i] * alpha);
            }
            m[g] = m_new;
          }
        }
      }
    }
  }

  // merge the kWarps partial softmax states
  __shared__ float sm_m[kWarps][kMaxGroup];
  __shared__ float sm_l[kWarps][kMaxGroup];
  __shared__ float sm_acc[kWarps][kMaxGroup][HD];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < gc) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][i * 32 + lane] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gc * HD; idx += blockDim.x) {
    const int g = idx / HD;
    const int e = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      den = fmaf(sm_l[w][g], f, den);
      num = fmaf(sm_acc[w][g][e], f, num);
    }
    store_f32(num / fmaxf(den, 1e-30f), out + (head0 + g) * HD + e);
  }
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
