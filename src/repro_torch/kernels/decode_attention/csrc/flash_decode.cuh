// The flash-decode body shared by the contiguous and the paged decode
// kernels of this directory (decode_attention.cu, paged_decode_attention.cu).
//
// One CTA serves one (batch row, kv head, group of up to kMaxGroup query
// heads). It computes, for each of its query heads, scores q.k * scale in
// float32 plus an additive float32 bias per virtual slot, an online softmax
// with the finite NEG_INF = -1e30 and the clamp max(l, 1e-30), and P.V in
// float32, written once in q's dtype. A fully masked row therefore comes out
// finite: the mean of v over the row's W slots, as in the plain versions
// (ref.py).
//
// Where slot t of the row lives is the caller's addressing policy `Rows`:
// rows.k(t) and rows.v(t) give the element offset of slot t's (K, HD) row,
// to which the body adds kv_head * HD. The contiguous kernel adds a batch
// and a slot stride; the paged kernel looks the slot's page up in a page
// table it has staged in shared memory.
//
// A warp owns one slot at a time; lane i holds elements i, i+32, ... of the
// head dimension, so each load instruction of the warp reads 32 neighbouring
// elements. Each warp keeps kUnroll slots' loads in flight and its own
// running (m, l, acc) in float32 registers over a strided share of the
// slots; the kWarps partial states are merged once through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_decode {

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

// CTA grid: blockIdx.x = kv head * ceil(G / kMaxGroup) + group chunk,
// blockIdx.y = batch row b. q (B, H, HD) contiguous; bias_row the row's W
// float32 biases with unit stride; out like q. Query head h = kh * G + g
// reads kv head kh (kv-major grouping).
template <typename T, int HD, typename Rows>
__device__ __forceinline__ void attend_row(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias_row,
    T* __restrict__ out, int H, int K, int W, const Rows& rows,
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

  const T* kh_base = k + (long long)kh * HD;
  const T* vh_base = v + (long long)kh * HD;

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
        const T* kr = kh_base + rows.k(t);
        const T* vr = vh_base + rows.v(t);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kx[u][i] = to_f32(kr[i * 32 + lane]);
          vx[u][i] = to_f32(vr[i * 32 + lane]);
        }
        bx[u] = bias_row[t];
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

}  // namespace flash_decode
