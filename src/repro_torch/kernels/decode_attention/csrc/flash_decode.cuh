// The flash-decode body of the verify kernel (paged_verify_attention.cu)
// and of the float32 decode kernels (decode_attention.cu,
// paged_decode_attention.cu); their bf16 kernels use split_decode.cuh.
//
// One CTA serves one (batch row, kv head) and a set of up to kMaxGroup
// queries that read that kv head: query heads of one token (decode), or
// query heads x chunk positions (verify). For each query it computes scores
// q.k * scale in float32 plus an additive float32 bias per virtual slot,
// an online softmax with the finite NEG_INF = -1e30 and the clamp
// max(l, 1e-30), and P.V in float32, written once in q's dtype. A fully
// masked query therefore comes out finite: the mean of v over the row's W
// slots, as in the plain versions (ref.py). Each k/v slot is read from
// device memory once per CTA and scored against every query of the set.
//
// Where slot t of the row lives is the caller's addressing policy `Rows`:
// rows.k(t) and rows.v(t) give the element offset of slot t's (K, HD) row,
// to which the body adds kv_head * HD. The contiguous kernel adds a batch
// and a slot stride; the paged kernels look the slot's page up in a page
// table staged in shared memory.
//
// Which queries the CTA serves is the caller's policy `Queries`: qs.kh is
// the kv head, qs.n the number of queries, qs.row(j) the (q, out) row of
// query j in units of HD elements, and qs.bias(j) its bias row over the W
// slots. Queries::kSharedBias says all queries read one bias row (decode:
// one row of biases per token), loaded once per slot; otherwise each query
// loads its own (verify: causal-within-chunk differs per position).
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

// Slot t of a row whose page ids sit in `table` (shared memory): page
// table[t / page], slot t % page, through the pool's page and slot strides.
struct PagedRows {
  const int* table;
  int page;
  long long k_sp, k_ss, v_sp, v_ss;
  __device__ __forceinline__ long long k(int t) const {
    const int pg = t / page;
    return (long long)table[pg] * k_sp + (long long)(t - pg * page) * k_ss;
  }
  __device__ __forceinline__ long long v(int t) const {
    const int pg = t / page;
    return (long long)table[pg] * v_sp + (long long)(t - pg * page) * v_ss;
  }
};

// Copy a row's n_pages page ids (unit stride) into shared memory, once per
// CTA, for PagedRows.
__device__ __forceinline__ void stage_table(int* sm_table,
                                            const int* __restrict__ row,
                                            int n_pages) {
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x) {
    sm_table[i] = row[i];
  }
  __syncthreads();
}

// The decode query set: query heads head0 .. head0+n-1 of one token, all
// reading kv head kh, sharing the token's bias row.
struct HeadGroup {
  static constexpr bool kSharedBias = true;
  int kh, n;
  long long head0;
  const float* bias_row;
  __device__ __forceinline__ long long row(int j) const { return head0 + j; }
  __device__ __forceinline__ const float* bias(int) const { return bias_row; }
};

// Decode grid: blockIdx.x = kv head * ceil(G / kMaxGroup) + group chunk,
// blockIdx.y = batch row b. q (B, H, HD); query head h = kh * G + g reads
// kv head kh (kv-major grouping).
__device__ __forceinline__ HeadGroup decode_heads(int H, int K,
                                                  const float* bias_row) {
  const int G = H / K;
  const int n_chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int kh = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x % n_chunks) * kMaxGroup;
  return HeadGroup{kh, min(kMaxGroup, G - g0),
                   (long long)blockIdx.y * H + (long long)kh * G + g0,
                   bias_row};
}

// q and out hold one HD-element row per query (qs.row); each bias row has
// unit stride over the W slots.
template <typename T, int HD, typename Rows, typename Queries>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int W,
                                       const Rows& rows, const Queries& qs,
                                       float scale) {
  constexpr int VEC = HD / 32;
  constexpr int NB = Queries::kSharedBias ? 1 : kMaxGroup;
  const int gc = qs.n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[kMaxGroup][VEC];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][VEC];
  const float* brow[NB];
#pragma unroll
  for (int g = 0; g < NB; ++g) brow[g] = qs.bias(g < gc ? g : 0);
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[g][i] = g < gc ? to_f32(q[qs.row(g) * HD + i * 32 + lane]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const T* kh_base = k + (long long)qs.kh * HD;
  const T* vh_base = v + (long long)qs.kh * HD;

  for (int t0 = warp * kUnroll; t0 < W; t0 += kWarps * kUnroll) {
    float kx[kUnroll][VEC], vx[kUnroll][VEC], bx[kUnroll][NB];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int g = 0; g < NB; ++g) bx[u][g] = kNegInf;
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
#pragma unroll
        for (int g = 0; g < NB; ++g) {
          if (NB == 1 || g < gc) bx[u][g] = brow[g][t];
        }
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
            const float s = warp_sum(d) * scale + bx[u][NB == 1 ? 0 : g];
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
    store_f32(num / fmaxf(den, 1e-30f), out + qs.row(g) * HD + e);
  }
}

}  // namespace flash_decode
