// The tile product shared by the bottleneck kernels of this directory
// (bottleneck_encode.cu, bottleneck_decode.cu).
//
// A CTA of kThreads = 256 threads (8 warps) computes a (4 * RPT) x kBN tile
// of A @ W in float32 on the CUDA cores. Warp w owns columns
// w*32 .. w*32 + 31 of the tile; lane l owns tile rows (l / 8) * RPT ..
// + RPT - 1 and columns w*32 + (l % 8) * 4 .. + 3, so each thread
// accumulates RPT x 4 outputs in registers. The reduction runs in stages of
// kBK: the A stage, transposed (kBK x rows), and the W stage (kBK x kBN)
// sit in shared memory as float32. Per reduction step a thread reads its
// RPT values of A and 4 of W as float4 (a warp's reads are 4 and 8
// distinct 16-byte words: one shared-memory wavefront each), against
// 4 * RPT fused multiply-adds. While a stage is consumed, the next one's
// global loads are already in flight into registers. Each output sums its
// products in ascending order of the reduction index with fmaf, the order
// of cuBLAS's float32 GEMM on this card.
//
// Where A comes from is the caller's policy: a(row, k) returns the float32
// value of tile row `row` at reduction index k, or 0 past the edge: the
// encode kernel upcasts the activation, the decode kernel dequantises int8
// codes with their row's scale. W is (depth, n_cols) with row stride w_rs,
// upcast on load; columns past n_cols read as 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bottleneck {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 256;    // output columns per tile: 8 warps x 32
constexpr int kBK = 16;     // reduction depth per stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(signed char x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// The tile's geometry for RPT rows a thread: 4 * RPT rows a CTA, the A
// stage's row pitch (a multiple of 4 floats, so float4 reads stay aligned),
// and the shared floats of both stages.
template <int RPT>
struct Tile {
  static_assert(RPT == 2 || RPT % 4 == 0, "RPT is 2 or a multiple of 4");
  static constexpr int kRows = 4 * RPT;
  static constexpr int kAPitch = kRows + 4;
  static constexpr int kStageFloats = kBK * kAPitch + kBK * kBN;
  static constexpr int kALoads = (kRows * kBK + kThreads - 1) / kThreads;
  static constexpr int kWLoads = kBK * kBN / kThreads;
};

// acc[i][j] = sum over k < depth, ascending, of
//   a((lane/8)*RPT + i, k) * W(k, n0 + warp*32 + (lane%8)*4 + j).
// `stage` is 16-byte aligned shared memory of Tile<RPT>::kStageFloats.
template <int RPT, typename ALoad, typename TW>
__device__ __forceinline__ void tile_product(const ALoad& a,
                                             const TW* __restrict__ w,
                                             long long w_rs, int depth,
                                             int n_cols, int n0,
                                             float (&acc)[RPT][4],
                                             float* stage) {
  using G = Tile<RPT>;
  float* a_s = stage;                     // kBK x kAPitch, A transposed
  float* w_s = stage + kBK * G::kAPitch;  // kBK x kBN
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = (lane / 8) * RPT;
  const int c0 = warp * 32 + (lane % 8) * 4;
  float a_reg[G::kALoads], w_reg[G::kWLoads];

  // stage k0's global loads into registers: A element e = tid + i*kThreads
  // is (row e / kBK, k e % kBK); W element (k i, column tid)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < G::kALoads; ++i) {
      const int e = tid + i * kThreads;
      a_reg[i] = e < G::kRows * kBK ? a(e / kBK, k0 + e % kBK) : 0.f;
    }
    const int c = n0 + tid;
#pragma unroll
    for (int i = 0; i < G::kWLoads; ++i) {
      const int kk = k0 + i;
      w_reg[i] = (kk < depth && c < n_cols)
                     ? to_f32(w[(long long)kk * w_rs + c]) : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  fetch(0);
  for (int k0 = 0; k0 < depth; k0 += kBK) {
    __syncthreads();                      // the previous stage is consumed
#pragma unroll
    for (int i = 0; i < G::kALoads; ++i) {
      const int e = tid + i * kThreads;
      if (e < G::kRows * kBK) a_s[(e % kBK) * G::kAPitch + e / kBK] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < G::kWLoads; ++i) w_s[i * kBN + tid] = w_reg[i];
    __syncthreads();
    if (k0 + kBK < depth) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[RPT];
      const float* ar = &a_s[kk * G::kAPitch + r0];
      if constexpr (RPT == 2) {
        const float2 x = *reinterpret_cast<const float2*>(ar);
        av[0] = x.x;
        av[1] = x.y;
      } else {
#pragma unroll
        for (int i = 0; i < RPT; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(ar + i);
          av[i] = x.x;
          av[i + 1] = x.y;
          av[i + 2] = x.z;
          av[i + 3] = x.w;
        }
      }
      const float4 b = *reinterpret_cast<const float4*>(&w_s[kk * kBN + c0]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
  }
}

}  // namespace bottleneck
