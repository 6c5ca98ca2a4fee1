// Bottleneck encode for Hopper (sm_90a): the split point's low-rank
// projection fused with per-token absmax int8 quantisation.
//
// Replaces the TPU kernel
//   src/repro/kernels/bottleneck/bottleneck.py:encode_call
//   (body _encode_kernel, wrapper ops.py:bottleneck_encode).
// It computes the same function: x (T, d) and w (d, r) upcast to float32,
// z = x @ w in float32, s = max|z| / 127 + 1e-8 per row, and codes
// clamp(rint(z / s), -127, 127) as int8 (round half to even, a true IEEE
// division: this file is built without fast math).
//
// What bounds it on this card: operations. At LISA-7B's split point
// (T = 4096 tokens a frame, d = 1280, r up to 1278) the product is
// 2*T*d*r = 13.4 GFLOP in float32 against 22 MB of bytes to move: about
// 600 flops a byte, far above the float32 balance point (~20).
//
// What the design does about that:
//   * A row's scale needs all r outputs of the row before any code is
//     written, so one CTA owns 4*RPT whole rows: it walks the r columns in
//     tiles of 256 (bottleneck_gemm.cuh) and keeps every z of its rows in
//     shared memory, then quantises from there. z never goes to device
//     memory; the activation is read once per column tile (from L2 after
//     the first), the weight once per CTA from L2, and only codes and
//     scales are written.
//   * The ragged tile (T not a multiple of the rows a CTA owns) is masked
//     here: no padding of T, as the reference's wrapper does.
//   * z of 16 rows x r = 1278 is 82 KB, above the 48 KB default, so the
//     launcher opts in to dynamic shared memory (two CTAs fit an SM), and
//     takes 8 rows a CTA where r is too wide for 16. With 16 rows a thread
//     holds 4 x 4 outputs: a warp's shared-memory reads (2 wavefronts a
//     reduction step) stay below its 16 fused multiply-adds.
// The products run in float32 on the CUDA cores, as the TPU kernel's
// float32 dot does; a TF32 or bf16 tensor-core product would change the
// codes, and is a later, separate decision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bottleneck_gemm.cuh"

namespace {

using namespace bottleneck;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

template <int RPT>
size_t encode_smem_bytes(int r) {
  return sizeof(float) * ((size_t)Tile<RPT>::kStageFloats +
                          (size_t)Tile<RPT>::kRows * r);
}

// x (T, d) with row stride x_rs and unit stride over d; w (d, r)
// contiguous; codes (T, r) int8 and scales (T,) float32 contiguous.
// Grid: ceil(T / (4*RPT)).
template <typename TX, typename TW, int RPT>
__global__ void __launch_bounds__(kThreads)
bottleneck_encode_kernel(const TX* __restrict__ x, long long x_rs,
                         const TW* __restrict__ w, int T, int d, int r,
                         signed char* __restrict__ codes,
                         float* __restrict__ scales) {
  constexpr int BT = Tile<RPT>::kRows;
  extern __shared__ __align__(16) float smem[];
  float* z_s = smem + Tile<RPT>::kStageFloats;   // BT x r
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (lane / 8) * RPT;
  const int c0 = warp * 32 + (lane % 8) * 4;
  const int row0 = blockIdx.x * BT;
  auto a = [&](int rr, int kk) -> float {
    const int t = row0 + rr;
    return (t < T && kk < d) ? to_f32(x[(long long)t * x_rs + kk]) : 0.f;
  };
  for (int n0 = 0; n0 < r; n0 += kBN) {
    float acc[RPT][4];
    tile_product<RPT>(a, w, r, d, r, n0, acc, smem);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + c0 + j;
        if (c < r) z_s[(r0 + i) * r + c] = acc[i][j];
      }
    }
  }
  __syncthreads();
  // warp w quantises rows w, w + kWarps, ...
  for (int rr = warp; rr < BT; rr += kWarps) {
    const int t = row0 + rr;
    if (t >= T) continue;
    const float* zr = z_s + (long long)rr * r;
    float mx = 0.f;
    for (int c = lane; c < r; c += 32) mx = fmaxf(mx, fabsf(zr[c]));
    mx = warp_max(mx);
    const float s = __fadd_rn(__fdiv_rn(mx, 127.f), 1e-8f);
    if (lane == 0) scales[t] = s;
    signed char* cr = codes + (long long)t * r;
    for (int c = lane; c < r; c += 32) {
      const float qv = fminf(fmaxf(rintf(__fdiv_rn(zr[c], s)), -127.f),
                             127.f);
      cr[c] = static_cast<signed char>(qv);
    }
  }
}

template <typename TX, typename TW, int RPT>
int launch_rpt(const void* x, long long x_rs, const void* w, int T, int d,
               int r, void* codes, void* scales, size_t bytes, int optin,
               cudaStream_t stream) {
  auto kernel = bottleneck_encode_kernel<TX, TW, RPT>;
  static bool opted_in = false;   // once per instantiation, to the limit
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  constexpr int BT = Tile<RPT>::kRows;
  kernel<<<(T + BT - 1) / BT, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), x_rs, static_cast<const TW*>(w), T, d, r,
      static_cast<signed char*>(codes), static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// 16 rows a CTA where their z fits the card's opt-in shared memory, else
// 8; an r too wide even for 8 is refused.
template <typename TX, typename TW>
int launch_typed(const void* x, long long x_rs, const void* w, int T, int d,
                 int r, void* codes, void* scales, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t limit = static_cast<size_t>(optin);
  if (encode_smem_bytes<4>(r) <= limit) {
    return launch_rpt<TX, TW, 4>(x, x_rs, w, T, d, r, codes, scales,
                                 encode_smem_bytes<4>(r), optin,
                                 stream);
  }
  if (encode_smem_bytes<2>(r) <= limit) {
    return launch_rpt<TX, TW, 2>(x, x_rs, w, T, d, r, codes, scales,
                                 encode_smem_bytes<2>(r), optin,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX>
int launch_w(const void* x, long long x_rs, const void* w, int w_dtype,
             int T, int d, int r, void* codes, void* scales,
             cudaStream_t stream) {
  if (w_dtype == 0) {
    return launch_typed<TX, float>(x, x_rs, w, T, d, r, codes, scales,
                                   stream);
  }
  if (w_dtype == 1) {
    return launch_typed<TX, __nv_bfloat16>(x, x_rs, w, T, d, r, codes,
                                           scales, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. x_rs is x's row stride in elements.
// Returns the CUDA error of the launch (0 on success); the caller raises
// on anything else.
extern "C" int bottleneck_encode_launch(const void* x, const void* w,
                                        void* codes, void* scales,
                                        int x_dtype, int w_dtype, int T,
                                        int d, int r, long long x_rs,
                                        void* stream) {
  if (T <= 0 || d <= 0 || r <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    return launch_w<float>(x, x_rs, w, w_dtype, T, d, r, codes, scales, s);
  }
  if (x_dtype == 1) {
    return launch_w<__nv_bfloat16>(x, x_rs, w, w_dtype, T, d, r, codes,
                                   scales, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
