// Bottleneck decode for Hopper (sm_90a): the cloud side of the split
// point, int8 codes dequantised and projected back to full width.
//
// Replaces the TPU kernel
//   src/repro/kernels/bottleneck/bottleneck.py:decode_call
//   (body _decode_kernel, wrapper ops.py:bottleneck_decode).
// It computes the same function: z = float(code) * scale per element, in
// the reference's order, then z @ w in float32 (w upcast from float32 or
// bf16), written once in the output dtype.
//
// What bounds it on this card: operations. At LISA-7B's split point
// (T = 4096, r up to 1278, d = 1280) the product is 2*T*r*d = 13.4 GFLOP in
// float32 against 22 MB of codes, scales, weight and bf16 output.
//
// What the design does about that: one CTA per (32 rows, 256 output
// columns) tile runs the shared float32 tile product (bottleneck_gemm.cuh,
// 8 x 4 outputs a thread) with the dequantisation fused into its A loader,
// so the float32 z is never written to device memory: the codes are read
// as int8 and scaled on their way into shared memory. The ragged edges of T and d are masked here (no
// padding of T, as the reference's wrapper does). Tensor-core products and
// cp.async / TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bottleneck_gemm.cuh"

namespace {

using namespace bottleneck;

constexpr int kRPT = 8;                   // rows a thread owns
constexpr int kBT = Tile<kRPT>::kRows;    // rows a CTA owns

// codes (T, r) int8 and scales (T,) float32 contiguous; w (r, d)
// contiguous; out (T, d) contiguous. Grid (ceil(d / kBN), ceil(T / kBT)).
template <typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
bottleneck_decode_kernel(const signed char* __restrict__ codes,
                         const float* __restrict__ scales,
                         const TW* __restrict__ w, int T, int r, int d,
                         TO* __restrict__ out) {
  __shared__ __align__(16) float stage[Tile<kRPT>::kStageFloats];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (lane / 8) * kRPT;
  const int c0 = warp * 32 + (lane % 8) * 4;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBT;
  auto a = [&](int rr, int kk) -> float {
    const int t = row0 + rr;
    return (t < T && kk < r)
               ? to_f32(codes[(long long)t * r + kk]) * scales[t] : 0.f;
  };
  float acc[kRPT][4];
  tile_product<kRPT>(a, w, d, r, d, n0, acc, stage);
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int t = row0 + r0 + i;
    if (t >= T) continue;
    TO* o = out + (long long)t * d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + c0 + j;
      if (c < d) store_f32(acc[i][j], o + c);
    }
  }
}

template <typename TW, typename TO>
int launch_typed(const void* codes, const void* scales, const void* w,
                 void* out, int T, int r, int d, cudaStream_t stream) {
  const dim3 grid((d + kBN - 1) / kBN, (T + kBT - 1) / kBT);
  bottleneck_decode_kernel<TW, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const signed char*>(codes),
      static_cast<const float*>(scales), static_cast<const TW*>(w), T, r, d,
      static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int launch_out(const void* codes, const void* scales, const void* w,
               void* out, int out_dtype, int T, int r, int d,
               cudaStream_t stream) {
  if (out_dtype == 0) {
    return launch_typed<TW, float>(codes, scales, w, out, T, r, d, stream);
  }
  if (out_dtype == 1) {
    return launch_typed<TW, __nv_bfloat16>(codes, scales, w, out, T, r, d,
                                           stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch
// (0 on success); the caller raises on anything else.
extern "C" int bottleneck_decode_launch(const void* codes, const void* scales,
                                        const void* w, void* out, int w_dtype,
                                        int out_dtype, int T, int r, int d,
                                        void* stream) {
  if (T <= 0 || r <= 0 || d <= 0 || (T + kBT - 1) / kBT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) {
    return launch_out<float>(codes, scales, w, out, out_dtype, T, r, d, s);
  }
  if (w_dtype == 1) {
    return launch_out<__nv_bfloat16>(codes, scales, w, out, out_dtype, T, r,
                                     d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
