// Bottleneck decode for Hopper (sm_90a): the cloud side of the split
// point, int8 codes dequantised and projected back to full width.
//
// Replaces the TPU kernel
//   src/repro/kernels/bottleneck/bottleneck.py:decode_call
//   (body _decode_kernel, wrapper ops.py:bottleneck_decode).
// It computes the same function, (codes * scale) @ w in float32 (w
// float32 or bf16), written once in the output dtype, with the scale taken
// out of the dot: y = scale * (codes @ w). The reference rounds code *
// scale to float32 before the dot; taking the scale out changes each term
// by at most one float32 rounding, far inside the decode tolerance
// (chip_smoke.py DECODE_TOL: float32 rtol 1e-5, bf16 one rounding).
//
// What bounds it on this card: operations. At LISA-7B's split point
// (T = 4096, r up to 1278, d = 1280) the product is 2*T*r*d = 13.4 GFLOP
// against 22 MB of codes, scales, weight and bf16 output. The codes are
// exact in bf16 and w is float32, so the tensor cores take it as three
// bf16 products (w split into hi + mid + lo, bottleneck_gemm.cuh): 40.2
// GFLOP at 989 TFLOP/s, 0.041 ms, against 0.200 ms for one float32 product
// on the CUDA cores.
//
// What the design does about that: the shared body's wgmma product
// (bottleneck_gemm.cuh), transposed: a CTA owns 256 output columns by 80
// tokens of y^T in registers (d = 1280 and T = 4096 give 5 x 52 = 260
// CTAs, just under two rounds of 132 SMs; 96 and 128 tokens took 8 % and
// 24 % longer, 64 a third round); the int8 codes are converted to bf16 on
// their way into shared memory, so the float32 z = codes * scale never
// exists; the epilogue multiplies each token's column by its scale and
// rounds once to the output dtype. The ragged edges of T and d are masked
// here (no padding of T, as the reference's wrapper does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bottleneck_gemm.cuh"

namespace {

using namespace bottleneck;

constexpr int kBN = 80;          // tokens a CTA

// codes (T, r) int8 as B rows and scales (T,) float32 contiguous; w (r,
// d), row stride d; out (T, d) contiguous. Grid (ceil(d / kTileM),
// ceil(T / kBN)).
template <typename TW, bool kShift, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_decode_kernel(Rows<signed char> codes,
                         const float* __restrict__ scales,
                         Weight<TW, kShift> w,
                         TO* __restrict__ out) {
  using S = Smem<TW, kBN, 1>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* s_s = reinterpret_cast<float*>(sm + S::kScale);
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kBN;
  const int T = codes.T, d = w.m_cols;
  if (threadIdx.x < kBN) {
    const int n = n0 + threadIdx.x;
    s_s[threadIdx.x] = n < T ? scales[n] : 0.f;
  }
  // (tile_product's first barrier orders s_s before the epilogue)
  float acc[2][kBN / 2];
  tile_product<kBN>(acc, w, m0, codes, n0, sm);
  const Lane ln;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ln.m(m0, mt, h);
      if (m >= d) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = ln.n(n0, j, e);
          if (n >= T) continue;
          store_f32(__fmul_rn(acc[mt][4 * j + 2 * h + e], s_s[n - n0]),
                    out + (long long)n * d + m);
        }
      }
    }
  }
}

template <typename TW, typename TO>
int launch_typed(const void* codes, const void* scales, const void* w,
                 void* out, int T, int r, int d, cudaStream_t stream) {
  const long long n_blocks = (T + kBN - 1) / kBN;
  if (n_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const signed char* cp = static_cast<const signed char*>(codes);
  const bool pairs = r % 2 == 0
                     && reinterpret_cast<uintptr_t>(cp) % 2 == 0;
  const Rows<signed char> rows{cp, r, T, r, pairs};
  const dim3 grid((d + kTileM - 1) / kTileM,
                  static_cast<unsigned>(n_blocks));
  return with_shift(w, (long long)d * sizeof(TW), [&](auto shifted) {
    constexpr bool kShift = decltype(shifted)::value;
    auto kernel = bottleneck_decode_kernel<TW, kShift, TO>;
    constexpr int bytes = Smem<TW, kBN, 1>::kBytes;
    static bool opted_in = false;   // once per instantiation
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in = true;
    }
    const Weight<TW, kShift> wt{static_cast<const TW*>(w), d, d};
    kernel<<<grid, kThreads, bytes, stream>>>(
        rows, static_cast<const float*>(scales), wt, static_cast<TO*>(out));
    return static_cast<int>(cudaGetLastError());
  });
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
  if (T <= 0 || r <= 0 || d <= 0) {
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
