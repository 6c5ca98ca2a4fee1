// Bottleneck encode for Hopper (sm_90a): the split point's low-rank
// projection fused with per-token absmax int8 quantisation.
//
// Replaces the TPU kernel
//   src/repro/kernels/bottleneck/bottleneck.py:encode_call
//   (body _encode_kernel, wrapper ops.py:bottleneck_encode).
// It computes the same function: z = x @ w in float32 (x and w float32 or
// bf16), s = max|z| / 127 + 1e-8 per row, and codes clamp(rint(z / s),
// -127, 127) as int8 (round half to even, a true IEEE division: this file
// is built without fast math).
//
// What bounds it on this card: operations. At LISA-7B's split point
// (T = 4096 tokens a frame, d = 1280, r up to 1278) the product is
// 2*T*d*r = 13.4 GFLOP against 22 MB of bytes to move. x is bf16 and w
// float32, so the tensor cores take it as three bf16 products (w split
// into hi + mid + lo, bottleneck_gemm.cuh): 40.2 GFLOP at 989 TFLOP/s,
// 0.041 ms, against 0.200 ms for one float32 product on the CUDA cores.
//
// What the design does about that:
//   * The products run on wgmma from the shared body (bottleneck_gemm.cuh),
//     transposed: a CTA owns 256 rank columns by 96 tokens of z^T (64
//     where 96 would leave SMs idle), in registers.
//   * A token's scale needs all r of its z before any code is written, and
//     a z tile of 96 tokens at r = 1278 is 491 KB: more than an SM holds.
//     So the rank's column tiles of one token tile are a thread-block
//     cluster (five CTAs at r = 1278, two at 510, one at 254). Each CTA
//     takes its tokens' maxima over its own columns and pushes them into
//     every other CTA's shared memory (st.async, counted by an mbarrier);
//     each then quantises its own columns with the token's maximum over the
//     cluster. z never reaches device memory, as in the TPU kernel.
//   * A rank wider than a cluster of kMaxSplit CTAs holds (more than 2,048
//     columns) is walked: each CTA takes several column tiles, computes
//     their z once for the maxima and once more to quantise.
//   * The ragged tile (T not a multiple of 96, r not of 256) is masked
//     here: no padding of T, as the reference's wrapper does.
// The tensor cores add in their own order and precision, so a code can sit
// one step from the plain version's where z / s is near a .5 tie; the
// tests and chip_smoke.py hold that fraction under 1e-3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/device.cuh"
#include "bottleneck_gemm.cuh"

namespace {

using namespace bottleneck;

constexpr int kMaxSplit = 8;     // CTAs a cluster (the portable maximum)
constexpr int kMaxWalk = 8;      // column tiles a CTA walks at most

// The address of the same shared-memory location in cluster CTA `rank`.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// An mbarrier of one arrival that also waits for `bytes` of st.async
// stores, visible to the whole cluster.
__device__ __forceinline__ void mbar_init_expect(uint32_t bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for phase 0 of the mbarrier; maxima that never land fail the launch
// after a second instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  const uint64_t t0 = now_ns();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (!done && now_ns() - t0 > 1000000000ull) __trap();
  }
}

// 16 bytes into the shared memory of another cluster CTA, completing as
// many bytes of its mbarrier (both addresses in that CTA, from in_rank)
__device__ __forceinline__ void send4(uint32_t dst, uint32_t bar, float4 x) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar)
      : "memory");
}

// x (T, d) as B rows; w (d, r), row stride r; codes (T, r) int8 and
// scales (T,) float32 contiguous. Grid (split, ceil(T / BN)), a cluster of
// `split` CTAs along x: CTA `rank` owns column tiles rank, rank + split,
// ... (at most `walk`) of token tile blockIdx.y.
template <int BN, typename TX, typename TW, bool kShift>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_encode_kernel(Rows<TX> x, Weight<TW, kShift> w, int split,
                         int walk,
                         signed char* __restrict__ codes,
                         float* __restrict__ scales) {
  using S = Smem<TW, BN, parts<TX>()>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float (*red)[BN] = reinterpret_cast<float (*)[BN]>(sm + S::kRed);
  float (*peers)[BN] = reinterpret_cast<float (*)[BN]>(sm + S::kPeers);
  float* s_s = reinterpret_cast<float*>(sm + S::kScale);
  const uint32_t full = smem_addr(sm + S::kBar);
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int r = w.m_cols;
  const int n_tiles = (r + kTileM - 1) / kTileM;
  int n_own = 0;
  while (n_own < walk && rank + n_own * split < n_tiles) ++n_own;
  const Lane ln;

  // every other rank's maxima land here; the cluster barrier (arrived
  // here, waited for before the first send) orders the init before them
  if (split > 1) {
    if (tid == 0) mbar_init_expect(full, (split - 1) * BN * 4);
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  float acc[2][BN / 2];
  // one pass over the own tiles when there is one (z stays in registers),
  // else one for the maxima and one more to quantise
  const int steps = n_own == 1 ? 1 : 2 * n_own;
  for (int step = 0; step < steps; ++step) {
    const int m0 = (rank + (step % n_own) * split) * kTileM;
    tile_product<BN>(acc, w, m0, x, n0, sm);
    if (step < n_own) {
      // this tile's |z| maxima of each token: over a thread's values, the
      // lanes of a column (g), then the warps, into peers[rank]
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = fmaxf(fmaxf(fabsf(acc[0][4 * j + e]),
                                fabsf(acc[0][4 * j + 2 + e])),
                          fmaxf(fabsf(acc[1][4 * j + e]),
                                fabsf(acc[1][4 * j + 2 + e])));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (ln.g == 0) red[tid / 32][8 * j + 2 * ln.tq + e] = v;
        }
      }
      __syncthreads();
      if (tid < BN) {
        float v = step > 0 ? peers[rank][tid] : 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) v = fmaxf(v, red[i][tid]);
        peers[rank][tid] = v;
      }
      __syncthreads();
    }
    if (step == n_own - 1) {
      // ... into every other rank's peers[rank]
      if (split > 1) {
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        if (tid < (split - 1) * (BN / 4)) {
          const int to = tid / (BN / 4) + (tid / (BN / 4) >= rank);
          const int c = (tid % (BN / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(&peers[rank][c]);
          send4(in_rank(smem_addr(&peers[rank][c]), to), in_rank(full, to),
                v);
        }
        mbar_wait(full);
      }
      if (tid < BN) {
        float v = peers[0][tid];
        for (int i = 1; i < split; ++i) v = fmaxf(v, peers[i][tid]);
        const float s = __fadd_rn(__fdiv_rn(v, 127.f), 1e-8f);
        s_s[tid] = s;
        if (rank == 0 && n0 + tid < x.T) scales[n0 + tid] = s;
      }
      __syncthreads();
    }
    if (n_own == 1 || step >= n_own) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = ln.m(m0, mt, h);
          if (m >= r) continue;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = ln.n(n0, j, e);
              if (n >= x.T) continue;
              const float q = fminf(
                  fmaxf(rintf(__fdiv_rn(acc[mt][4 * j + 2 * h + e],
                                        s_s[n - n0])),
                        -127.f),
                  127.f);
              codes[(long long)n * r + m] = static_cast<signed char>(q);
            }
          }
        }
      }
    }
  }
}

template <int BN, typename TX, typename TW, bool kShift>
int launch_bn(Rows<TX> rows, Weight<TW, kShift> wt, signed char* codes,
              float* scales, cudaStream_t stream) {
  const int n_tiles = (wt.m_cols + kTileM - 1) / kTileM;
  const int walk = (n_tiles + kMaxSplit - 1) / kMaxSplit;
  const int split = (n_tiles + walk - 1) / walk;
  const long long n_blocks = (rows.T + BN - 1) / BN;
  if (walk > kMaxWalk || n_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = bottleneck_encode_kernel<BN, TX, TW, kShift>;
  constexpr int bytes = Smem<TW, BN, parts<TX>()>::kBytes;
  static bool opted_in = false;   // once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, static_cast<unsigned>(n_blocks), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, rows, wt, split,
                                             walk, codes, scales);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// BN = 96 tokens a CTA where that gives at least one CTA an SM, else 64
// (64 for a float32 x too: its three B parts). At r = 1278 and T = 4096,
// 96 gives 43 clusters of 5, two rounds of the clusters an H100 holds at
// once; 128 takes two rounds for a third more work a CTA, 80 three.
template <typename TX, typename TW>
int launch_typed(const void* x, long long x_rs, const void* w, int T, int d,
                 int r, void* codes, void* scales, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const bool pairs = x_rs % 2 == 0 && d % 2 == 0
                     && reinterpret_cast<uintptr_t>(xp) % (2 * sizeof(TX))
                            == 0;
  const Rows<TX> rows{xp, x_rs, T, d, pairs};
  signed char* c = static_cast<signed char*>(codes);
  float* s = static_cast<float*>(scales);
  const int n_tiles = (r + kTileM - 1) / kTileM;
  const int split = n_tiles < kMaxSplit ? n_tiles : kMaxSplit;
  int sms = 0;
  const cudaError_t err = cuda_device::sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool wide = parts<TX>() == 1 && split * ((T + 95) / 96) >= sms;
  return with_shift(w, (long long)r * sizeof(TW), [&](auto shifted) {
    const Weight<TW, decltype(shifted)::value> wt{
        static_cast<const TW*>(w), r, r};
    if constexpr (parts<TX>() == 1) {
      if (wide) return launch_bn<96>(rows, wt, c, s, stream);
    }
    return launch_bn<64>(rows, wt, c, s, stream);
  });
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
