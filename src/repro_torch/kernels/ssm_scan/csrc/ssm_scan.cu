// Selective scan for Hopper (sm_90a): the Mamba recurrence
// h_t = decay_t * h_{t-1} + drive_t over the sequence axis, from h = 0.
//
// Replaces the TPU kernel
//   src/repro/kernels/ssm_scan/ssm_scan.py:scan_call
//   (body _scan_kernel, wrapper ops.py:chunked_scan).
// It computes the same function: decay and drive (B, S, C, N) in float32
// or bf16, upcast to float32, h (B, S, C, N) float32. Each step is a
// multiply and then an add, each rounded (__fmul_rn / __fadd_rn, so nvcc
// cannot contract them into one fused multiply-add): the plain version
// (ref.py:scan_ref) rounds in the same two places, and the two agree bit
// for bit.
//
// What bounds it on this card: bytes. Every element of decay and drive is
// read once and every h written once (12 B an element in float32), for
// one multiply and one add: far below the card's balance point. At
// falcon-mamba-7b's prefill (B = 2, S = 1024, C = 8192, N = 16) that is
// 3.2 GB a launch.
//
// What the design does about that:
//   * One thread per (batch row, c * N + n) lane, carrying its h in a
//     register down the whole sequence. The TPU kernel's grid walked
//     chunks of 64 steps in order with h in VMEM scratch; here there is
//     no cross-CTA state at all, so no chunking and no padding of S or C.
//   * The lanes of a CTA are consecutive over the flat c * N + n, so each
//     step's loads and stores are coalesced (128 B a warp in float32).
//   * The loads of kUnroll steps do not depend on h: they are issued
//     together ahead of the dependent chain, so each thread keeps
//     2 * kUnroll loads in flight. Loads and stores are streaming
//     (read or written once, evict first).
//   * Offsets are 64-bit: B * S * C * N passes 2^31 at the path's shapes.
//
// Left for later work: fusing the decay / drive construction and the
// contraction of h with C into the scan, so that the (B, S, C, N) tensors
// never reach device memory (PERF.md, open questions).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) {
  return __ldcs(p);
}

// bf16 is the upper half of a float32: widen the bits.
__device__ __forceinline__ float load_f32(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldcs(p)) << 16);
}

// decay / drive / h (B, S, L) contiguous, L = C * N. Grid
// (ceil(L / kThreads), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ decay, const T* __restrict__ drive,
                float* __restrict__ h, long long S, long long L) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= L) return;
  const long long base = (long long)blockIdx.y * S * L + lane;
  const T* dp = decay + base;
  const T* xp = drive + base;
  float* hp = h + base;
  float acc = 0.f;
  long long t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float d[kUnroll], x[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      d[i] = load_f32(dp + (t + i) * L);
      x[i] = load_f32(xp + (t + i) * L);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      acc = __fadd_rn(__fmul_rn(d[i], acc), x[i]);
      __stcs(hp + (t + i) * L, acc);
    }
  }
  for (; t < S; ++t) {
    acc = __fadd_rn(__fmul_rn(load_f32(dp + t * L), acc),
                    load_f32(xp + t * L));
    __stcs(hp + t * L, acc);
  }
}

template <typename T>
int launch_typed(const void* decay, const void* drive, void* h, long long B,
                 long long S, long long L, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((L + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(B));
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(decay), static_cast<const T*>(drive),
      static_cast<float*>(h), S, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// decay / drive (B, S, C, N) contiguous, both of dtype 0 (float32) or 1
// (bf16); h (B, S, C, N) float32 contiguous; L = C * N. Returns the
// launch's CUDA error, 0 on success.
extern "C" int ssm_scan_launch(const void* decay, const void* drive, void* h,
                               int dtype, long long B, long long S,
                               long long L, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || L <= 0 ||
      (L + kThreads - 1) / kThreads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(decay, drive, h, B, S, L, s);
  if (dtype == 1) {
    return launch_typed<unsigned short>(decay, drive, h, B, S, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
