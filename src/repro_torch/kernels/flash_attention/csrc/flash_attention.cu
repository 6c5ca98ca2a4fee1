// Blocked GQA attention over the full sequence for Hopper (sm_90a): q
// (B, S, H, hd) against k/v (B, S, K, hd), causal or not.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:flash_call
//   (body _flash_kernel, wrapper ops.py:flash_attention).
// It computes the same function: scores q.k * (1/sqrt(hd)) in float32;
// keys at or past S masked (the reference's valid_len), and keys after the
// query masked when causal, both with the finite NEG_INF = -1e30; the
// softmax's max, sum and probabilities in float32, the probabilities kept
// in float32 through P.V, normalised by max(l, 1e-30); kv tiles wholly
// above the diagonal skipped; one rounding of the output to q's dtype.
// Query head h reads kv head h / (H / K).
//
// What bounds it on this card: at LISA-7B's prefill (S = 204, hd = 128,
// bf16) bytes. q, k, v and the output are 4 * B*S*H*hd elements, read or
// written once; the causal product is 4 * B*H*hd * S(S+1)/2 flops, about 51
// flops a byte, below the tensor cores' ~295 flops/byte balance point.
//
// What the design does about that, kept simple for a first kernel:
//   * One CTA per (tile of BQ queries, query head, batch row) reads its q
//     tile once and each k and v tile of the causal triangle once; scores
//     and probabilities never leave shared memory.
//   * q, k and v are read in place in the public (B, S, heads, hd) layout
//     through their batch and sequence strides: no kv-major transpose and
//     no padding of S. Rows at or past S are never read (zeros in shared
//     memory), so what lies past S in the caller's buffer cannot leak in.
//   * Two kernels share the tile loads and the two products. Where a q
//     tile's 32 score rows fit shared memory (S up to about 1,400 at
//     hd = 128, 83,968 bytes at LISA-7B's S = 204), the row-resident kernel
//     holds them and normalises before P.V, in the order of the plain
//     version on this card: q.k as fused multiply-adds in head-dim order
//     then one multiply by the scale, as cuBLAS's float32 GEMM does; the
//     row's exps summed lane-strided over a warp, then a butterfly, as
//     PyTorch's warp softmax does; p = e / l; P.V as fused multiply-adds
//     in key order. Each step rounds where the plain version rounds, so
//     the two agree bit for bit where both libraries keep those orders.
//     The running form rounds elsewhere, and its few outputs a launch a
//     bf16 step off the plain version's grew through LISA-7B's 32
//     random-weight layers into mask logits past the split-point check's
//     2^-5 (PERF.md, PR 16).
//   * Longer sequences take the online kernel, the TPU kernel's running
//     (m, l, acc) per row with one kv tile's scores in shared memory, so
//     any S runs. It agrees with the plain version to float32 rounding
//     before the output's one rounding, not bit for bit (PyTorch's softmax
//     past 1,024 keys is a block reduction in another order anyway).
//   * The products run on the CUDA cores in float32, operands read from
//     padded shared memory as float4 without bank conflicts. Tensor-core
//     tiles (mma / wgmma) and cp.async / TMA staging are later work.
// Both kernels take more than the 48 KB default of shared memory at
// hd = 128, so the launcher opts each instantiation in to the card's limit
// once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Row pitches in floats: q and k/v tiles padded to HD + 4 (float4 reads of
// neighbouring rows fall on different banks), the score rows to a whole
// number of kv tiles plus 4.
template <int HD>
__host__ __device__ constexpr int tile_pitch() { return HD + 4; }

__host__ __device__ inline int score_pitch(int S) {
  return (S + kBK - 1) / kBK * kBK + 4;
}

// Shared memory of a CTA: q and kv tiles, then the row-resident kernel's
// score rows, or the online kernel's one tile of scores and its m, l and
// alpha per row.
template <int HD>
size_t smem_bytes(int BQ, int S, bool online) {
  const size_t scores = online ? (size_t)BQ * (kBK + 4) + 3 * BQ
                               : (size_t)BQ * score_pitch(S);
  return sizeof(float) * ((size_t)(BQ + kBK) * tile_pitch<HD>() + scores);
}

// Load rows [t0, t0 + rows) of a (.., S, heads, HD) operand into `dst`
// (rows x pitch floats), zeros at or past S.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s_stride, int t0,
                                          int rows, int S) {
  constexpr int P = tile_pitch<HD>();
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r;
    dst[r * P + d] = t < S ? to_f32(src[(long long)t * s_stride + d]) : 0.f;
  }
}

// Scores of the CTA's rows ty*RPT + i against the kv tile's keys
// tx + 16*j, each a chain of fused multiply-adds in head-dim order, then
// one multiply by scale, stored at s_s[row * SP + tx + 16*j].
template <int HD, int BQ>
__device__ __forceinline__ void score_tile(const float* q_s,
                                           const float* kv_s, float* s_s,
                                           int SP, float scale) {
  constexpr int P = tile_pitch<HD>();
  constexpr int RPT = BQ / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[RPT], c[4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = ld4(&q_s[(ty * RPT + i) * P + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = ld4(&kv_s[(tx + 16 * j) * P + d]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_s[(ty * RPT + i) * SP + tx + 16 * j] = __fmul_rn(s[i][j], scale);
    }
  }
}

// acc += P.V over the tile's first n_keys keys, for rows ty*RPT + i and
// columns g*16*VW + tx*VW + e: fused multiply-adds in key order, the
// probabilities read from p_s[row * SP + key].
template <int HD, int BQ>
__device__ __forceinline__ void pv_tile(float (&acc)[BQ / 16][HD / 16],
                                        const float* p_s, int SP,
                                        const float* kv_s, int n_keys) {
  constexpr int P = tile_pitch<HD>();
  constexpr int RPT = BQ / 16;
  constexpr int CPT = HD / 16;
  constexpr int VW = CPT < 4 ? CPT : 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int c = 0; c < n_keys; ++c) {
    float pp[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) pp[i] = p_s[(ty * RPT + i) * SP + c];
    const float* vr = &kv_s[c * P + tx * VW];
#pragma unroll
    for (int g = 0; g < CPT / VW; ++g) {
      float vv[VW];
      if constexpr (VW == 4) {
        const float4 x = ld4(vr + g * 16 * VW);
        vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) vv[e] = vr[g * 16 * VW + e];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          acc[i][g * VW + e] = fmaf(pp[i], vv[e], acc[i][g * VW + e]);
        }
      }
    }
  }
}

// Row ty*RPT + i of the output: acc[i] / l (l = 1 where already
// normalised), rows at or past S not written.
template <typename T, int HD, int BQ>
__device__ __forceinline__ void store_rows(
    const float (&acc)[BQ / 16][HD / 16], const float* l_s, T* out, int b,
    int q0, int S, int H, int h) {
  constexpr int RPT = BQ / 16;
  constexpr int CPT = HD / 16;
  constexpr int VW = CPT < 4 ? CPT : 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int t = q0 + r;
    if (t >= S) continue;
    const float l = l_s == nullptr ? 1.f : fmaxf(l_s[r], 1e-30f);
    T* o = out + (((long long)b * S + t) * H + h) * HD + tx * VW;
#pragma unroll
    for (int g = 0; g < CPT / VW; ++g) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float x = acc[i][g * VW + e];
        store_f32(l_s == nullptr ? x : __fdiv_rn(x, l), o + g * 16 * VW + e);
      }
    }
  }
}

// The row-resident kernel, for S whose BQ score rows fit shared memory.
// q (B, S, H, HD), k/v (B, S, K, HD): unit stride over HD, stride HD over
// heads, batch and sequence strides as given (elements). out (B, S, H, HD)
// contiguous. Grid (ceil(S / BQ), H, B).
template <typename T, int HD, int BQ, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int H,
                  int K, long long q_sb, long long q_ss, long long k_sb,
                  long long k_ss, long long v_sb, long long v_ss,
                  float scale) {
  constexpr int P = tile_pitch<HD>();
  const int SP = score_pitch(S);
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // BQ x P
  float* kv_s = q_s + BQ * P;           // kBK x P: a k tile, then a v tile
  float* s_s = kv_s + kBK * P;          // BQ x SP: scores, then probs

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const T* kb = k + (long long)b * k_sb + (long long)kh * HD;
  const T* vb = v + (long long)b * v_sb + (long long)kh * HD;
  // keys [0, kv_end): with causal masking, the tiles wholly above the
  // diagonal of this q tile are skipped
  const int kv_end = CAUSAL ? min(q0 + BQ, S) : S;

  load_tile<T, HD>(q_s, q + (long long)b * q_sb + (long long)h * HD, q_ss,
                   q0, BQ, S);

  // 1. all the rows' scores
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // kv_s is free
    load_tile<T, HD>(kv_s, kb, k_ss, k0, kBK, S);
    __syncthreads();
    score_tile<HD, BQ>(q_s, kv_s, s_s + k0, SP, scale);
  }
  __syncthreads();

  // 2. softmax, warp w over rows w, w + kWarps, ...: the row's n valid
  //    keys (the rest are masked with NEG_INF, whose exp is 0); lane l sums
  //    the exps of keys l, l+32, ... in order, then a butterfly; p = e / l,
  //    and p = 0 for the masked keys below kv_end
  for (int r = warp; r < BQ; r += kWarps) {
    const int t = q0 + r;
    if (t >= S) continue;
    const int n = CAUSAL ? t + 1 : S;
    float* row = s_s + r * SP;
    float m = kNegInf;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(row[j], m));
      row[j] = e;
      l = __fadd_rn(l, e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
    }
    l = fmaxf(l, 1e-30f);
    for (int j = lane; j < kv_end; j += 32) {
      row[j] = j < n ? __fdiv_rn(row[j], l) : 0.f;
    }
  }

  // 3. out = P.V
  float acc[BQ / 16][HD / 16] = {};
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // kv_s is free; probs are written
    load_tile<T, HD>(kv_s, vb, v_ss, k0, kBK, S);
    __syncthreads();
    pv_tile<HD, BQ>(acc, s_s + k0, SP, kv_s, min(kBK, kv_end - k0));
  }
  store_rows<T, HD, BQ>(acc, nullptr, out, b, q0, S, H, h);
}

// The online kernel, for any S: the TPU kernel's running (m, l, acc) per
// row over kv tiles, one tile's scores in shared memory at a time. Same
// arguments and grid as flash_rows_kernel.
template <typename T, int HD, int BQ, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_online_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int S,
                    int H, int K, long long q_sb, long long q_ss,
                    long long k_sb, long long k_ss, long long v_sb,
                    long long v_ss, float scale) {
  constexpr int P = tile_pitch<HD>();
  constexpr int SP = kBK + 4;
  constexpr int RPT = BQ / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // BQ x P
  float* kv_s = q_s + BQ * P;           // kBK x P: a k tile, then a v tile
  float* s_s = kv_s + kBK * P;          // BQ x SP: one tile's scores/probs
  float* m_s = s_s + BQ * SP;           // BQ: running max
  float* l_s = m_s + BQ;                // BQ: running sum
  float* a_s = l_s + BQ;                // BQ: this tile's rescale factor

  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const T* kb = k + (long long)b * k_sb + (long long)kh * HD;
  const T* vb = v + (long long)b * v_sb + (long long)kh * HD;
  const int kv_end = CAUSAL ? min(q0 + BQ, S) : S;

  load_tile<T, HD>(q_s, q + (long long)b * q_sb + (long long)h * HD, q_ss,
                   q0, BQ, S);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[RPT][HD / 16] = {};
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // kv_s and s_s are free
    load_tile<T, HD>(kv_s, kb, k_ss, k0, kBK, S);
    __syncthreads();
    score_tile<HD, BQ>(q_s, kv_s, s_s, SP, scale);
    __syncthreads();                    // scores written, kv_s is free
    // warp w over rows w, w + kWarps, ...: keys past S, and after the
    // query when causal, masked with NEG_INF; m' = max(m, tile max),
    // p = exp(s - m'), alpha = exp(m - m'), l' = alpha l + sum p. Every
    // row sees key 0 in the first tile, so m' is finite from there on.
    for (int r = warp; r < BQ; r += kWarps) {
      const int n = CAUSAL ? min(q0 + r + 1, S) : S;
      float* row = s_s + r * SP;
      const float x0 = k0 + lane < n ? row[lane] : kNegInf;
      const float x1 = k0 + lane + 32 < n ? row[lane + 32] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(__fsub_rn(x0, m_new));
      const float p1 = expf(__fsub_rn(x1, m_new));
      row[lane] = p0;
      row[lane + 32] = p1;
      float l = __fadd_rn(p0, p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
      }
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_prev, m_new));
        m_s[r] = m_new;
        l_s[r] = fmaf(alpha, l_s[r], l);
        a_s[r] = alpha;
      }
    }
    load_tile<T, HD>(kv_s, vb, v_ss, k0, kBK, S);
    __syncthreads();                    // probs, alpha and the v tile
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] *= alpha;
    }
    pv_tile<HD, BQ>(acc, s_s, SP, kv_s, min(kBK, kv_end - k0));
  }
  store_rows<T, HD, BQ>(acc, l_s, out, b, q0, S, H, h);
}

template <typename T, int HD, bool CAUSAL, bool ONLINE>
int launch_one(const T* q, const T* k, const T* v, T* out, int B, int S,
               int H, int K, long long q_sb, long long q_ss, long long k_sb,
               long long k_ss, long long v_sb, long long v_ss, float scale,
               int optin, cudaStream_t stream) {
  constexpr int BQ = 32;
  auto kernel = ONLINE ? flash_online_kernel<T, HD, BQ, CAUSAL>
                       : flash_rows_kernel<T, HD, BQ, CAUSAL>;
  static bool opted_in = false;   // once per instantiation, to the limit
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, smem_bytes<HD>(BQ, S, ONLINE), stream>>>(
      q, k, v, out, S, H, K, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

// The row-resident kernel where 32 query rows of scores fit the card's
// opt-in shared memory (S up to about 1,400 at hd = 128), else the online
// kernel.
template <typename T, int HD, bool CAUSAL>
int launch_rows(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int K, long long q_sb, long long q_ss,
                long long k_sb, long long k_ss, long long v_sb,
                long long v_ss, float scale, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (smem_bytes<HD>(32, S, false) <= static_cast<size_t>(optin)) {
    return launch_one<T, HD, CAUSAL, false>(qt, kt, vt, ot, B, S, H, K, q_sb,
                                            q_ss, k_sb, k_ss, v_sb, v_ss,
                                            scale, optin, stream);
  }
  return launch_one<T, HD, CAUSAL, true>(qt, kt, vt, ot, B, S, H, K, q_sb,
                                         q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                         optin, stream);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int K, int causal, long long q_sb, long long q_ss,
              long long k_sb, long long k_ss, long long v_sb, long long v_ss,
              float scale, cudaStream_t stream) {
  if (causal) {
    return launch_rows<T, HD, true>(q, k, v, out, B, S, H, K, q_sb, q_ss,
                                    k_sb, k_ss, v_sb, v_ss, scale, stream);
  }
  return launch_rows<T, HD, false>(q, k, v, out, B, S, H, K, q_sb, q_ss,
                                   k_sb, k_ss, v_sb, v_ss, scale, stream);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int K, int hd, int causal,
                 long long q_sb, long long q_ss, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, float scale,
                 cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(q, k, v, out, B, S, H, K, causal, q_sb, q_ss,
                              k_sb, k_ss, v_sb, v_ss, scale, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, B, S, H, K, causal, q_sb, q_ss,
                              k_sb, k_ss, v_sb, v_ss, scale, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, B, S, H, K, causal, q_sb, q_ss,
                               k_sb, k_ss, v_sb, v_ss, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error of the launch (0 on success); the caller raises on anything
// else.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int H, int K, int hd, int causal, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(q, k, v, out, B, S, H, K, hd, causal, q_sb,
                               q_ss, k_sb, k_ss, v_sb, v_ss, scale, s);
  }
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, S, H, K, hd, causal,
                                       q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                       scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
