// The bf16 split-K body shared by the contiguous decode, paged decode and
// paged verify kernels of this directory (decode_attention.cu,
// paged_decode_attention.cu, paged_verify_attention.cu; the TPU kernels
// decode_call, paged_decode_call and paged_verify_call of
// src/repro/kernels/decode_attention/decode_attention.py). Their float32
// kernels keep flash_decode.cuh.
//
// It computes what flash_decode.cuh computes: for each query of the set a
// CTA cluster serves (decode: query heads of one token, sharing one bias
// row; verify: query heads x chunk positions, a bias row each), scores
// q.k * scale in float32 plus an additive float32 bias per slot, a softmax
// with the finite NEG_INF = -1e30 of the bias and the clamp max(l, 1e-30),
// and P.V in float32, written once in bf16. A fully masked query comes out
// finite: the mean of v over all of its W slots, as in the plain versions
// (ref.py). What bounds all three on the H100 is bytes: each slot's k and
// v row is read once per query set, for 4 flops an element a query.
//
// The split. One (batch row, kv head, chunk of up to kMaxGroup queries
// that read that kv head) is served by a thread-block cluster of `split`
// CTAs (at most kMaxSplit, the portable cluster size). CTA r owns the
// contiguous slot range [t0, t1) its caller gives it (a range of slots of
// the contiguous cache, or of pages of the pool), so at LISA-7B's B = 1 the
// card gets 32 x 8 CTAs where one CTA a kv head gave it 32. Each CTA folds
// its range into one partial softmax state (m, l, acc) per query head and
// sends it into rank 0's shared memory (st.async, counted by an mbarrier
// there); rank 0 merges the `split` states in rank order and writes the
// output, while the other ranks have already left. One launch, no
// workspace, no atomics, and the same bits on every run.
//
// Inside a CTA. A slot's (HD) k or v row is read by HD / 8 neighbouring
// lanes, 16 bytes (8 bf16) each: a whole 256-byte row per 16 lanes at
// HD = 128. A lane group is the power of two at or above HD / 8 lanes, so
// that its xor shuffles stay within it: at HD = 80 and 112 (10 and 14
// chunks a row) 16 lanes, at HD = 192 (24) 32; the lanes past HD / 8 copy
// nothing and add zeros to the row's sums (a simple design: 62 %, 88 % and
// 75 % of the lanes read). The kThreads / lanes groups take the CTA's
// slots in turn, in steps of kStage rows a group (64 slots a CTA at HD = 128). In
// a step each lane copies its 16 bytes of kStage k rows and kStage v rows
// into shared memory with cp.async (no registers hold the bytes in flight,
// so a CTA needs 48-64 registers at HD = 64 and 128, and every CTA of a
// launch fits on the card at once), in tiles that complete one by one,
// and reads back only what it copied. A group scores a tile's slots
// together (q.k summed over the row's lanes with xor shuffles), takes one
// maximum and one sum for them, rescales its accumulator once, and adds
// their p * v, while the step's next tile still lands. The exponent is
// taken base 2 with the scale folded in: 2^(s log2 e - m). The next
// step's copies are issued only once this step is scored, so a CTA with
// more slots than one step (LISA-7B's B = 4: 104 slots, paged 112) waits
// for two copy rounds in turn. Measured on an H100 at B = 4, neither a
// ring of two stages (the next step's copies issued first) nor kStage = 8
// (one round) made the contiguous kernel faster (0.0087 ms against
// 0.0092-0.0095); the paged kernel took 7-10 % less. The groups' states
// merge through shared memory into the CTA's state.
//
// Every copy is issued on the caller's strides in place: the contiguous
// cache's batch and slot strides, the pool's page and slot strides through
// the page table. 16-byte copies need 16-byte aligned rows, so the caller
// refuses pointers and strides that are not multiples of 16 bytes.
//
// That is attend(), the body of plan SPLIT (ops.py:DecodePlan). The decode
// kernels' plan SETS, for grouped query heads, is attend_set() at the end
// of this file.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>
#include <type_traits>

#include "../../csrc/device.cuh"

namespace split_decode {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;    // eight warps a CTA
constexpr int kMaxSplit = 8;     // CTAs a cluster (the portable maximum)
constexpr int kMaxGroup = 8;     // queries a cluster serves
constexpr int kCtasPerSm = 1;    // CTAs an SM the split aims for
constexpr int kMinSlots = 16;    // fewest slots a split is worth
constexpr int kStage = 4;        // rows of k and of v a lane group stages
constexpr float kLog2e = 1.4426950408889634f;

// Slots a lane group scores at once (a tile of its staged rows): fewer when
// it scores more than one query (their q rows and accumulators take the
// registers).
template <int NG>
struct Tile {
  static constexpr int value = NG == 1 ? 4 : 2;
};

// A CTA's dynamic shared memory, for head dim HD and NG queries: the
// staged rows (each thread's own 16 bytes of kStage k and v rows) or, once
// they are consumed, the lane groups' accumulators; then, used in rank 0
// only, the kMaxSplit CTA states of the cluster: acc (NG, HD), then (m, l)
// per head, padded to 16 bytes.
__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int HD, int NG>
struct Smem {
  static constexpr int kChunks = HD / 8;               // lanes that read
  static constexpr int kLanes = pow2_at_least(kChunks);  // lanes a row
  static constexpr int kGroups = kThreads / kLanes;    // lane groups
  static constexpr int kStageBytes = 2 * kStage * kThreads * 16;
  static constexpr int kMergeBytes = kGroups * NG * HD * 4;
  static constexpr int kWork =
      kStageBytes > kMergeBytes ? kStageBytes : kMergeBytes;
  static constexpr int kStateFloats = (NG * HD + 2 * NG + 3) / 4 * 4;
  static constexpr int kBytes = kWork + kMaxSplit * kStateFloats * 4;
};

// The query set of a cluster and this CTA's place in it. Each kv head kh
// is read by nq queries (decode: its G query heads; verify: G query heads
// x C chunk positions), served in chunks of up to `group` (kMaxGroup, or
// kSetRows for attend_set): queries j0 .. j0 + gc - 1. Grid: blockIdx.x =
// (kv head * ceil(nq / group) + chunk) * split + rank (a cluster is
// `split` consecutive CTAs along x), blockIdx.y = batch row.
struct Place {
  int kh, j0, gc, rank, split;
};

__device__ __forceinline__ Place place(int nq, int group = kMaxGroup) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int n_chunks = (nq + group - 1) / group;
  const int hx = blockIdx.x / split;
  const int j0 = (hx % n_chunks) * group;
  return Place{hx / n_chunks, j0, min(group, nq - j0),
               static_cast<int>(cluster.block_rank()), split};
}

// The decode query set: query heads j0 .. j0 + gc - 1 of kv head kh in
// batch row blockIdx.y of a (B, H, HD) q, where query head h = kh * G + g
// reads kv head kh (kv-major grouping), sharing the row's bias row. A
// query set is the attend() policy `Queries`: row(j) the (q, out) row of
// query j in units of HD elements, bias(j) its bias row over the slots,
// and kSharedBias whether all queries read one bias row.
struct HeadQueries {
  static constexpr bool kSharedBias = true;
  long long row0;
  const float* bias_row;
  __device__ __forceinline__ long long row(int j) const { return row0 + j; }
  __device__ __forceinline__ const float* bias(int) const { return bias_row; }
};

__device__ __forceinline__ HeadQueries head_queries(const Place& pl, int H,
                                                    int K,
                                                    const float* bias_row) {
  return HeadQueries{
      (long long)blockIdx.y * H + (long long)pl.kh * (H / K) + pl.j0,
      bias_row};
}

// Part r of `total` units in `split` near-equal contiguous parts.
__device__ __forceinline__ int part(int total, int r, int split) {
  return static_cast<int>((long long)total * r / split);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in cluster CTA `rank`.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes from device memory into shared memory without passing through
// registers; zeros, and no read, when !valid
__device__ __forceinline__ void copy16(void* dst, const bf16* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight
// (`pending` is a constant once the tile loop is unrolled).
__device__ __forceinline__ void copy_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// the 8 bf16 of 16 bytes as float32 (element 2i in the low half)
__device__ __forceinline__ void unpack(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
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

// Wait for phase 0 of the mbarrier; a state that never lands fails the
// launch after a second instead of hanging it.
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

// 16 or 8 bytes into the shared memory of another cluster CTA, completing
// as many bytes of its mbarrier (both addresses in that CTA, from in_rank)
__device__ __forceinline__ void send4(uint32_t dst, uint32_t bar,
                                      float4 x) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void send2(uint32_t dst, uint32_t bar, float a,
                                      float b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// Fold slots [t0, t1) of the row (rows.k(t) / rows.v(t): element offset
// of slot t's (K, HD) row) into this CTA's softmax state for the Place's
// gc <= NG queries (qs: their q / out rows and bias rows, each bias row
// with unit stride over slots); rank 0 merges the cluster's states and
// writes the output rows. Every thread of every CTA of the cluster must
// call it (one cluster barrier), with Smem<HD, NG>::kBytes of dynamic
// shared memory.
//
// The bias. A shared bias row (decode) is read by every lane for the
// slots it stages and added to each query's score. Per-query bias rows
// (verify: causal-within-chunk differs per chunk position) are split over
// a row's lanes: lane `sub` stages the bias of queries sub, sub + LPR, ...
// (NBL of them), divided by the scale, and adds it to its part of that
// query's q.k before the lanes' sum, so a query's score costs one select
// more than with a shared row and no shuffle or register a query more.
template <int HD, int NG, typename Rows, typename Queries>
__device__ __forceinline__ void attend(const bf16* __restrict__ q,
                                       const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       bf16* __restrict__ out,
                                       const Rows& rows, const Queries& qs,
                                       int t0, int t1, const Place& pl,
                                       float scale) {
  using S = Smem<HD, NG>;
  constexpr int LPR = S::kLanes;
  constexpr int CH = S::kChunks;
  constexpr int NGRP = S::kGroups;
  constexpr int U = Tile<NG>::value;
  constexpr int kTiles = kStage / U;
  constexpr bool kShared = Queries::kSharedBias;
  constexpr int NBL = kShared ? 1 : (NG + LPR - 1) / LPR;
  static_assert(HD % 8 == 0 && CH <= 32 && 32 % LPR == 0, "head dim");
  static_assert(kStage % U == 0 && kTiles <= 4, "tiles");
  const int grp = threadIdx.x / LPR;
  const int sub = threadIdx.x % LPR;
  const bool reads = LPR == CH || sub < CH;   // this lane has a chunk
  const int gc = pl.gc;
  const float c = scale * kLog2e;
  // a shared bias enters as bias * log2e, a per-query one as bias / scale
  const float bias_mul = kShared ? kLog2e : 1.f / scale;
  const float* brow[NBL];
#pragma unroll
  for (int i = 0; i < NBL; ++i) {
    const int j = kShared ? 0 : sub + i * LPR;
    brow[i] = j < gc ? qs.bias(j) : nullptr;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  uint4 (*sk)[kThreads] = reinterpret_cast<uint4 (*)[kThreads]>(smem);
  uint4 (*sv)[kThreads] =
      reinterpret_cast<uint4 (*)[kThreads]>(smem + S::kStageBytes / 2);
  float (*sm_acc)[NG][HD] = reinterpret_cast<float (*)[NG][HD]>(smem);
  float (*states)[S::kStateFloats] =
      reinterpret_cast<float (*)[S::kStateFloats]>(smem + S::kWork);
  __shared__ float sm_m[NGRP][NG], sm_l[NGRP][NG];
  __shared__ __align__(8) uint64_t full;   // rank 0: the states landed

  // rank 0 expects every other rank's state; the cluster barrier (arrived
  // here, waited for before the first send) orders the init before them
  const int state_bytes = gc * (HD + 2) * 4;
  if (pl.rank == 0 && threadIdx.x == 0) {
    mbar_init_expect(smem_u32(&full), (pl.split - 1) * state_bytes);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const long long col = (long long)pl.kh * HD + sub * 8;
  // the same trip count for every thread: the shuffles need whole warps
  const int steps = (t1 - t0 + NGRP * kStage - 1) / (NGRP * kStage);
  float bx[kStage][NBL];
  auto stage = [&](int it) {
    const int base = t0 + it * NGRP * kStage + grp;
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const int t = base + r * NGRP;
      const bool valid = t < t1;
      const bool copy = valid && reads;
      copy16(&sk[r][threadIdx.x], copy ? k + rows.k(t) + col : k, copy);
      copy16(&sv[r][threadIdx.x], copy ? v + rows.v(t) + col : v, copy);
      if constexpr (kShared) {
        bx[r][0] = valid ? brow[0][t] * bias_mul : 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < NBL; ++i) {
          bx[r][i] = valid && brow[i] != nullptr ? brow[i][t] * bias_mul
                                                 : 0.f;
        }
      }
      if (r % U == U - 1) copy_commit();    // one group a tile
    }
  };
  if (steps > 0) stage(0);

  float qf[NG][8];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < gc && reads) {
      unpack(load16(q + qs.row(g) * HD + sub * 8), qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] = 0.f;
    }
  }
  float m[NG], l[NG], acc[NG][8];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    if (it > 0) stage(it);
    const int base = t0 + it * NGRP * kStage + grp;
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile) {
      const int u0 = tile * U;
      // each thread reads back only the bytes it copied
      copy_wait(kTiles - 1 - tile);
      float s[NG][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        unpack(sk[u0 + u][threadIdx.x], kf);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float d = 0.f;
          if constexpr (!kShared) {   // one lane of the row starts from it
            if (sub == g % LPR) d = bx[u0 + u][g / LPR];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) d = fmaf(qf[g][i], kf[i], d);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1) {
            d += __shfl_xor_sync(0xffffffffu, d, off);
          }
          const float sc = kShared ? fmaf(d, c, bx[u0 + u][0]) : d * c;
          s[g][u] = base + (u0 + u) * NGRP < t1 ? sc : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float mt = s[g][0];
#pragma unroll
        for (int u = 1; u < U; ++u) mt = fmaxf(mt, s[g][u]);
        const float m_new = fmaxf(m[g], mt);
        // no slot of this group yet: keep the state (0 * anything stays 0)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[g] - m_use);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
#pragma unroll
        for (int u = 0; u < U; ++u) s[g][u] = exp2f(s[g][u] - m_use);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        unpack(sv[u0 + u][threadIdx.x], vf);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          l[g] += s[g][u];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[g][i] = fmaf(s[g][u], vf[i], acc[g][i]);
          }
        }
      }
    }
  }

  // the lane groups' states -> the CTA's (the staged rows are consumed)
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (sub == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
    if (reads) {
      float4* dst = reinterpret_cast<float4*>(&sm_acc[grp][g][sub * 8]);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  // ... into rank 0's states[rank]: stored there by rank 0, sent by the
  // others, who are then done
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* mine = states[pl.rank];
  const uint32_t to = in_rank(smem_u32(mine), 0);
  const uint32_t bar = in_rank(smem_u32(&full), 0);
  for (int i = threadIdx.x; i < gc * HD / 4; i += kThreads) {
    const int g = 4 * i / HD;
    const int e = 4 * i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NGRP; ++j) mx = fmaxf(mx, sm_m[j][g]);
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < NGRP; ++j) {
      const float f = exp2f(sm_m[j][g] - mx);
      const float4 a = *reinterpret_cast<const float4*>(&sm_acc[j][g][e]);
      den = fmaf(sm_l[j][g], f, den);
      num.x = fmaf(a.x, f, num.x);
      num.y = fmaf(a.y, f, num.y);
      num.z = fmaf(a.z, f, num.z);
      num.w = fmaf(a.w, f, num.w);
    }
    const int at = NG * HD + 2 * g;           // (m, l) of head g
    if (pl.rank == 0) {
      *reinterpret_cast<float4*>(&mine[g * HD + e]) = num;
      if (e == 0) {
        mine[at] = mx;
        mine[at + 1] = den;
      }
    } else {
      send4(to + 4 * (g * HD + e), bar, num);
      if (e == 0) send2(to + 4 * at, bar, mx, den);
    }
  }
  if (pl.rank != 0) return;

  // rank 0: the cluster's states -> the output, merged in rank order
  __syncthreads();
  mbar_wait(smem_u32(&full));
  for (int idx = threadIdx.x; idx < gc * HD; idx += kThreads) {
    const int g = idx / HD;
    const int e = idx % HD;
    const int at = NG * HD + 2 * g;
    float mx = -INFINITY;
    for (int j = 0; j < pl.split; ++j) mx = fmaxf(mx, states[j][at]);
    float den = 0.f, num = 0.f;
    for (int j = 0; j < pl.split; ++j) {
      const float f = exp2f(states[j][at] - mx);
      den = fmaf(states[j][at + 1], f, den);
      num = fmaf(states[j][g * HD + e], f, num);
    }
    out[qs.row(g) * HD + e] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

// The CTAs a cluster splits one query set's keys into: the smallest power
// of two that gives the card kCtasPerSm CTAs an SM over `sets` query sets,
// at most kMaxSplit and at most `most` (one split per kMinSlots slots, or
// per page).
inline cudaError_t pick_split(long long sets, int most, int* split) {
  int sms = 0;
  const cudaError_t err = cuda_device::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long want = (long long)kCtasPerSm * sms;
  *split = 1;
  while (*split < kMaxSplit && sets * *split < want && 2 * *split <= most) {
    *split *= 2;
  }
  return cudaSuccess;
}

// Launch `kernel` (an attend<HD, NG> kernel) on a grid of `heads` (kv
// head, query chunk) pairs x `split` CTAs along x (clusters of `split`)
// and B along y, kThreads a CTA, with its dynamic shared memory (opted
// into once where it passes the default 48 KB).
template <int HD, int NG, typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), long long heads, int split,
                   int B, cudaStream_t stream, Args... args) {
  if (heads * split > 0x7fffffffLL || B > 65535) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = Smem<HD, NG>::kBytes;
  static bool opted_in = false;
  if (bytes > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(heads * split), B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The query-set sizes NG a kernel is instantiated for, ascending, the
// last kMaxGroup: a set of n queries takes the smallest NG >= n.
template <int... NG>
struct Sizes {};

template <template <int, int> class Kernel, int HD, int NG, int... More,
          typename... Args>
cudaError_t launch_sized(Sizes<NG, More...>, int n, long long heads,
                         int split, int B, cudaStream_t stream,
                         Args... args) {
  if constexpr (sizeof...(More) > 0) {
    if (n > NG) {
      return launch_sized<Kernel, HD>(Sizes<More...>{}, n, heads, split, B,
                                      stream, args...);
    }
  } else {
    static_assert(NG == kMaxGroup, "the largest set is kMaxGroup");
  }
  return launch<HD, NG>(Kernel<HD, NG>::fn(), heads, split, B, stream,
                        args...);
}

// f(std::integral_constant<int, hd>{}) at one of the six head dims the
// kernels take
template <typename F>
cudaError_t at_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    default: return cudaErrorInvalidValue;
  }
}

// Launch a split kernel, Kernel<HD, NG>::fn() (a __global__ that calls
// place(nq) and attend<HD, NG>), for B rows of K kv heads, each read by
// nq queries, at head dim hd, with `args` its arguments; NG is the
// smallest of `sizes` that holds min(nq, kMaxGroup). The split is picked
// here, at most `most`. Returns the CUDA error of the launch (0 on
// success).
template <template <int, int> class Kernel, int... NG, typename... Args>
cudaError_t launch_split(Sizes<NG...> sizes, int nq, int hd, int B, int K,
                         int most, cudaStream_t stream, Args... args) {
  const long long heads = (long long)K * ((nq + kMaxGroup - 1) / kMaxGroup);
  const int n = nq < kMaxGroup ? nq : kMaxGroup;
  int split = 1;
  cudaError_t err = pick_split(B * heads, most, &split);
  if (err != cudaSuccess) return err;
  err = at_head_dim(hd, [&](auto h) {
    return launch_sized<Kernel, decltype(h)::value>(sizes, n, heads, split,
                                                    B, stream, args...);
  });
  return err != cudaSuccess ? err : cudaGetLastError();
}

// 16-byte copies: every base pointer 16-byte aligned, every stride (in
// bf16 elements) a multiple of 8.
inline bool aligned16(std::initializer_list<const void*> ptrs,
                      std::initializer_list<long long> strides) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  for (long long s : strides) {
    if (s % 8 != 0) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// The grouped-query body (plan SETS of ops.py:DecodePlan)
// ---------------------------------------------------------------------------
//
// attend() above gives each lane its queries' q rows and accumulators in
// registers and sums each slot's score with an xor-shuffle chain a query,
// on CUDA cores, in sets of at most kMaxGroup = 8: nemotron-4-340b's
// G = 12 query heads a kv head took two clusters, each reading the kv
// head's rows again. attend_set() serves all the queries that read one kv
// head (up to kSetRows = 16) with one cluster and one read of its rows,
// and computes both products on the tensor cores with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: the set's queries are the
// product's 16 rows (rows past the set's gc are zeros, never written).
//
// A CTA of kSetWarps = 4 warps walks its slot range in tiles of kSetKeys =
// 32 keys, staged by cp.async on the caller's strides (the contiguous
// cache's batch and slot strides, or the pool through the page table) into
// a ring of kSetStages = 3 tiles, so that two tiles are in flight while one
// is scored; each key's row is copied by kSetThreads / kSetKeys threads
// from one address (one page-table read for the pool); each staged row is padded by 16 bytes, so that the 8 rows an
// ldmatrix reads fall on 8 distinct bank groups. Per tile:
//   * S = Q.K^T: warp w takes the tile's keys 8w .. 8w + 7 (one n8
//     fragment; with wider tiles also 8(w + 4n) ..) over the HD / 16
//     k-steps, q's A fragments and k's B
//     fragments by ldmatrix (q held in registers took hd 128 to 128
//     registers and a spill); it adds scale and bias in
//     float32 (the base-2 exponent of attend()) and writes its 16 x 8
//     scores into shared memory;
//   * the softmax: every warp reads the tile's 16 x 32 scores in the A
//     fragment layout and takes the same row maxima and sums (over the
//     quad of lanes that share a fragment row), so the four warps hold the
//     same (m, l) without a merge;
//   * P.V: p is split into kSetPParts = 3 bf16 parts (the flash kernel
//     splits it into two: p_hi = bf16(p), p_lo = bf16(p - p_hi)), each
//     through an m16n8k16 product against v's B fragments
//     (ldmatrix.trans); warp w owns the head's
//     n8 column fragments w, w + 4, ..., so a lane holds at most 24
//     accumulators (hd 192).
// The softmax keeps attend()'s semantics: float32 scores, the finite
// NEG_INF of the bias, the clamp max(l, 1e-30), and a fully masked query
// comes out as the mean of v over its W slots. The split: a cluster of
// `split` CTAs over the slot range. Each rank > 0 sends its state into
// rank 0's shared memory by st.async, counted by an mbarrier, as attend()
// does; the states land on rank 0's ring, so rank 0 arrives on the
// cluster barrier only once its own tiles are consumed, and the other
// ranks wait for that before they send. Rank 0 keeps its own state in
// registers, and each of its lanes folds the other ranks' states into its
// own fragment rows and columns in rank order (a merge pass over the whole
// (gc, HD) block, every thread looping over ranks and elements, cost 2.6 to
// 3.3 us more at hd 192 on the H100, at splits of 2 to 8). At split 1
// there is no cluster barrier and no merge. Either way the output is
// written from the registers.

constexpr int kSetRows = 16;     // queries a set: the M rows of m16n8k16
constexpr int kSetWarps = 4;
constexpr int kSetThreads = kSetWarps * 32;
constexpr int kSetKeys = 32;     // keys a staged tile: 8 a warp in q.k
constexpr int kSetStages = 3;    // tiles in the copy ring
constexpr int kSetInFlight = 64 * 1024;   // k and v bytes in flight an SM
// bf16 parts of p in P.V: three keep p to about 24 bits, so the output is
// one rounding of a float32 P.V (two, hi and lo as in the flash kernel,
// keep about 17 bits and moved 0.1 % of the outputs by one bf16 step: a
// granite decode layer behind them then read 0.00407 against LAYER_RTOL's
// 0.0039 on the H100)
constexpr int kSetPParts = 3;
constexpr int kBlockSmem = 232448;   // the 227 KB a block may use

// A set CTA's dynamic shared memory at head dim HD: the ring of k and v
// tiles, q, the tile's scores and biases; rank 0 then receives the other
// kMaxSplit - 1 ranks' states over the same bytes (acc (16, HD), then
// (m, l) per row, padded to 16 bytes).
template <int HD>
struct SetSmem {
  static constexpr int kPitch = HD + 8;           // bf16 a staged row
  static constexpr int kTile = kSetKeys * kPitch;  // bf16 a k or v tile
  static constexpr int kSPitch = kSetKeys + 8;     // floats a score row
  static constexpr int kWork = 2 * kSetStages * kTile * 2 +
                               kSetRows * kPitch * 2 +
                               kSetRows * kSPitch * 4 +
                               kSetStages * kSetKeys * 4;
  static constexpr int kStateFloats =
      (kSetRows * HD + 2 * kSetRows + 3) / 4 * 4;
  static constexpr int kStates = (kMaxSplit - 1) * kStateFloats * 4;
  static constexpr int kBytes = kWork > kStates ? kWork : kStates;
};

// 4 bytes from device memory into shared memory; zeros, and no read, when
// !valid
__device__ __forceinline__ void copy4(void* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b: one m16n8k16 product, bf16 in, float32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as N bf16 pairs, each the rounding of what the ones before left:
// part 0 = bf16(x), part 1 = bf16(x - part 0), ..., element 0 in the low
// half (flash_attention.cu's split_pair at N = 2)
template <int N>
__device__ __forceinline__ void split_p(float x0, float x1,
                                        uint32_t (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    part[i] = bf16x2_bits(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// Fold slots [t0, t1) (rows.k(t) / rows.v(t): element offset of slot t's
// (K, HD) row) into this CTA's softmax state for the Place's gc <= 16
// queries (qs: their q / out rows and their one shared bias row, unit
// stride over slots); rank 0 merges the cluster's states and writes the
// output rows. Every thread of every CTA of the cluster calls it, with
// SetSmem<HD>::kBytes of dynamic shared memory.
template <int HD, typename Rows, typename Queries>
__device__ __forceinline__ void attend_set(const bf16* __restrict__ q,
                                           const bf16* __restrict__ k,
                                           const bf16* __restrict__ v,
                                           bf16* __restrict__ out,
                                           const Rows& rows,
                                           const Queries& qs, int t0,
                                           int t1, const Place& pl,
                                           float scale) {
  using S = SetSmem<HD>;
  static_assert(Queries::kSharedBias, "one bias row a set");
  static_assert(HD % 16 == 0, "whole k-steps");
  constexpr int P = S::kPitch;
  constexpr int CH = HD / 8;                  // 16-byte chunks a row
  constexpr int KS = HD / 16;                 // k-steps of q.k
  constexpr int NF = HD / 8;                  // n8 fragments of P.V
  constexpr int NFW = (NF + kSetWarps - 1) / kSetWarps;   // a warp's
  constexpr int KN = kSetKeys / (8 * kSetWarps);   // q.k fragments a warp
  static_assert(KN >= 1 && kSetKeys % (8 * kSetWarps) == 0 &&
                    kSetKeys % 32 == 0 && kSetKeys <= kSetThreads,
                "a tile is whole fragments of every warp");
  constexpr int TPK = kSetThreads / kSetKeys;        // threads a key
  static_assert(kSetThreads % kSetKeys == 0, "whole keys a thread group");
  constexpr int QCOPIES = (kSetRows * CH + kSetThreads - 1) / kSetThreads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;     // fragment rows g and g + 8
  const int c = lane % 4;     // fragment columns 2c, 2c + 1 (and + 8)
  const int gc = pl.gc;
  const float cs = scale * kLog2e;
  const float* brow = qs.bias(0);
  const bool clustered = pl.split > 1;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);           // [stage][key][P]
  bf16* sv = sk + kSetStages * S::kTile;              // [stage][key][P]
  bf16* sq = sv + kSetStages * S::kTile;              // [row][P]
  float* ss = reinterpret_cast<float*>(sq + kSetRows * P);  // [row][SP]
  float* sb = ss + kSetRows * S::kSPitch;             // [stage][key]
  float (*states)[S::kStateFloats] =
      reinterpret_cast<float (*)[S::kStateFloats]>(smem);
  __shared__ __align__(8) uint64_t full;   // rank 0: the states landed

  // ranks other than 0 arrive now; rank 0 once its ring is consumed
  if (clustered && pl.rank != 0) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  const long long col = (long long)pl.kh * HD;
  const int n_tiles = (t1 - t0 + kSetKeys - 1) / kSetKeys;
  // tile `it` into its ring slot (k and v rows and biases; zeros past
  // t1), one copy group a tile, empty past the last tile
  auto stage = [&](int it) {
    if (it < n_tiles) {
      const int st = it % kSetStages;
      const int r = threadIdx.x / TPK;   // this thread's key of the tile
      const int t = t0 + it * kSetKeys + r;
      const bool valid = t < t1;
      const bf16* gk = valid ? k + rows.k(t) + col : k;
      const bf16* gv = valid ? v + rows.v(t) + col : v;
      bf16* dk = sk + st * S::kTile + r * P;
      bf16* dv = sv + st * S::kTile + r * P;
#pragma unroll
      for (int j = 0; j < (CH + TPK - 1) / TPK; ++j) {
        const int e = 8 * (threadIdx.x % TPK + TPK * j);
        if (CH % TPK == 0 || e < HD) {
          copy16(dk + e, valid ? gk + e : k, valid);
          copy16(dv + e, valid ? gv + e : v, valid);
        }
      }
      if (threadIdx.x % TPK == 0) {
        copy4(sb + st * kSetKeys + r, valid ? brow + t : brow, valid);
      }
    }
    copy_commit();
  };

  // q (rows past gc zeros), one group of its own, then the ring's first
  // kSetStages - 1 tiles
#pragma unroll
  for (int j = 0; j < QCOPIES; ++j) {
    const int i = threadIdx.x + j * kSetThreads;
    if (kSetRows * CH % kSetThreads == 0 || i < kSetRows * CH) {
      const int r = i / CH;
      const int e = (i % CH) * 8;
      copy16(sq + r * P + e, r < gc ? q + qs.row(r) * HD + e : q, r < gc);
    }
  }
  copy_commit();
#pragma unroll
  for (int it = 0; it < kSetStages - 1; ++it) stage(it);
  // this lane's row of q's A fragments (ldmatrix.x4: rows 0-7 / 8-15,
  // columns 0-7 / 8-15 of a k-step)
  const bf16* qrow = sq + ((lane % 8) + 8 * ((lane / 8) % 2)) * P +
                     8 * (lane / 16);

  float m[2] = {-INFINITY, -INFINITY};   // rows g, g + 8
  float l[2] = {0.f, 0.f};
  float acc[NFW][4];
#pragma unroll
  for (int j = 0; j < NFW; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1, whose slot the next copies take
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSetStages - 2)
                 : "memory");
    __syncthreads();
    stage(it + kSetStages - 1);
    const int st = it % kSetStages;
    const bf16* tk = sk + st * S::kTile;
    const bf16* tv = sv + st * S::kTile;

    // S = Q.K^T for this warp's KN fragments of 8 keys: keys
    // 8 (warp + kSetWarps n) .. + 7 of the tile, q's fragments shared
    {
      float d[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
      }
      const bf16* krow =
          tk + (8 * warp + lane % 8) * P + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int kk = 0; kk + 1 < KS; kk += 2) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, qrow + kk * 16);
        ldsm_x4(a1, qrow + (kk + 1) * 16);
#pragma unroll
        for (int n = 0; n < KN; ++n) {
          uint32_t b[4];
          ldsm_x4(b, krow + 8 * kSetWarps * n * P + (kk + lane / 16) * 16);
          mma16816(d[n], a0, b[0], b[1]);
          mma16816(d[n], a1, b[2], b[3]);
        }
      }
      if constexpr (KS % 2 == 1) {
        uint32_t a[4];
        ldsm_x4(a, qrow + (KS - 1) * 16);
#pragma unroll
        for (int n = 0; n < KN; ++n) {
          uint32_t b[2];
          ldsm_x2(b, krow + 8 * kSetWarps * n * P + (KS - 1) * 16);
          mma16816(d[n], a, b[0], b[1]);
        }
      }
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        const int key = 8 * (warp + kSetWarps * n) + 2 * c;
        const int t = t0 + it * kSetKeys + key;
        const float* bias = sb + st * kSetKeys + key;
        float2 lo, hi;   // rows g and g + 8
        lo.x = t < t1 ? fmaf(d[n][0], cs, bias[0] * kLog2e) : -INFINITY;
        lo.y = t + 1 < t1 ? fmaf(d[n][1], cs, bias[1] * kLog2e)
                          : -INFINITY;
        hi.x = t < t1 ? fmaf(d[n][2], cs, bias[0] * kLog2e) : -INFINITY;
        hi.y = t + 1 < t1 ? fmaf(d[n][3], cs, bias[1] * kLog2e)
                          : -INFINITY;
        *reinterpret_cast<float2*>(ss + g * S::kSPitch + key) = lo;
        *reinterpret_cast<float2*>(ss + (g + 8) * S::kSPitch + key) = hi;
      }
    }
    __syncthreads();

    // the softmax of the tile's scores, the same in every warp: s[r][i]
    // is row g + 8r at key 16(i / 4) + 8((i / 2) % 2) + 2c + i % 2
    float s[2][kSetKeys / 4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int i = 0; i < kSetKeys / 4; i += 2) {
        const float2 x = *reinterpret_cast<const float2*>(
            ss + (g + 8 * r) * S::kSPitch + 16 * (i / 4) + 8 * ((i / 2) % 2) +
            2 * c);
        s[r][i] = x.x;
        s[r][i + 1] = x.y;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = s[r][0];
#pragma unroll
      for (int i = 1; i < kSetKeys / 4; ++i) mt = fmaxf(mt, s[r][i]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[r], mt);
      // no slot of this row yet: keep the state (0 * anything stays 0)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kSetKeys / 4; ++i) {
        s[r][i] = exp2f(s[r][i] - m_use);
        sum += s[r][i];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = fmaf(l[r], alpha[r], sum);
    }
    // p as A fragments of its kSetPParts bf16 parts, k-step by k-step
    uint32_t pa[kSetPParts][kSetKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kSetKeys / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {   // (row, key half): a0 .. a3
        const int i = 4 * kk + 2 * (f / 2);
        uint32_t part[kSetPParts];
        split_p(s[f % 2][i], s[f % 2][i + 1], part);
#pragma unroll
        for (int n = 0; n < kSetPParts; ++n) pa[n][kk][f] = part[n];
      }
    }

    // P.V on this warp's column fragments: the tile's products in an
    // accumulator of their own, then acc = acc * alpha + the tile's (the
    // tensor cores' sums truncate each add, and over 4,096 keys in one
    // accumulator that moved the outputs 1e-4 norm-wise on the H100)
#pragma unroll
    for (int j = 0; j < NFW; ++j) {
      const int f = warp + j * kSetWarps;
      if (NF % kSetWarps == 0 || f < NF) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < kSetKeys / 32; ++h) {   // 32 keys an ldmatrix
          uint32_t b[4];
          ldsm_x4_trans(b, tv + (32 * h + lane) * P + 8 * f);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
            for (int n = 0; n < kSetPParts; ++n) {
              mma16816(pv, pa[n][2 * h + kk], b[2 * kk], b[2 * kk + 1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[j][i] = fmaf(acc[j][i], alpha[i / 2], pv[i]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();   // the ring is consumed: the states may land on it

  // a cluster: each rank > 0 sends its state (rows under gc) into rank
  // 0's states[rank - 1]; rank 0 folds them into its registers in rank
  // order (each lane its own fragment rows and columns)
  constexpr int kAt = kSetRows * HD;   // (m, l) of row r at kAt + 2r
  if (clustered) {
    if (pl.rank == 0) {
      if (threadIdx.x == 0) {
        mbar_init_expect(smem_u32(&full),
                         (pl.split - 1) * gc * (HD + 2) * 4);
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (pl.rank != 0) {
      const uint32_t to = in_rank(smem_u32(states[pl.rank - 1]), 0);
      const uint32_t bar = in_rank(smem_u32(&full), 0);
#pragma unroll
      for (int j = 0; j < NFW; ++j) {
        const int f = warp + j * kSetWarps;
        if (NF % kSetWarps == 0 || f < NF) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (g + 8 * r < gc) {
              send2(to + 4 * ((g + 8 * r) * HD + 8 * f + 2 * c), bar,
                    acc[j][2 * r], acc[j][2 * r + 1]);
            }
          }
        }
      }
      if (warp == 0 && c == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (g + 8 * r < gc) {
            send2(to + 4 * (kAt + 2 * (g + 8 * r)), bar, m[r], l[r]);
          }
        }
      }
      return;
    }
    mbar_wait(smem_u32(&full));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= gc) continue;
      float mx = m[r];
      for (int s = 1; s < pl.split; ++s) {
        mx = fmaxf(mx, states[s - 1][kAt + 2 * row]);
      }
      const float f0 = exp2f(m[r] - mx);
      float den = l[r] * f0;
#pragma unroll
      for (int j = 0; j < NFW; ++j) {
        acc[j][2 * r] *= f0;
        acc[j][2 * r + 1] *= f0;
      }
      for (int s = 1; s < pl.split; ++s) {
        const float* st = states[s - 1];
        const float fs = exp2f(st[kAt + 2 * row] - mx);
        den = fmaf(st[kAt + 2 * row + 1], fs, den);
#pragma unroll
        for (int j = 0; j < NFW; ++j) {
          const int f = warp + j * kSetWarps;
          if (NF % kSetWarps == 0 || f < NF) {
            const float2 a = *reinterpret_cast<const float2*>(
                st + row * HD + 8 * f + 2 * c);
            acc[j][2 * r] = fmaf(a.x, fs, acc[j][2 * r]);
            acc[j][2 * r + 1] = fmaf(a.y, fs, acc[j][2 * r + 1]);
          }
        }
      }
      l[r] = den;
    }
  }

  // the output rows from the registers
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < NFW; ++j) {
    const int f = warp + j * kSetWarps;
    if (NF % kSetWarps == 0 || f < NF) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (g + 8 * r < gc) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + qs.row(g + 8 * r) * HD + 8 * f + 2 * c) =
              __floats2bfloat162_rn(acc[j][2 * r] / den[r],
                                    acc[j][2 * r + 1] / den[r]);
        }
      }
    }
  }
}

// The CTAs an SM a set kernel's split aims for at head dim HD: as many as
// keep about kSetInFlight bytes of k and v in flight an SM (a CTA has two
// tiles of kSetKeys rows in flight), from one to four (hd 32's eight would
// pass the registers of an SM). Measured on the H100 at
// the long windows (B 8, W 4,096; PERF.md §6): at hd 192 one CTA an
// SM read nemotron-4-340b's 0.081 ms, two 0.122 and four 0.108; at hd 64
// four read granite's 0.0375 ms, two 0.0422 and one 0.0435. The other
// head sizes take the rule's count unmeasured (hd 32 four, 80 three, 112
// and 128 two).
template <int HD>
constexpr int set_ctas_per_sm() {
  const int n = kSetInFlight / (2 * 2 * kSetKeys * HD * 2);
  return n < 1 ? 1 : n > 4 ? 4 : n;
}

// The split of a set kernel, Kernel<HD>::fn() (a __global__ of kSetThreads
// threads that calls place(nq, kSetRows) and attend_set<HD>), for B rows of
// K kv heads, each read by nq queries: the largest power of two at most
// `most` and kMaxSplit whose grid of B x K x ceil(nq / kSetRows) sets x
// split CTAs gives no SM more than set_ctas_per_sm<HD>() of them, else 1.
template <template <int> class Kernel, int HD>
cudaError_t set_split(int nq, int B, int K, int most, int* split) {
  int sms = 0;
  const cudaError_t err = cuda_device::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long sets = (long long)K * ((nq + kSetRows - 1) / kSetRows);
  const long long resident = (long long)sms * set_ctas_per_sm<HD>();
  *split = 1;
  while (*split < kMaxSplit && 2 * *split <= most &&
         B * sets * 2 * *split <= resident) {
    *split *= 2;
  }
  return cudaSuccess;
}

// Launch a set kernel (as set_split) with `args` its arguments: a grid of
// K * ceil(nq / kSetRows) sets x split CTAs along x (clusters of `split`)
// and B along y. Returns the CUDA error of the launch (0 on success).
template <template <int> class Kernel, int HD, typename... Args>
cudaError_t launch_set(int nq, int B, int K, int most, cudaStream_t stream,
                       Args... args) {
  const long long sets = (long long)K * ((nq + kSetRows - 1) / kSetRows);
  if (sets > 0x7fffffffLL / kMaxSplit || B > 65535) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = SetSmem<HD>::kBytes;
  static bool opted_in = false;
  if (bytes > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel<HD>::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  int split = 1;
  const cudaError_t err = set_split<Kernel, HD>(nq, B, K, most, &split);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(sets * split), B, 1);
  cfg.blockDim = dim3(kSetThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel<HD>::fn(), args...);
}

template <template <int> class Kernel, typename... Args>
cudaError_t launch_sets(int nq, int hd, int B, int K, int most,
                        cudaStream_t stream, Args... args) {
  const cudaError_t err = at_head_dim(hd, [&](auto h) {
    return launch_set<Kernel, decltype(h)::value>(nq, B, K, most, stream,
                                                  args...);
  });
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <template <int> class Kernel>
cudaError_t set_splits(int nq, int hd, int B, int K, int most, int* split) {
  return at_head_dim(hd, [&](auto h) {
    return set_split<Kernel, decltype(h)::value>(nq, B, K, most, split);
  });
}

}  // namespace split_decode
