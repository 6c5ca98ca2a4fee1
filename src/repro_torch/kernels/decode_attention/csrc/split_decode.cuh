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

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>

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
// x C chunk positions), served in chunks of up to kMaxGroup: queries
// j0 .. j0 + gc - 1. Grid: blockIdx.x = (kv head * ceil(nq / kMaxGroup) +
// chunk) * split + rank (a cluster is `split` consecutive CTAs along x),
// blockIdx.y = batch row.
struct Place {
  int kh, j0, gc, rank, split;
};

__device__ __forceinline__ Place place(int nq) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int n_chunks = (nq + kMaxGroup - 1) / kMaxGroup;
  const int hx = blockIdx.x / split;
  const int j0 = (hx % n_chunks) * kMaxGroup;
  return Place{hx / n_chunks, j0, min(kMaxGroup, nq - j0),
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
  switch (hd) {
    case 32:
      err = launch_sized<Kernel, 32>(sizes, n, heads, split, B, stream,
                                     args...);
      break;
    case 64:
      err = launch_sized<Kernel, 64>(sizes, n, heads, split, B, stream,
                                     args...);
      break;
    case 80:
      err = launch_sized<Kernel, 80>(sizes, n, heads, split, B, stream,
                                     args...);
      break;
    case 112:
      err = launch_sized<Kernel, 112>(sizes, n, heads, split, B, stream,
                                      args...);
      break;
    case 128:
      err = launch_sized<Kernel, 128>(sizes, n, heads, split, B, stream,
                                      args...);
      break;
    case 192:
      err = launch_sized<Kernel, 192>(sizes, n, heads, split, B, stream,
                                      args...);
      break;
    default:
      return cudaErrorInvalidValue;
  }
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

}  // namespace split_decode
