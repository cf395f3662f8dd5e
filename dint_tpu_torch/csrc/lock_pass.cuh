// lock_pass.cuh: the one-launch lock pass shared by lock_arbitrate.cu (B2)
// and lock_validate.cu (B4), which differ only in B4's validate and read
// jobs. Both kernels are `lock_pass<kJobs>` launched cooperatively: kJobs
// = false compiles B4's jobs out, so B2 is B4's lock phase with V = R = 0.
//
// The function, in unsigned 32-bit arithmetic, arb updated in place:
//
//   old   = arb[rows];  held = (old >> k_arb) == t - 1
//   cand  = active & ~held
//   arb'  = arb.at[rows[cand]].max((t << k_arb) | (M-1 - lane))
//   grant = cand & (arb'[rows] == packed)
//   vbad  = meta[vidx] != vv1;  rmeta = meta[ridx]      (kJobs only)
//
// Design. The scatter-max and the read-back need a grid-wide barrier
// between them: `cooperative_groups::this_grid().sync()` in one kernel
// launched cooperatively (cooperative.cuh) over a grid that fits on the
// card at once. The most it may have is the SM count times the blocks an SM
// holds, queried once per device by the wrapper; the wrapper launches no
// more blocks than the lanes need, because the barrier's cost grows with
// the blocks it joins (measured on the H100: a grid of all co-resident
// blocks made B4 slower than the two launches it replaced).
//
// Thread `tid` takes lanes tid, tid + G, tid + 2G, ... of each job (G
// threads in the grid), kUnroll lane positions at a time, and for each:
//   1. loads its lock lane's row and flag (and, with kJobs, its validate
//      lane's index and expected version and its read lane's index), then
//      the random words (the old stamp, meta[vidx], meta[ridx]) together,
//      so several sectors are in flight per thread;
//   2. decides `held` and, for a candidate, issues the atomicMax of its
//      packed stamp first, so the atomics are in flight earliest; a lane
//      that is no candidate writes its grant (0) now;
//   3. with kJobs, writes vbad and rmeta, which fill the time before the
//      barrier.
// After the barrier the thread reads back only its own candidates: their
// candidate bits and (for the first kUnroll positions) rows stay in
// registers, the packed stamp is recomputed from the lane id, and every
// grant is written once. Stamps are read at L2 (ld.global.cg), never from
// an SM's L1, which the other SMs' atomics do not update.
//
// Correctness. Reading `old` while other lanes' atomicMax land is safe. A
// row whose stamp is t-1 is never written in this pass, because every lane
// on it reads t-1 and sees it held. Any other row only ever gains stamps of
// step t, whose step field is t, never t-1, so whether a lane reads the row
// before or after another lane's atomicMax, it decides `held` the same way.
// The atomicMax of the packed stamps leaves the largest one, (t << k) |
// (M-1 - lane) of the smallest active lane, on the row: the same result as
// the XLA scatter-max. Old stamps on a candidate row are from step t-2 or
// earlier (stamps are rebased before the step field overflows), so they
// are smaller than any step-t stamp and never win. meta and arb are
// disjoint arrays (the wrapper refuses shared storage), so the meta lanes
// neither see nor disturb the stamps.
//
// No fallback: a device without cooperative launch, or a grid the card
// cannot hold at once, returns the CUDA error and the wrapper raises.
// Indices must lie in [0, n_meta) and rows in [0, n_arb) (the engine parks
// NOP lanes on the sentinel row); device asserts enforce it. A thread owns
// at most kMaxLanes lock lanes (M <= 64 G), checked on the host.
#pragma once
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxLanes = 64;      // lock lanes a thread owns: bits of `cand`

struct LockPass {
  uint32_t* arb;
  const uint32_t* meta;
  const int32_t* vidx;
  const uint32_t* vv1;
  uint8_t* vbad;
  const int32_t* ridx;
  uint32_t* rmeta;
  const int32_t* rows;
  const uint8_t* active;
  uint8_t* grant;
  int64_t v, r, m, n_meta, n_arb;
  uint32_t t;
  int k_arb;
};

__device__ __forceinline__ uint32_t packed_of(const LockPass& a, int64_t i) {
  return (a.t << a.k_arb) | static_cast<uint32_t>(a.m - 1 - i);
}

template <bool kJobs>
__device__ __forceinline__ void lock_pass(const LockPass& a) {
  const int64_t g = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  int64_t most = a.m;
  if constexpr (kJobs) {
    most = a.m > a.v ? (a.m > a.r ? a.m : a.r) : (a.v > a.r ? a.v : a.r);
  }
  uint64_t cand = 0;            // bit j: lock lane tid + j*g is a candidate
  int32_t kept[kUnroll];        // rows of lock lanes tid + j*g, j < kUnroll
  int j0 = 0;
  for (int64_t i0 = tid; i0 < most; i0 += kUnroll * g, j0 += kUnroll) {
    int32_t row[kUnroll], vi[kUnroll], ri[kUnroll];
    uint32_t vv[kUnroll], old[kUnroll], mv[kUnroll], mr[kUnroll];
    bool act[kUnroll];
    // 1. the lanes' coalesced words, then their random words together
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * g;
      if (i < a.m) { row[u] = a.rows[i]; act[u] = a.active[i] != 0; }
      if constexpr (kJobs) {
        if (i < a.v) { vi[u] = a.vidx[i]; vv[u] = a.vv1[i]; }
        if (i < a.r) ri[u] = a.ridx[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * g;
      if (i < a.m) {
        assert(row[u] >= 0 && row[u] < a.n_arb);
        old[u] = __ldcg(a.arb + row[u]);
      }
      if constexpr (kJobs) {
        if (i < a.v) {
          assert(vi[u] >= 0 && vi[u] < a.n_meta);
          mv[u] = __ldg(a.meta + vi[u]);
        }
        if (i < a.r) {
          assert(ri[u] >= 0 && ri[u] < a.n_meta);
          mr[u] = __ldg(a.meta + ri[u]);
        }
      }
    }
    // 2. the lock lanes' atomics first
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * g;
      if (i >= a.m) continue;
      if (j0 == 0) kept[u] = row[u];
      const bool held = (old[u] >> a.k_arb) == a.t - 1u;
      if (act[u] && !held) {
        cand |= 1ull << (j0 + u);
        atomicMax(a.arb + row[u], packed_of(a, i));
      } else {
        a.grant[i] = 0;
      }
    }
    // 3. the validate and read lanes' outputs
    if constexpr (kJobs) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + u * g;
        if (i < a.v) a.vbad[i] = mv[u] != vv[u] ? 1 : 0;
        if (i < a.r) a.rmeta[i] = mr[u];
      }
    }
  }

  cg::this_grid().sync();       // every atomicMax has landed

  // read back this thread's own candidates
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if ((cand >> u) & 1) {
      const int64_t i = tid + u * g;
      a.grant[i] = __ldcg(a.arb + kept[u]) == packed_of(a, i) ? 1 : 0;
    }
  }
  for (uint64_t rest = cand & ~((1ull << kUnroll) - 1); rest;
       rest &= rest - 1) {
    const int64_t i = tid + (__ffsll(static_cast<long long>(rest)) - 1) * g;
    a.grant[i] = __ldcg(a.arb + a.rows[i]) == packed_of(a, i) ? 1 : 0;
  }
}

}  // namespace
