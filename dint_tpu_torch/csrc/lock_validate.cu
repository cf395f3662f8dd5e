// lock_validate: the fused route's lock arbitration, OCC validate read and
// next-cohort meta read of one TATP step, in one cooperative launch.
//
// Replaces the Pallas kernel `lock_validate` / `_lock_validate_kernel` of
// dint_tpu/ops/pallas_gather.py:857-970:
//
//   (arb', grant) = lock_arbitrate(arb, rows, active, t, k_arb)
//   vbad[i]       = meta[vidx[i]] != vv1[i]       0 <= i < V
//   rmeta[i]      = meta[ridx[i]]                 0 <= i < R
//
// all in unsigned 32-bit arithmetic, arb updated in place.
//
// Design. The TPU kernel walks three DMA rings one after the other inside
// one sequential program: the validate reads, the fresh meta reads, then
// the arbitration read-modify-write ring. On Hopper the three jobs are
// independent lanes. The arbitration needs a grid-wide barrier between its
// scatter-max and its read-back; a second launch on the stream used to be
// that barrier. Here it is `cooperative_groups::this_grid().sync()` in one
// kernel launched cooperatively (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative, which stream capture accepts) over a grid
// that fits on the card at once. The most it may have is the SM count
// times the blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// queried once per device by the wrapper; the wrapper launches no more
// blocks than the lanes need, because the barrier's cost grows with the
// blocks it joins (measured on the H100: a grid of all 396 co-resident
// blocks made the pass slower than the two launches it replaces). Since
// CUDA 11 a grid sync needs no relocatable device code, so the library
// builds with ops/_build.py's plain flags.
//
// Thread `tid` takes lanes tid, tid + G, tid + 2G, ... of each job (G
// threads in the grid), kUnroll lane positions at a time, and for each:
//   1. loads its lock lane's row and flag, its validate lane's index and
//      expected version and its read lane's index, then the three random
//      words (the old stamp, meta[vidx], meta[ridx]) together, so several
//      sectors are in flight per thread;
//   2. decides `held` and, for a candidate, issues the atomicMax of its
//      packed stamp first, so the atomics are in flight earliest; a lane
//      that is no candidate writes its grant (0) now;
//   3. writes vbad and rmeta, which fill the time before the barrier.
// After the barrier the thread reads back only its own candidates: their
// candidate bits and (for the first kUnroll positions) rows stay in
// registers, the packed stamp is recomputed from the lane id, and every
// grant is written once. Stamps are read at L2 (ld.global.cg), never from
// an SM's L1, which the other SMs' atomics do not update.
//
// Correctness, as in lock_arbitrate.cu. Reading `old` while other lanes'
// atomicMax land is safe. A row whose stamp is t-1 is never written in
// this pass, because every lane on it reads t-1 and sees it held. Any
// other row only ever gains stamps of step t, whose step field is t, never
// t-1, so whether a lane reads the row before or after another lane's
// atomicMax, it decides `held` the same way. The atomicMax of the packed
// stamps leaves the largest one, (t << k) | (M-1 - lane) of the smallest
// active lane, on the row: the same result as the XLA scatter-max. Old
// stamps on a candidate row are from step t-2 or earlier (stamps are
// rebased before the step field overflows), so they are smaller than any
// step-t stamp and never win. meta and arb are disjoint arrays (the
// wrapper refuses shared storage), so the meta lanes neither see nor
// disturb the stamps, and their order against the lock lanes changes no
// output.
//
// The JAX kernel's `hot_n` keeps the arb prefix resident in VMEM for the
// pass and changes no output. Hopper has no such twin to manage: the
// 50 MB L2 holds a hot prefix by its own traffic. So there is no `hot_n`.
//
// Bound: bytes. The V + R lanes read one random 32-byte sector of meta
// each, the M lanes one of arb, and each row a candidate wins is written
// once; plus the vidx, vv1, ridx, rows and active streams and the vbad,
// rmeta and grant outputs. The arithmetic is nil.
//
// No fallback: a device without cooperative launch, or a grid the card
// cannot hold at once, returns the CUDA error and the wrapper raises.
// Indices must lie in [0, n_meta) and rows in [0, n_arb) (the engine parks
// NOP lanes on the sentinel row); device asserts enforce it. A thread owns
// at most 64 lock lanes (M <= 64 G), checked on the host.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxLanes = 64;      // lock lanes a thread owns: bits of `cand`

struct LockValidate {
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

__device__ __forceinline__ uint32_t packed_of(const LockValidate& a,
                                              int64_t i) {
  return (a.t << a.k_arb) | static_cast<uint32_t>(a.m - 1 - i);
}

__global__ void __launch_bounds__(kThreads)
lock_validate_kernel(const __grid_constant__ LockValidate a) {
  const int64_t g = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int64_t most = a.m > a.v ? (a.m > a.r ? a.m : a.r)
                                 : (a.v > a.r ? a.v : a.r);
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
      if (i < a.v) { vi[u] = a.vidx[i]; vv[u] = a.vv1[i]; }
      if (i < a.r) ri[u] = a.ridx[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * g;
      if (i < a.m) {
        assert(row[u] >= 0 && row[u] < a.n_arb);
        old[u] = __ldcg(a.arb + row[u]);
      }
      if (i < a.v) {
        assert(vi[u] >= 0 && vi[u] < a.n_meta);
        mv[u] = __ldg(a.meta + vi[u]);
      }
      if (i < a.r) {
        assert(ri[u] >= 0 && ri[u] < a.n_meta);
        mr[u] = __ldg(a.meta + ri[u]);
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
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * g;
      if (i < a.v) a.vbad[i] = mv[u] != vv[u] ? 1 : 0;
      if (i < a.r) a.rmeta[i] = mr[u];
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

// The grid of the cooperative launch on `device`: its SM count times the
// blocks of lock_validate_kernel an SM holds at once. Returns the CUDA
// error, cudaErrorNotSupported where the device has no cooperative launch.
extern "C" int dint_lock_validate_grid(int device, int* blocks) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                         device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lock_validate_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = sms * per_sm;
  return static_cast<int>(cudaSuccess);
}

// One cooperative launch of `blocks` blocks (at most
// dint_lock_validate_grid's answer), or none when V = R = M = 0. A refused
// launch returns its error (cudaErrorCooperativeLaunchTooLarge for a grid
// the card cannot hold at once).
extern "C" int dint_lock_validate(void* arb, const void* meta,
                                  const void* vidx, const void* vv1,
                                  void* vbad, int64_t v, const void* ridx,
                                  void* rmeta, int64_t r, const void* rows,
                                  const void* active, void* grant, int64_t m,
                                  int64_t n_meta, int64_t n_arb, uint32_t t,
                                  int k_arb, int blocks, void* stream) {
  if (v == 0 && r == 0 && m == 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1 || m > int64_t{kMaxLanes} * blocks * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  LockValidate a{static_cast<uint32_t*>(arb),
                 static_cast<const uint32_t*>(meta),
                 static_cast<const int32_t*>(vidx),
                 static_cast<const uint32_t*>(vv1),
                 static_cast<uint8_t*>(vbad),
                 static_cast<const int32_t*>(ridx),
                 static_cast<uint32_t*>(rmeta),
                 static_cast<const int32_t*>(rows),
                 static_cast<const uint8_t*>(active),
                 static_cast<uint8_t*>(grant),
                 v, r, m, n_meta, n_arb, t, k_arb};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lock_validate_kernel, a);
  if (e != cudaSuccess) cudaGetLastError();  // a refusal is reported once
  return static_cast<int>(e);
}
