// lock_validate: the fused route's lock arbitration, OCC validate read and
// next-cohort meta read of one TATP step, in one wrapper launch.
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
// independent lanes, so one grid holds them all and one thread takes one
// lane: blockIdx.x in [0, bv) validates, [bv, bv + br) reads, and the
// rest runs lock_arbitrate.cu's first pass (read the old stamp, decide
// `held`, atomicMax the packed stamp of a candidate). A second launch on
// the same stream reads the grants back, as in lock_arbitrate.cu. That
// file's correctness argument carries over unchanged: meta and arb are
// disjoint arrays (the wrapper refuses shared storage), so the meta lanes
// neither see nor disturb the stamps, and their order against the lock
// lanes changes no output.
//
// The JAX kernel's `hot_n` keeps the arb prefix resident in VMEM for the
// pass and changes no output. Hopper has no such twin to manage: the
// 50 MB L2 holds a hot prefix by its own traffic. So there is no `hot_n`.
//
// Bound: bytes. The V + R lanes read one random 32-byte sector of meta
// each, the M lanes one of arb, and each row a candidate wins is written
// once; plus the vidx, vv1, ridx, rows and active streams and the vbad,
// rmeta and grant outputs. The arithmetic is nil. On the TATP main path
// (V = R = 32,768, M = 16,384 over 154,000,023-word tables) that is at most
// ~3.7 MB, ~1.1 us at 3.35 TB/s.
//
// Indices must lie in [0, n_meta) and rows in [0, n_arb) (the engine parks
// NOP lanes on the sentinel row); device asserts enforce it.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lock_validate_kernel(
    uint32_t* __restrict__ arb, const uint32_t* __restrict__ meta,
    const int32_t* __restrict__ vidx, const uint32_t* __restrict__ vv1,
    uint8_t* __restrict__ vbad, int64_t v, unsigned bv,
    const int32_t* __restrict__ ridx, uint32_t* __restrict__ rmeta,
    int64_t r, unsigned br, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ active, uint8_t* __restrict__ grant,
    int64_t m, int64_t n_meta, int64_t n_arb, uint32_t t, int k_arb) {
  unsigned b = blockIdx.x;
  if (b < bv) {                                   // validate lanes
    int64_t i = static_cast<int64_t>(b) * kThreads + threadIdx.x;
    if (i >= v) return;
    int64_t row = vidx[i];
    assert(row >= 0 && row < n_meta);
    vbad[i] = __ldg(meta + row) != vv1[i] ? 1 : 0;
    return;
  }
  b -= bv;
  if (b < br) {                                   // fresh meta reads
    int64_t i = static_cast<int64_t>(b) * kThreads + threadIdx.x;
    if (i >= r) return;
    int64_t row = ridx[i];
    assert(row >= 0 && row < n_meta);
    rmeta[i] = __ldg(meta + row);
    return;
  }
  b -= br;                                        // lock lanes, first pass
  int64_t i = static_cast<int64_t>(b) * kThreads + threadIdx.x;
  if (i >= m) return;
  int64_t row = rows[i];
  assert(row >= 0 && row < n_arb);
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(arb + row);
  bool held = (old >> k_arb) == t - 1u;
  bool cand = active[i] != 0 && !held;
  grant[i] = cand ? 1 : 0;
  if (cand) {
    uint32_t packed = (t << k_arb) | static_cast<uint32_t>(m - 1 - i);
    atomicMax(arb + row, packed);
  }
}

__global__ void readback_kernel(const uint32_t* __restrict__ arb,
                                const int32_t* __restrict__ rows,
                                uint8_t* __restrict__ grant, int64_t m,
                                uint32_t t, int k_arb) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m || grant[i] == 0) return;
  uint32_t packed = (t << k_arb) | static_cast<uint32_t>(m - 1 - i);
  grant[i] = arb[rows[i]] == packed ? 1 : 0;
}

unsigned blocks_of(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dint_lock_validate(void* arb, const void* meta,
                                  const void* vidx, const void* vv1,
                                  void* vbad, int64_t v, const void* ridx,
                                  void* rmeta, int64_t r, const void* rows,
                                  const void* active, void* grant, int64_t m,
                                  int64_t n_meta, int64_t n_arb, uint32_t t,
                                  int k_arb, void* stream) {
  unsigned bv = blocks_of(v), br = blocks_of(r), bm = blocks_of(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bv + br + bm > 0) {
    lock_validate_kernel<<<bv + br + bm, kThreads, 0, s>>>(
        static_cast<uint32_t*>(arb), static_cast<const uint32_t*>(meta),
        static_cast<const int32_t*>(vidx), static_cast<const uint32_t*>(vv1),
        static_cast<uint8_t*>(vbad), v, bv, static_cast<const int32_t*>(ridx),
        static_cast<uint32_t*>(rmeta), r, br,
        static_cast<const int32_t*>(rows), static_cast<const uint8_t*>(active),
        static_cast<uint8_t*>(grant), m, n_meta, n_arb, t, k_arb);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (bm > 0) {
    readback_kernel<<<bm, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(arb), static_cast<const int32_t*>(rows),
        static_cast<uint8_t*>(grant), m, t, k_arb);
  }
  return static_cast<int>(cudaGetLastError());
}
