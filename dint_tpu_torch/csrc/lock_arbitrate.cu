// lock_arbitrate: first-lane-wins lock arbitration over the step-stamped
// arb array, arb updated in place.
//
// Replaces the Pallas kernel `lock_arbitrate` / `_arbitrate_kernel` /
// `_arb_rmw` of dint_tpu/ops/pallas_gather.py:610-831, and with it the XLA
// chain of dint_tpu/engines/tatp_dense.py:728-735:
//
//   old   = arb[rows];  held = (old >> k_arb) == t - 1
//   cand  = active & ~held
//   arb'  = arb.at[rows[cand]].max((t << k_arb) | (M-1 - lane))
//   grant = cand & (arb'[rows] == packed)
//
// all in unsigned 32-bit arithmetic.
//
// Design. The TPU kernel walks the M lanes in order with a ring of
// read-modify-write DMAs and a window of recent grants, because a TPU core
// runs one sequential program. Here one thread takes one lane, and two
// launches on the same stream give the grid-wide barrier between the
// scatter-max and the read-back:
//
//   launch 1: old = arb[row]; cand = active && (old >> k) != t-1;
//             grant[lane] = cand; if cand: atomicMax(&arb[row], packed)
//   launch 2: grant[lane] = grant[lane] && arb[row] == packed
//
// Reading `old` while other lanes' atomicMax land is safe. A row whose
// stamp is t-1 is never written in this pass, because every lane on it
// reads t-1 and sees it held. Any other row only ever gains stamps of step
// t, whose step field is t, never t-1, so whether a lane reads the row
// before or after another lane's atomicMax, it decides `held` the same way.
// The atomicMax of the packed stamps leaves the largest one, (t << k) |
// (M-1 - lane) of the smallest active lane, on the row: the same result as
// the XLA scatter-max. Old stamps on a candidate row are from step t-2 or
// earlier (stamps are rebased before the step field overflows), so they
// are smaller than any step-t stamp and never win.
//
// Bound: bytes. Per lane one random 32-byte sector of arb is read, and one
// written where a candidate lands, plus the row, active and grant streams;
// the arithmetic is nil. Launch 2 re-reads sectors that launch 1 just left
// in the 50 MB L2.
//
// Rows must lie in [0, n_rows) (the engine routes inactive lanes to the
// sentinel row); a device assert enforces it, as in gather_rows.cu.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void arbitrate_kernel(uint32_t* __restrict__ arb,
                                 const int32_t* __restrict__ rows,
                                 const uint8_t* __restrict__ active,
                                 uint8_t* __restrict__ grant, int64_t m,
                                 int64_t n_rows, uint32_t t, int k_arb) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int64_t r = rows[i];
  assert(r >= 0 && r < n_rows);
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(arb + r);
  bool held = (old >> k_arb) == t - 1u;
  bool cand = active[i] != 0 && !held;
  grant[i] = cand ? 1 : 0;
  if (cand) {
    uint32_t packed = (t << k_arb) | static_cast<uint32_t>(m - 1 - i);
    atomicMax(arb + r, packed);
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

}  // namespace

extern "C" int dint_lock_arbitrate(void* arb, const void* rows,
                                   const void* active, void* grant,
                                   int64_t m, int64_t n_rows, uint32_t t,
                                   int k_arb, void* stream) {
  if (m > 0) {
    const int threads = 256;
    unsigned blocks = static_cast<unsigned>((m + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    arbitrate_kernel<<<blocks, threads, 0, s>>>(
        static_cast<uint32_t*>(arb), static_cast<const int32_t*>(rows),
        static_cast<const uint8_t*>(active), static_cast<uint8_t*>(grant), m,
        n_rows, t, k_arb);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    readback_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const uint32_t*>(arb), static_cast<const int32_t*>(rows),
        static_cast<uint8_t*>(grant), m, t, k_arb);
  }
  return static_cast<int>(cudaGetLastError());
}
