// lock_arbitrate: first-lane-wins lock arbitration over the step-stamped
// arb array, arb updated in place, in one cooperative launch.
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
// runs one sequential program. Here one thread takes a lane: it reads the
// row's stamp, and a candidate issues the atomicMax of its packed stamp;
// then a grid-wide barrier; then each candidate reads its row back. This
// is the lock phase of lock_validate.cu (B4) with no validate or read
// lanes: `lock_pass<false>` of lock_pass.cuh, which sets out the design and
// why it is right. The kernel is launched cooperatively over ceil(M / 256)
// blocks, at most the blocks the card holds at once; a thread owns at most
// 64 lanes. The barrier used to be a second launch on the stream.
//
// Bound: bytes. Per lane one random 32-byte sector of arb is read, and one
// written where a candidate lands, plus the row, active and grant streams;
// the arithmetic is nil. The read-back re-reads sectors the atomics just
// left in the 50 MB L2.
//
// Rows must lie in [0, n_rows) (the engine routes inactive lanes to the
// sentinel row); a device assert enforces it, as in gather_rows.cu.
#include "lock_pass.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
lock_arbitrate_kernel(const __grid_constant__ LockPass a) {
  lock_pass<false>(a);
}

}  // namespace

// The most blocks of lock_arbitrate_kernel a cooperative launch may have on
// `device` (SMs times blocks an SM holds), or the CUDA error.
extern "C" int dint_lock_arbitrate_grid(int device, int* blocks) {
  return static_cast<int>(
      cooperative_grid(lock_arbitrate_kernel, kThreads, device, blocks));
}

// One cooperative launch of `blocks` blocks, none when M = 0. A refused
// launch returns its error.
extern "C" int dint_lock_arbitrate(void* arb, const void* rows,
                                   const void* active, void* grant,
                                   int64_t m, int64_t n_rows, uint32_t t,
                                   int k_arb, int blocks, void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1 || m > int64_t{kMaxLanes} * blocks * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  LockPass a{static_cast<uint32_t*>(arb), nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr,
             static_cast<const int32_t*>(rows),
             static_cast<const uint8_t*>(active),
             static_cast<uint8_t*>(grant),
             0, 0, m, 0, n_rows, t, k_arb};
  return static_cast<int>(
      cooperative_launch(lock_arbitrate_kernel, a, blocks, kThreads, stream));
}
