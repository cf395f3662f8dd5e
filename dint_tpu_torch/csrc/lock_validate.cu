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
// independent lanes of one cooperative kernel, `lock_pass<true>` of
// lock_pass.cuh, which sets out the design and why it is right; the lock
// lanes are lock_arbitrate.cu's, the validate and read lanes fill the time
// before the grid barrier.
//
// The JAX kernel's `hot_n` keeps the arb prefix resident in VMEM for the
// pass and changes no output. Hopper has no such twin to manage: the
// 50 MB L2 holds a hot prefix by its own traffic. So there is no `hot_n`.
//
// Bound: bytes. The V + R lanes read one random 32-byte sector of meta
// each, the M lanes one of arb, and each row a candidate wins is written
// once; plus the vidx, vv1, ridx, rows and active streams and the vbad,
// rmeta and grant outputs. The arithmetic is nil.
#include "lock_pass.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
lock_validate_kernel(const __grid_constant__ LockPass a) {
  lock_pass<true>(a);
}

}  // namespace

// The grid of the cooperative launch on `device`: its SM count times the
// blocks of lock_validate_kernel an SM holds at once. Returns the CUDA
// error, cudaErrorNotSupported where the device has no cooperative launch.
extern "C" int dint_lock_validate_grid(int device, int* blocks) {
  return static_cast<int>(
      cooperative_grid(lock_validate_kernel, kThreads, device, blocks));
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
  LockPass a{static_cast<uint32_t*>(arb),
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
  return static_cast<int>(
      cooperative_launch(lock_validate_kernel, a, blocks, kThreads, stream));
}
