// gather_streams: N independent row gathers in one launch.
//
// Replaces the Pallas kernel `gather_streams` / `_gather_streams_kernel`
// of dint_tpu/ops/pallas_gather.py:973-1012 (its wrapper at :984). Stream s
// gathers K_s rows of vw_s u32 words from its own flat table:
//
//   out_s[i*vw_s + j] = tab_s[idx_s[i]*vw_s + j]    0 <= i < K_s, j < vw_s
//
// which is gather_rows' tuple form (gather_rows.cu): the SmallBank fused
// route runs it once per step over three streams, the X and S held-stamp
// reads (K = 3w lock-slot indices over the [H] stamp arrays) and the
// wave-1 balance read (K = 3w rows over [2N+1] balances).
//
// Bound: bytes. Each lane reads one random 32-byte sector of its table
// plus the index and output streams; the arithmetic is nil. The TPU kernel
// runs one 16-slot DMA ring per stream back to back inside one program.
// Here the device code is gather_pass.cuh's `gather_pass_kernel<false>`,
// the pass of gather_rows.cu: one flat grid planned on the host, two lanes
// a thread with 8-byte index loads and output stores at vw = 1.
//
// Indices must lie in [0, n_rows); a device assert enforces it.
#include "gather_pass.cuh"

// `plan`: a GatherPlan<capacity> (gather_pass.cuh) with null mirrors.
extern "C" int dint_gather_streams(const void* plan, int capacity,
                                   void* stream) {
  return gather_launch<false>(plan, capacity, stream);
}
