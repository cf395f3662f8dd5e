// scatter_rows_hot: the hot tier's write-through install, for up to 8
// streams in one launch. Every masked-in lane writes its row into the full
// table and, where it has a mirror index, into the hot mirror too; both are
// updated in place.
//
// Replaces the Pallas kernel `scatter_rows_hot` / `_scatter_hot_kernel`
// of dint_tpu/ops/pallas_gather.py:477-585 (its wrapper at :553,
// dispatched by `hot_scatter` :588). Per stream s:
//
//   if mask_s[i]:                  tab_s[idx_s[i]*vw_s + j]    = vals_s[i*vw_s + j]
//   if mask_s[i] && midx_s[i]>=0:  mirror_s[midx_s[i]*vw_s + j] = vals_s[i*vw_s + j]
//
// Masked-in indices are unique (one X-lock holder per row), and each
// mirror row shadows exactly one table row, so no two threads store to
// one word. Callers, each one call a step or round: the TATP hot route's
// meta and val installs (two streams on the same lanes), the SmallBank hot
// route's balances (K = 3w lanes into the [2N+1] balances and the
// [2 * hot_n] mirror), and the val (vw = 10) and ver (vw = 1) installs of
// the store's hot route and of the cache tier's write-back and refill (two
// streams on the same lanes).
//
// Bound: bytes. Each masked-in lane writes one 32-byte sector of the
// table (two for a 40-byte row) and, when hot, of the mirror, and reads
// its value row and its index and flag words; the arithmetic is nil. The
// TPU kernel walks the lanes with two 16-slot DMA rings and SMEM trackers
// of which lane holds a slot. Here, at these K, a launch costs about the
// launch, so an install's tables are the streams of one launch. The device
// code is scatter_pass.cuh's `scatter_pass_kernel<true>` (shared with
// scatter_streams.cu, B3): a thread loads two lanes' flags, indices and
// values at once at vw = 1, and the value row is read once for the table
// and the mirror.
//
// Masked-in idx must lie in [0, n_rows) and masked-in, hot midx in
// [0, n_mirror_rows); device asserts enforce both. A masked-out lane's idx
// and midx address nothing and may hold anything.
#include "scatter_pass.cuh"

// `plan`: a ScatterPlan<capacity> (scatter_pass.cuh) with a mirror, mirror
// indices and a mask for every stream.
extern "C" int dint_scatter_rows_hot(const void* plan, int capacity,
                                     void* stream) {
  return scatter_launch<true>(plan, capacity, stream);
}
