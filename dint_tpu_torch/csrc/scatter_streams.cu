// scatter_streams: N independent masked row scatters in one launch,
// tables updated in place.
//
// Replaces the Pallas kernel `scatter_streams` / `_scatter_streams_kernel`
// / `_scatter_one_stream` of dint_tpu/ops/pallas_gather.py:1026-1124
// (its wrapper at :1089). Stream s writes value row i into its own flat
// table wherever its index is not negative:
//
//   if idx_s[i] >= 0:  tab_s[idx_s[i]*vw_s + j] = vals_s[i*vw_s + j]
//
// A lane with idx < 0 writes nothing. Masked-in indices are unique within
// a stream (the engines' one-writer-per-row certification) and the
// streams' tables are distinct arrays (the wrapper checks it).
//
// The fused routes run it once per step as the install_log megakernel.
// SmallBank: the balance install (K = 3w, vw = 1), the log x3 append
// (18-word rows) and, with the hot tier, the mirror write-through (vw = 1).
// TATP: the val (vw = 10) and meta (vw = 1) installs, the log x3 append
// (42-word rows) and, with the hot tier, the two mirrors.
//
// Bound: bytes. Each masked-in lane writes vw words into one or a few
// 32-byte sectors of its table and reads its value row, plus the index
// streams; the arithmetic is nil.
//
// Design. The TPU kernel walks each stream's lanes with a 16-slot DMA ring
// and SMEM trackers of which lane holds a slot. Here the device code is
// scatter_pass.cuh's `scatter_pass_kernel<false>` (shared with
// scatter_rows_hot.cu, B7), which sets out the design: one flat grid
// planned on the host, two lanes a thread with 8-byte index and value
// loads at vw = 1, row groups with 8- or 16-byte loads and stores for
// wider rows, where a masked-out row (idx < 0) reads no value and a thread
// loads two of a long row's units before it stores them.
//
// Masked-in indices must lie in [0, n_rows); a device assert enforces it.
#include "scatter_pass.cuh"

// `plan`: a ScatterPlan<capacity> (scatter_pass.cuh) with null mirrors,
// mirror indices and masks.
extern "C" int dint_scatter_streams(const void* plan, int capacity,
                                    void* stream) {
  return scatter_launch<false>(plan, capacity, stream);
}
