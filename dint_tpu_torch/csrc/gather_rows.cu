// gather_rows: K random rows of `vw` u32 words from a flat table, for up to
// 8 streams (tables) in one launch.
//
// Replaces the Pallas kernel `gather_rows` / `_gather_kernel` of
// dint_tpu/ops/pallas_gather.py:178-234. Per stream s:
//
//   out_s[i*vw_s + j] = tab_s[idx_s[i]*vw_s + j]    0 <= i < K_s, j < vw_s
//
// The dense TATP step gathers twice at one point, on independent inputs:
// the fused meta gather (K = 2wK lanes of one word over the [n1] meta
// table) and the magic-word gather (K = wK pre-scaled word offsets, vw = 1,
// over the [n1*VW] val table); they are the two streams of one launch.
// SmallBank's default step reads its X and S held stamps and its balances
// (3 x 3w lanes) as the three streams of one launch.
//
// Bound: bytes. Each lane reads one random 32-byte sector of its table
// plus the index and output streams; the arithmetic is nil. The TPU kernel
// keeps a ring of 16 row DMAs in flight inside one sequential program; on
// Hopper the resident warps hide the latency, and what a launch at these K
// costs is mostly the launch. The device code is gather_pass.cuh's
// `gather_pass_kernel<false>` (shared with gather_rows_hot.cu, B6), which
// sets out the design: one flat grid planned on the host, several lanes a
// thread with vector index loads and output stores at vw = 1, row groups
// for wider rows.
//
// Indices must lie in [0, n_rows): the engines clamp NOP lanes onto the
// sentinel row. A device assert enforces it.
#include "gather_pass.cuh"

// `plan`: a GatherPlan<capacity> (gather_pass.cuh) with null mirrors.
extern "C" int dint_gather_rows(const void* plan, int capacity,
                                void* stream) {
  return gather_launch<false>(plan, capacity, stream);
}
