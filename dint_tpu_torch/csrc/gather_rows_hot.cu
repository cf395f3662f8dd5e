// gather_rows_hot: the partitioned row gather of the hot tier, for up to 8
// streams in one launch. A lane with a mirror index reads its row from the
// compact hot mirror, any other lane from the full table.
//
// Replaces the Pallas kernel `gather_rows_hot` / `_gather_hot_kernel` of
// dint_tpu/ops/pallas_gather.py:240-330 (dispatched by `hot_gather` :344).
// Per stream s:
//
//   out_s[i*vw_s + j] = midx_s[i] >= 0 ? mirror_s[midx_s[i]*vw_s + j]
//                                      : tab_s[idx_s[i]*vw_s + j]
//
// Equal to gather_rows(tab, idx, vw) whenever the mirror mirrors the
// table, which the engines' write-through installs keep true. Callers: the
// TATP hot step's meta and magic gathers (two streams of one launch); the
// SmallBank hot route's balance read and, in the exact lock regime, its
// held-stamp reads (three streams); the store's and the cache tier's hot
// val (vw = 10) and ver (vw = 1) reads (two streams).
//
// Bound: bytes. Each lane reads one random 32-byte sector (two for a
// 40-byte row), of the mirror or of the table, plus the midx and output
// streams and the cold lanes' idx; the arithmetic is nil. The TPU kernel
// copies the whole mirror into VMEM first, so that hot lanes cost no HBM
// access. That has no direct twin here: the mirror is 7.7 MB at 24M
// accounts and a block has at most 227 KB of shared memory. So the mirror
// stays a plain global array, and the hot lanes' own traffic keeps it in
// the 50 MB L2. The device code is gather_pass.cuh's
// `gather_pass_kernel<true>`: a lane loads idx and midx together and picks
// its row with a select, so hot and cold lanes of a warp do not diverge
// (the first port made a cold lane load midx, then idx, then the row, in a
// branch apart from the hot lanes').
//
// Hot lanes' midx must lie in [0, n_mirror_rows) and cold lanes' idx in
// [0, n_rows); a device assert checks the one chosen. A hot lane's idx
// addresses nothing and may hold anything.
#include "gather_pass.cuh"

// `plan`: a GatherPlan<capacity> (gather_pass.cuh) with a mirror for every
// stream.
extern "C" int dint_gather_rows_hot(const void* plan, int capacity,
                                    void* stream) {
  return gather_launch<true>(plan, capacity, stream);
}
