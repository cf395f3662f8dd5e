// scatter_streams: N independent masked row scatters in one launch,
// tables updated in place.
//
// Replaces the Pallas kernel `scatter_streams` / `_scatter_streams_kernel`
// / `_scatter_one_stream` of dint_tpu/ops/pallas_gather.py:1026-1124.
// Stream s writes value row i into its own flat table wherever its index
// is not negative:
//
//   if idx_s[i] >= 0:  tab_s[idx_s[i]*vw_s + j] = vals_s[i*vw_s + j]
//
// A lane with idx < 0 writes nothing. Masked-in indices are unique within
// a stream (the engines' one-writer-per-row certification) and the
// streams' tables are distinct arrays (the wrapper checks it), so no two
// threads store to one word: plain stores, no atomics, and the result
// does not depend on the order the threads run in.
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
// and SMEM trackers of which lane holds a slot. Here the launch is planned
// on the host (row_kernels.scatter_plan), and the plan answers what an
// earlier one-thread-per-(lane, word) grid sized by the largest stream
// paid for:
//   - One flat 1-D grid of sum_s blocks_s blocks, not n_streams x the
//     largest stream's: stream s owns blocks [first_block[s],
//     first_block[s+1]), sized from its own K and row width, and an empty
//     stream owns none. A block finds its stream by comparing blockIdx.x
//     with the at most 8 offsets.
//   - Row-wise work: a group of 2^tpr_log2[s] threads (1 for a one-word
//     row, up to 16 for longer ones, looping where a row has more stores)
//     takes whole rows. The group
//     loads the row's index once, and a masked row (idx < 0) is left
//     before any value or table word is touched. No divide by vw.
//   - Vector stores: where a stream's row width and its table and value
//     pointers allow it, its words move as uint2 (8 bytes) or uint4 (16
//     bytes); the host checks the alignment and passes the width per
//     stream (vec[s], in words). Odd rows or offset views take 4-byte words.
//
// Masked-in indices must lie in [0, n_rows); a device assert enforces it.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 8;
constexpr int kThreads = 256;

// The by-value launch argument; row_kernels._ScatterPlan mirrors it.
struct ScatterPlan {
  uint32_t* tab[kMaxStreams];
  const int32_t* idx[kMaxStreams];
  const uint32_t* vals[kMaxStreams];
  int64_t k[kMaxStreams];
  int64_t n_rows[kMaxStreams];
  int32_t vw[kMaxStreams];        // words per row
  int32_t vec[kMaxStreams];       // words per store: 1, 2 or 4
  int32_t tpr_log2[kMaxStreams];  // log2 of the threads per row
  uint32_t first_block[kMaxStreams + 1];  // exclusive prefix; [n] = total
  int32_t n_streams;
};
static_assert(sizeof(ScatterPlan) == 456, "row_kernels._ScatterPlan");

// The row's words as units of T, lane `lane` of a group of `group`.
// The value and table rows are distinct memory (values never alias a
// table being written), so a group's loads may run ahead of its stores.
template <typename T>
__device__ __forceinline__ void copy_row(uint32_t* tab, const uint32_t* src,
                                         int64_t r, int vw, int lane,
                                         int group) {
  constexpr int kWords = sizeof(T) / 4;
  T* __restrict__ dst = reinterpret_cast<T*>(tab + r * vw);
  const T* __restrict__ s = reinterpret_cast<const T*>(src);
  const int n = vw / kWords;
#pragma unroll 4
  for (int c = lane; c < n; c += group) dst[c] = s[c];
}

// __grid_constant__: the stream's fields are indexed by a runtime s, read
// straight from the parameter bank instead of a per-thread local copy.
__global__ void __launch_bounds__(kThreads)
scatter_streams_kernel(const __grid_constant__ ScatterPlan p) {
  const unsigned b = blockIdx.x;
  // the stream whose block range holds b: the last non-empty stream whose
  // first block is <= b (an empty stream shares its successor's offset)
  int s = 0;
#pragma unroll
  for (int i = 1; i < kMaxStreams; ++i)
    s += (i < p.n_streams && p.first_block[i] <= b) ? 1 : 0;
  const int lg = p.tpr_log2[s];
  const int64_t row =
      (static_cast<int64_t>(b - p.first_block[s]) * kThreads + threadIdx.x)
      >> lg;
  if (row >= p.k[s]) return;
  const int64_t r = p.idx[s][row];     // one load per row, shared by the group
  if (r < 0) return;
  assert(r < p.n_rows[s]);
  const int vw = p.vw[s];
  const int lane = threadIdx.x & ((1 << lg) - 1);
  const uint32_t* src = p.vals[s] + row * vw;
  switch (p.vec[s]) {
    case 4: copy_row<uint4>(p.tab[s], src, r, vw, lane, 1 << lg); break;
    case 2: copy_row<uint2>(p.tab[s], src, r, vw, lane, 1 << lg); break;
    default: copy_row<uint32_t>(p.tab[s], src, r, vw, lane, 1 << lg);
  }
}

}  // namespace

// `plan` points to a host ScatterPlan laid out as above (the wrapper
// builds it with ctypes from row_kernels.scatter_plan); it is copied into
// the launch's parameters. One launch of first_block[n_streams] blocks,
// none when every stream is empty.
extern "C" int dint_scatter_streams(const void* plan, void* stream) {
  const ScatterPlan p = *static_cast<const ScatterPlan*>(plan);
  if (p.n_streams < 1 || p.n_streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = p.first_block[p.n_streams];
  if (blocks > 0) {
    scatter_streams_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
