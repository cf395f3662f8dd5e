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
// The SmallBank fused route runs it once per step as the install_log
// megakernel: the balance install (K = 3w, vw = 1), the log x3 append
// (K = 3w rows of 3 * (4 + 2) = 18 words, the log plan's slots) and, with
// the hot tier, the mirror write-through (K = 3w, vw = 1).
//
// Bound: bytes. Each masked-in lane writes vw words into one or a few
// 32-byte sectors, plus the index and value streams; the arithmetic is
// nil. The TPU kernel walks each stream's lanes with a 16-slot DMA ring
// and SMEM trackers of which lane holds a slot. Here blockIdx.y picks the
// stream and one thread takes one (lane, word), so the stores of all
// streams are in flight together and need no tracking.
//
// Masked-in indices must lie in [0, n_rows); a device assert enforces it.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 8;

struct ScatterStreams {
  uint32_t* tab[kMaxStreams];
  const int32_t* idx[kMaxStreams];
  const uint32_t* vals[kMaxStreams];
  int64_t k[kMaxStreams];
  int64_t n_rows[kMaxStreams];
  int32_t vw[kMaxStreams];
};

__global__ void scatter_streams_kernel(const ScatterStreams a) {
  const int s = blockIdx.y;
  const int vw = a.vw[s];
  int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= a.k[s] * vw) return;
  int64_t lane = o / vw;
  int64_t r = a.idx[s][lane];
  if (r < 0) return;
  assert(r < a.n_rows[s]);
  int64_t j = o - lane * vw;
  a.tab[s][r * vw + j] = a.vals[s][o];
}

}  // namespace

// `args` points to a host ScatterStreams laid out as above (the wrapper
// builds it with ctypes); it is copied into the launch's parameters.
extern "C" int dint_scatter_streams(const void* args, int n_streams,
                                    void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScatterStreams a = *static_cast<const ScatterStreams*>(args);
  int64_t most = 0;
  for (int s = 0; s < n_streams; ++s) {
    int64_t total = a.k[s] * a.vw[s];
    if (total > most) most = total;
  }
  if (most > 0) {
    const int threads = 256;
    dim3 grid(static_cast<unsigned>((most + threads - 1) / threads),
              static_cast<unsigned>(n_streams));
    scatter_streams_kernel<<<grid, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
