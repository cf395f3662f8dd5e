// gather_rows: K random rows of `vw` u32 words from a flat table.
//
// Replaces the Pallas kernel `gather_rows` / `_gather_kernel` of
// dint_tpu/ops/pallas_gather.py:178-234.
//
//   out[i*vw + j] = tab[idx[i]*vw + j]      0 <= i < K, 0 <= j < vw
//
// The dense TATP step runs it twice: the fused meta gather (K = 2wK lanes
// of one word over the [n1] meta table) and the magic-word gather (K = wK
// pre-scaled word offsets, vw = 1, over the [n1*VW] val table).
//
// Bound: bytes. Each lane reads one random 32-byte sector of the table
// (at vw <= 8) plus the index and output streams; the arithmetic is nil.
// The TPU kernel keeps a ring of 16 row DMAs in flight to hide HBM latency
// inside one sequential program. On Hopper the many warps resident on each
// SM do that job, so the design is one thread per output word: a block
// covers 256 consecutive (lane, word) outputs, neighbouring threads write
// neighbouring output words, and the table read goes through the
// read-only path.
//
// Indices must lie in [0, n_rows): the engines clamp NOP lanes onto the
// sentinel row. A device assert enforces it, so an out-of-range index
// fails the launch's stream (reported at the next synchronise) instead of
// reading past the table; a host-side check would cost a device sync per
// call.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_rows_kernel(const uint32_t* __restrict__ tab,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out,
                                   int64_t total, int64_t n_rows, int vw) {
  int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int64_t lane = o / vw;
  int64_t j = o - lane * vw;
  int64_t r = idx[lane];
  assert(r >= 0 && r < n_rows);
  out[o] = __ldg(tab + r * vw + j);
}

}  // namespace

extern "C" int dint_gather_rows(const void* tab, const void* idx, void* out,
                                int64_t k, int64_t n_rows, int vw,
                                void* stream) {
  int64_t total = k * vw;
  if (total > 0) {
    const int threads = 256;
    unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    gather_rows_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(idx),
        static_cast<uint32_t*>(out), total, n_rows, vw);
  }
  return static_cast<int>(cudaGetLastError());
}
