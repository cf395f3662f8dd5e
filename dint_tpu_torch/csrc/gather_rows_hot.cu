// gather_rows_hot: the partitioned row gather of the hot tier. A lane
// with a mirror index reads its row from the compact hot mirror, any
// other lane from the full table.
//
// Replaces the Pallas kernel `gather_rows_hot` / `_gather_hot_kernel` of
// dint_tpu/ops/pallas_gather.py:240-330 (dispatched by `hot_gather` :344):
//
//   out[i*vw + j] = midx[i] >= 0 ? mirror[midx[i]*vw + j]
//                                : tab[idx[i]*vw + j]
//
// Equal to gather_rows(tab, idx, vw) whenever the mirror mirrors the
// table, which the engines' write-through installs keep true. The
// SmallBank hot route reads its balances with it (K = 3w lanes over the
// [2N+1] balances and the [2 * hot_n] mirror; 1,920,000 words at 24M
// accounts), and in the exact lock regime its held stamps too.
//
// Bound: bytes. Each lane reads one random 32-byte sector, of the mirror
// or of the table, plus the midx and output streams and the cold lanes'
// idx (a hot lane's idx is never read); the arithmetic is nil. The TPU kernel copies the whole mirror into VMEM first, so that
// hot lanes cost no HBM access. That has no direct twin here: the mirror
// is 7.7 MB at 24M accounts and a block has at most 227 KB of shared
// memory. So the mirror stays a plain global array, and the hot lanes'
// own traffic keeps it in the 50 MB L2. (A persisting-L2 access window
// would pin it there; that is a design for a later change, once a
// measurement asks for it.) One thread takes one (lane, word) output, as
// in gather_rows.cu.
//
// Hot lanes' midx must lie in [0, n_mirror_rows) and cold lanes' idx in
// [0, n_rows); device asserts enforce both. A hot lane's idx is not read.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_rows_hot_kernel(const uint32_t* __restrict__ tab,
                                       const uint32_t* __restrict__ mirror,
                                       const int32_t* __restrict__ idx,
                                       const int32_t* __restrict__ midx,
                                       uint32_t* __restrict__ out,
                                       int64_t total, int64_t n_rows,
                                       int64_t n_mirror_rows, int vw) {
  int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int64_t lane = o / vw;
  int64_t j = o - lane * vw;
  int64_t m = midx[lane];
  if (m >= 0) {
    assert(m < n_mirror_rows);
    out[o] = __ldg(mirror + m * vw + j);
  } else {
    int64_t r = idx[lane];
    assert(r >= 0 && r < n_rows);
    out[o] = __ldg(tab + r * vw + j);
  }
}

}  // namespace

extern "C" int dint_gather_rows_hot(const void* tab, const void* mirror,
                                    const void* idx, const void* midx,
                                    void* out, int64_t k, int64_t n_rows,
                                    int64_t n_mirror_rows, int vw,
                                    void* stream) {
  int64_t total = k * vw;
  if (total > 0) {
    const int threads = 256;
    unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    gather_rows_hot_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(tab),
        static_cast<const uint32_t*>(mirror),
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(midx),
        static_cast<uint32_t*>(out), total, n_rows, n_mirror_rows, vw);
  }
  return static_cast<int>(cudaGetLastError());
}
