// scatter_rows_hot: the hot tier's write-through install. Every masked-in
// lane writes its row into the full table and, where it has a mirror
// index, into the hot mirror too; both are updated in place.
//
// Replaces the Pallas kernel `scatter_rows_hot` / `_scatter_hot_kernel`
// of dint_tpu/ops/pallas_gather.py:477-585 (dispatched by `hot_scatter`
// :588):
//
//   if mask[i]:                tab[idx[i]*vw + j]     = vals[i*vw + j]
//   if mask[i] && midx[i]>=0:  mirror[midx[i]*vw + j] = vals[i*vw + j]
//
// Masked-in indices are unique (one X-lock holder per row), and each
// mirror row shadows exactly one table row, so no two threads store to
// one word: plain stores, no atomics. The SmallBank hot route installs
// its balances with it (K = 3w lanes into the [2N+1] balances and the
// [2 * hot_n] mirror).
//
// Bound: bytes. Each masked-in lane writes one 32-byte sector of the
// table and, when hot, one of the mirror, plus the mask stream and the
// masked-in lanes' idx, midx and values; the arithmetic is nil. The TPU kernel walks the lanes
// with two 16-slot DMA rings and SMEM trackers of which lane holds a
// slot; here one thread takes one (lane, word) and the stores need no
// tracking.
//
// Masked-in idx must lie in [0, n_rows) and masked-in, hot midx in
// [0, n_mirror_rows); device asserts enforce both.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void scatter_rows_hot_kernel(uint32_t* __restrict__ tab,
                                        uint32_t* __restrict__ mirror,
                                        const int32_t* __restrict__ idx,
                                        const int32_t* __restrict__ midx,
                                        const uint8_t* __restrict__ mask,
                                        const uint32_t* __restrict__ vals,
                                        int64_t total, int64_t n_rows,
                                        int64_t n_mirror_rows, int vw) {
  int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int64_t lane = o / vw;
  if (mask[lane] == 0) return;
  int64_t j = o - lane * vw;
  uint32_t v = vals[o];
  int64_t r = idx[lane];
  assert(r >= 0 && r < n_rows);
  tab[r * vw + j] = v;
  int64_t m = midx[lane];
  if (m >= 0) {
    assert(m < n_mirror_rows);
    mirror[m * vw + j] = v;
  }
}

}  // namespace

extern "C" int dint_scatter_rows_hot(void* tab, void* mirror, const void* idx,
                                     const void* midx, const void* mask,
                                     const void* vals, int64_t k,
                                     int64_t n_rows, int64_t n_mirror_rows,
                                     int vw, void* stream) {
  int64_t total = k * vw;
  if (total > 0) {
    const int threads = 256;
    unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    scatter_rows_hot_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(tab), static_cast<uint32_t*>(mirror),
        static_cast<const int32_t*>(idx), static_cast<const int32_t*>(midx),
        static_cast<const uint8_t*>(mask),
        static_cast<const uint32_t*>(vals), total, n_rows, n_mirror_rows,
        vw);
  }
  return static_cast<int>(cudaGetLastError());
}
