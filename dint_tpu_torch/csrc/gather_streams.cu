// gather_streams: N independent row gathers in one launch.
//
// Replaces the Pallas kernel `gather_streams` / `_gather_streams_kernel`
// of dint_tpu/ops/pallas_gather.py:973-1012. Stream s gathers K_s rows of
// vw_s u32 words from its own flat table:
//
//   out_s[i*vw_s + j] = tab_s[idx_s[i]*vw_s + j]    0 <= i < K_s, j < vw_s
//
// so each stream equals gather_rows (gather_rows.cu) on its own. The
// SmallBank fused route runs it once per step over three streams: the X
// and S held-stamp reads (K = 3w lock-slot indices over the [H] stamp
// arrays) and the wave-1 balance read (K = 3w rows over [2N+1] balances).
//
// Bound: bytes. Each lane reads one random 32-byte sector of its table
// plus the index and output streams; the arithmetic is nil. The TPU kernel
// runs one 16-slot DMA ring per stream back to back inside one program.
// Here the streams' pointers, K and vw ride in a small struct passed by
// value, blockIdx.y picks the stream and one thread takes one (lane, word)
// output, so all streams' random reads are in flight together and the
// resident warps hide their latency.
//
// Indices must lie in [0, n_rows); a device assert enforces it, as in
// gather_rows.cu.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 8;

struct GatherStreams {
  const uint32_t* tab[kMaxStreams];
  const int32_t* idx[kMaxStreams];
  uint32_t* out[kMaxStreams];
  int64_t k[kMaxStreams];
  int64_t n_rows[kMaxStreams];
  int32_t vw[kMaxStreams];
};

__global__ void gather_streams_kernel(const GatherStreams a) {
  const int s = blockIdx.y;
  const int vw = a.vw[s];
  int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= a.k[s] * vw) return;
  int64_t lane = o / vw;
  int64_t j = o - lane * vw;
  int64_t r = a.idx[s][lane];
  assert(r >= 0 && r < a.n_rows[s]);
  a.out[s][o] = __ldg(a.tab[s] + r * vw + j);
}

}  // namespace

// `args` points to a host GatherStreams laid out as above (the wrapper
// builds it with ctypes); it is copied into the launch's parameters.
extern "C" int dint_gather_streams(const void* args, int n_streams,
                                   void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams)
    return static_cast<int>(cudaErrorInvalidValue);
  const GatherStreams a = *static_cast<const GatherStreams*>(args);
  int64_t most = 0;
  for (int s = 0; s < n_streams; ++s) {
    int64_t total = a.k[s] * a.vw[s];
    if (total > most) most = total;
  }
  if (most > 0) {
    const int threads = 256;
    dim3 grid(static_cast<unsigned>((most + threads - 1) / threads),
              static_cast<unsigned>(n_streams));
    gather_streams_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
