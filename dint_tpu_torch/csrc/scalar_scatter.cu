// scalar_scatter: a copy of a u32 table with K scalar stores applied in
// lane order, so that where lanes share an index the last lane wins, in one
// cooperative launch.
//
// Replaces the Pallas kernel `pallas_scatter` / `kernel` of
// tools/profile_pallas.py:35-56, the round-3 feasibility probe:
//
//   out = tab
//   for i in 0 .. K-1:  out[idx[i] / C, idx[i] % C] = val[i]
//
// (the table is [N / C, C]; here it is addressed as N flat words).
//
// Design. The TPU kernel holds the whole table in VMEM and walks the lanes
// in one serial loop of scalar stores; that is the design point the probe
// tested. It has no twin on Hopper: the probe's table is 8,800,256 bytes,
// far above the 227 KB of shared memory a block may use (it does fit in the
// 50 MB L2, which the copy leaves it in), and a serial loop would use one
// thread of the card. So the lanes run in parallel, and the lane order the
// loop gave for free is rebuilt with `win`, one word per table word, all -1
// between calls. One kernel, launched cooperatively over a grid the card
// holds at once (cooperative.cuh):
//
//   1. the copy: thread tid copies its share of tab to out in 16-byte
//      words (kUnroll loads in flight, then their stores) where both are
//      16-byte aligned, else in words;
//   2. claims: thread tid takes lanes tid, tid + G, ... (G threads in the
//      grid, so the claims sit in the low blocks) and issues
//      atomicMax(win[idx[i]], i), a reduction it does not wait on; its
//      first lane's index and value stay in registers;
//   3. a grid barrier (`this_grid().sync()`): the copy is written and every
//      claim has landed, so win[r] holds the last lane naming r;
//   4. stores: lane i stores val[i] to out[idx[i]] iff win[idx[i]] == i
//      (read at L2), then, as its index's only winner, sets win[idx[i]]
//      back to -1. A lane that reads win after that reset sees -1, never its
//      own lane, so it still loses. So `win` is left clean for the next call
//      on the stream, and no memset runs: the wrapper allocates it cleared
//      once, per device and stream, and passes it to every call (a CUDA
//      graph replays a captured call the same way).
// Nothing else goes on the stream. A lane's only wait before the barrier is
// its index load: a claim table hashed to O(K) slots (the first design)
// made each lane wait on atomicCAS round trips, one a probe, and was slower
// than the copy. The grid is one block an SM (the wrapper's plan): the
// barrier costs more the more blocks it joins, and 132 blocks of 512
// threads keep enough of the copy's loads in flight. Both were measured on
// the H100, as were claiming before the copy (slower: the claiming threads
// start their copy one index load late) and an L2 evict_last hint on the
// copy's stores (no change); PERF.md §6 has the times.
//
// Bound: bytes. The table is read once and the output written once, plus
// the idx and val streams; the stores of step 4 land in sectors the copy
// just wrote, which the L2 still holds, and win's K random words are L2
// traffic too. The arithmetic is nil.
//
// idx must lie in [0, n); a device assert enforces it. A refused launch
// returns its error; there is no other path.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

struct ScalarScatter {
  const uint32_t* tab;
  uint32_t* out;
  const int32_t* idx;
  const uint32_t* val;
  int32_t* win;                 // [>= n]: -1 between calls
  int64_t n, k;
};

// 2. a thread claims lanes first, first + G, ...
__device__ __forceinline__ void claim(const ScalarScatter& a, int64_t g,
                                      int64_t first) {
  for (int64_t i = first; i < a.k; i += g) {
    const int32_t r = a.idx[i];
    assert(r >= 0 && r < a.n);
    atomicMax(a.win + r, static_cast<int32_t>(i));
  }
}

// 1. thread tid copies its share of the table
__device__ __forceinline__ void copy(const ScalarScatter& a, int64_t tid,
                                     int64_t g) {
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(a.tab)
        | reinterpret_cast<uintptr_t>(a.out)) & 15) == 0) {
    const int64_t n4 = a.n / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(a.tab);
    uint4* d4 = reinterpret_cast<uint4*>(a.out);
    int64_t j = tid;
    for (; j + (kUnroll - 1) * g < n4; j += kUnroll * g) {
      uint4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldcs(s4 + j + u * g);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d4[j + u * g] = x[u];
    }
    for (; j < n4; j += g) d4[j] = __ldcs(s4 + j);
    done = n4 * 4;
  }
  for (int64_t j = done + tid; j < a.n; j += g) a.out[j] = a.tab[j];
}

__global__ void __launch_bounds__(kThreads)
scalar_scatter_kernel(const __grid_constant__ ScalarScatter a) {
  const int64_t g = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  copy(a, tid, g);
  // the first lane's index and value stay in registers across the barrier
  const bool first = tid < a.k;
  int32_t r0 = 0;
  uint32_t v0 = 0;
  if (first) {
    r0 = a.idx[tid];
    v0 = a.val[tid];
    assert(r0 >= 0 && r0 < a.n);
    atomicMax(a.win + r0, static_cast<int32_t>(tid));
  }
  claim(a, g, tid + g);

  cg::this_grid().sync();       // the copy is written, every claim landed

  // 4. the winners' stores, each winner clearing its word of win
  if (first && __ldcg(a.win + r0) == static_cast<int32_t>(tid)) {
    a.out[r0] = v0;
    a.win[r0] = -1;
  }
  for (int64_t i = tid + g; i < a.k; i += g) {
    const int32_t r = a.idx[i];
    if (__ldcg(a.win + r) == static_cast<int32_t>(i)) {
      a.out[r] = a.val[i];
      a.win[r] = -1;
    }
  }
}

}  // namespace

// The most blocks of scalar_scatter_kernel a cooperative launch may have on
// `device` (SMs times blocks an SM holds), or the CUDA error
// (cudaErrorNotSupported where the device has no cooperative launch).
extern "C" int dint_scalar_scatter_grid(int device, int* blocks) {
  return static_cast<int>(
      cooperative_grid(scalar_scatter_kernel, kThreads, device, blocks));
}

// One cooperative launch of `blocks` blocks of kThreads. `win` is the
// wrapper's table of at least n words, all -1 on entry and on return (not
// read when K = 0).
extern "C" int dint_scalar_scatter(const void* tab, void* out,
                                   const void* idx, const void* val,
                                   void* win, int64_t n, int64_t k,
                                   int blocks, void* stream) {
  if (blocks < 1 || (k > 0 && win == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ScalarScatter a{static_cast<const uint32_t*>(tab),
                  static_cast<uint32_t*>(out),
                  static_cast<const int32_t*>(idx),
                  static_cast<const uint32_t*>(val),
                  static_cast<int32_t*>(win), n, k};
  return static_cast<int>(
      cooperative_launch(scalar_scatter_kernel, a, blocks, kThreads, stream));
}
