// scalar_scatter: a copy of a u32 table with K scalar stores applied in
// lane order, so that where lanes share an index the last lane wins.
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
// 50 MB L2, which the copy below leaves it in), and a serial loop would use
// one thread of the card. So the lanes run in parallel, and the lane order
// the loop gave for free is rebuilt explicitly:
//
//   memset:   keys[] = win[] = -1          (2^ceil(log2 2K) slots each,
//             adjacent in one scratch array, so one memset clears both)
//   launch 1: blocks [0, copy_blocks) copy tab to out (16-byte words where
//             both are aligned); the other blocks take one lane a thread
//             and claim the slot of idx[i] in an open-addressed table
//             (atomicCAS on keys, linear probing), then atomicMax(win, i):
//             the slot ends up holding the last lane naming that index
//   launch 2: lane i stores val[i] to out[idx[i]] iff win[slot[i]] == i
//
// With at least 2K slots for at most K distinct indices, probing ends. The
// copy and the slot claims touch different arrays, so they share a launch;
// launch 2 runs after both, in stream order.
//
// Bound: bytes. The table is read once and the output written once, plus
// the idx and val streams; the stores of launch 2 land in sectors the copy
// just wrote, which the L2 still holds. The arithmetic is nil.
//
// idx must lie in [0, n); a device assert enforces it.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t slot_hash(int32_t r, uint32_t mask) {
  uint64_t h = static_cast<uint64_t>(static_cast<uint32_t>(r)) *
               0x9E3779B97F4A7C15ull;
  return static_cast<uint32_t>(h >> 32) & mask;
}

__global__ void copy_resolve_kernel(const uint32_t* __restrict__ tab,
                                    uint32_t* __restrict__ out, int64_t n,
                                    bool vec, unsigned copy_blocks,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ keys,
                                    int32_t* __restrict__ win,
                                    int32_t* __restrict__ slot, int64_t k,
                                    uint32_t mask) {
  if (blockIdx.x < copy_blocks) {
    int64_t stride = static_cast<int64_t>(copy_blocks) * blockDim.x;
    int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    int64_t done = 0;
    if (vec) {
      int64_t n4 = n / 4;
      const uint4* s4 = reinterpret_cast<const uint4*>(tab);
      uint4* d4 = reinterpret_cast<uint4*>(out);
      for (int64_t j = t; j < n4; j += stride) d4[j] = s4[j];
      done = n4 * 4;
    }
    for (int64_t j = done + t; j < n; j += stride) out[j] = tab[j];
    return;
  }
  int64_t i = static_cast<int64_t>(blockIdx.x - copy_blocks) * blockDim.x +
              threadIdx.x;
  if (i >= k) return;
  int32_t r = idx[i];
  assert(r >= 0 && r < n);
  uint32_t h = slot_hash(r, mask);
  while (true) {
    int32_t prev = atomicCAS(keys + h, -1, r);
    if (prev == -1 || prev == r) break;
    h = (h + 1) & mask;
  }
  atomicMax(win + h, static_cast<int32_t>(i));
  slot[i] = static_cast<int32_t>(h);
}

__global__ void store_kernel(uint32_t* __restrict__ out,
                             const int32_t* __restrict__ idx,
                             const uint32_t* __restrict__ val,
                             const int32_t* __restrict__ win,
                             const int32_t* __restrict__ slot, int64_t k) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  if (win[slot[i]] == static_cast<int32_t>(i)) out[idx[i]] = val[i];
}

}  // namespace

// scratch: keys [n_slots], win [n_slots], slot [k], one int32 array
extern "C" int dint_scalar_scatter(const void* tab, void* out,
                                   const void* idx, const void* val,
                                   void* scratch, int64_t n, int64_t k,
                                   int64_t n_slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  int32_t* keys = static_cast<int32_t*>(scratch);
  int32_t* win = keys + n_slots;
  int32_t* slot = win + n_slots;
  if (k > 0) {
    cudaError_t e = cudaMemsetAsync(
        keys, 0xFF, 2 * static_cast<size_t>(n_slots) * sizeof(int32_t), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bool vec = (reinterpret_cast<uintptr_t>(tab) % 16 == 0) &&
             (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  int64_t per_thread = vec ? 4 : 1;
  int64_t want = (n / per_thread + threads - 1) / threads;
  unsigned copy_blocks = static_cast<unsigned>(
      want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  unsigned lane_blocks = static_cast<unsigned>((k + threads - 1) / threads);
  copy_resolve_kernel<<<copy_blocks + lane_blocks, threads, 0, s>>>(
      static_cast<const uint32_t*>(tab), static_cast<uint32_t*>(out), n, vec,
      copy_blocks, static_cast<const int32_t*>(idx), keys, win, slot, k,
      static_cast<uint32_t>(n_slots - 1));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || k == 0) return static_cast<int>(e);
  store_kernel<<<lane_blocks, threads, 0, s>>>(
      static_cast<uint32_t*>(out), static_cast<const int32_t*>(idx),
      static_cast<const uint32_t*>(val), win, slot, k);
  return static_cast<int>(cudaGetLastError());
}
