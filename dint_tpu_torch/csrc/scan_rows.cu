// scan_rows: K windows of `lg` consecutive rows of the store's ordered run.
//
// Replaces the Pallas kernel `scan_rows` / `_scan_kernel` of
// dint_tpu/ops/pallas_gather.py:359-445 (dispatcher `scan_slab` :458).
//
//   out_hi [i*lg + t]          = run_hi [off[i] + t]        0 <= t < lg
//   out_lo, out_ver              likewise
//   out_val[i*lg*vw + u]       = run_val[off[i]*vw + u]     0 <= u < lg*vw
//
// The store step runs it once per step of the scan runner, on every lane
// (scan or not): K = w = 4096 windows of lg = scan_max + delta_cap = 356
// rows over the 67,108,864-row run, vw = 10.
//
// Bound: bytes. Each lane copies 3 x 356 words and 3,560 val words: 75.8
// MB written a step, and at most as much read; the arithmetic is nil. The
// hot key skew makes windows overlap: at the main path's offsets
// chip_smoke.py counts ~44.6 MB of distinct 32-byte sectors read, so the
// bound is ~36 us at 3.35 TB/s (45.3 us without overlap).
//
// The TPU kernel is one sequential program that keeps a ring of four DMAs
// a lane in flight, walking lanes in ascending offset so that
// consecutive DMAs touch adjacent HBM. On Hopper the lanes are
// independent: one thread block a lane, whose threads copy the window
// with coalesced loads and stores, first the three 356-word key and
// version windows, then the val window. A val window starts at off*40
// bytes, which is only 8-byte aligned, so the val copy moves 8-byte words
// when source and destination allow it, 4-byte words otherwise. No lane
// order is needed: the output does not depend on one.
//
// Every offset must lie in [0, cap - lg] (the engine clamps them). A
// device assert enforces it, so a bad offset fails the launch's stream
// (reported at the next synchronise) instead of reading past the run.
#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void scan_rows_kernel(const uint32_t* __restrict__ hi,
                                 const uint32_t* __restrict__ lo,
                                 const uint32_t* __restrict__ ver,
                                 const uint32_t* __restrict__ val,
                                 const int32_t* __restrict__ off,
                                 uint32_t* __restrict__ out_hi,
                                 uint32_t* __restrict__ out_lo,
                                 uint32_t* __restrict__ out_ver,
                                 uint32_t* __restrict__ out_val,
                                 int64_t cap, int lg, int vw) {
  const int64_t lane = blockIdx.x;
  const int64_t base = off[lane];
  assert(base >= 0 && base + lg <= cap);
  const int64_t o = lane * lg;
  for (int t = threadIdx.x; t < lg; t += blockDim.x) {
    out_hi[o + t] = __ldg(hi + base + t);
    out_lo[o + t] = __ldg(lo + base + t);
    out_ver[o + t] = __ldg(ver + base + t);
  }
  const int64_t n = static_cast<int64_t>(lg) * vw;
  const uint32_t* src = val + base * vw;
  uint32_t* dst = out_val + o * vw;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 7) == 0 && (n & 1) == 0) {
    const uint2* s2 = reinterpret_cast<const uint2*>(src);
    uint2* d2 = reinterpret_cast<uint2*>(dst);
    for (int64_t u = threadIdx.x; u < n / 2; u += blockDim.x) {
      d2[u] = __ldg(s2 + u);
    }
  } else {
    for (int64_t u = threadIdx.x; u < n; u += blockDim.x) {
      dst[u] = __ldg(src + u);
    }
  }
}

}  // namespace

extern "C" int dint_scan_rows(const void* hi, const void* lo, const void* ver,
                              const void* val, const void* off, void* out_hi,
                              void* out_lo, void* out_ver, void* out_val,
                              int64_t k, int64_t cap, int lg, int vw,
                              void* stream) {
  if (k > 0) {
    scan_rows_kernel<<<static_cast<unsigned>(k), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<const uint32_t*>(ver), static_cast<const uint32_t*>(val),
        static_cast<const int32_t*>(off), static_cast<uint32_t*>(out_hi),
        static_cast<uint32_t*>(out_lo), static_cast<uint32_t*>(out_ver),
        static_cast<uint32_t*>(out_val), cap, lg, vw);
  }
  return static_cast<int>(cudaGetLastError());
}
