// gather_pass.cuh: the one-launch row gather shared by gather_rows.cu (B1)
// and gather_rows_hot.cu (B6), which differ only in B6's mirror. Both
// kernels are `gather_pass_kernel<kHot>` over a launch planned on the host
// (row_kernels.gather_plan). Per stream s (at most 8 a launch):
//
//   no mirror:  out_s[i*vw_s + j] = tab_s[idx_s[i]*vw_s + j]
//   mirror:     out_s[i*vw_s + j] = midx_s[i] >= 0
//                                   ? mirror_s[midx_s[i]*vw_s + j]
//                                   : tab_s[idx_s[i]*vw_s + j]
//
// for 0 <= i < K_s, 0 <= j < vw_s. A hot lane's idx is never used to
// address anything, nor asserted.
//
// Bound: bytes. Each lane reads one random 32-byte sector (two at most for
// a 40-byte row) plus the index and output streams; the arithmetic is nil.
// At the main paths' K (4,096 to 65,536 lanes) the work is a few µs of
// memory traffic, so a launch costs about as much as its bytes: the design
// gathers all of a step's streams in one launch.
//
// Design (the same plan shape as scatter_streams.cu, B3):
//   - One flat 1-D grid of sum_s blocks_s blocks. Stream s owns blocks
//     [first_block[s], first_block[s+1]), sized from its own K and row
//     width; an empty stream owns none. A block finds its stream by
//     comparing blockIdx.x with the at most 8 offsets. The plan rides as a
//     __grid_constant__ parameter, so a field indexed by the block's stream
//     is read from the parameter bank, never copied to a local frame.
//   - vw = 1: a thread takes vec[s] = 2 lanes. It loads their indices
//     (and mirror indices) with one 8-byte load each, issues two
//     independent table loads, and stores the words with one 8-byte store.
//     The host checks the alignment of idx, midx and out, so an offset
//     view falls back to one lane a thread (vec[s] = 1); a ragged tail
//     takes its lane alone.
//   - vw > 1: a group of 2^tpr_log2[s] threads takes whole rows (B3's row
//     groups), moving vec[s] words a load where the row width and the
//     table, mirror and output pointers allow it. No divide by vw.
//   - Index arithmetic is 32-bit (the host checks K * vw < 2^31); only the
//     table offset is 64-bit.
//   - With a mirror, a lane loads idx and midx together and picks its
//     source with a select, `m >= 0 ? mirror + m*vw : tab + r*vw`: two
//     memory round trips (indices, then the row), no divergence between a
//     warp's hot and cold lanes.
//   - Table and mirror rows are read through the read-only path without
//     an L1 line (ld_row below): random rows, never written during the
//     launch, never read twice by design.
//
// Indices must lie in range: a hot lane's midx in [0, n_mirror_rows), a
// cold lane's idx in [0, n_rows). A device assert checks the index that was
// chosen, so an out-of-range index fails the launch's stream (reported at
// the next synchronise) instead of reading past the table.
#pragma once

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 8;

// 128 threads a block and 2 lanes a thread at vw = 1: the fastest of
// {128, 256} threads x {1, 2, 4} lanes summed over the main paths' calls
// on the H100, all within 5% of each other (PERF.md §6). The host's plan
// uses the same number (row_kernels.GATHER_THREADS).
constexpr int kThreads = 128;

// The by-value launch argument, for at most kCap streams; the host picks
// the smallest capacity of 1, 2, 4 and 8 that holds a call's streams,
// because a larger parameter block costs launch time: the 616-byte plan
// of 8 took 0.08-0.28 µs more a launch on the H100 than the 160-byte
// plan of 2 at the main paths' one- and two-stream calls (PERF.md §6).
// row_kernels._gather_plan_struct mirrors it.
template <int kCap>
struct GatherPlan {
  const uint32_t* tab[kCap];
  const uint32_t* mirror[kCap];  // null without a mirror
  const int32_t* idx[kCap];
  const int32_t* midx[kCap];     // null without a mirror
  uint32_t* out[kCap];
  int64_t n_rows[kCap];
  int64_t n_mirror_rows[kCap];
  int32_t k[kCap];
  int32_t vw[kCap];        // words per row
  int32_t vec[kCap];       // vw = 1: lanes a thread (1, 2); else words
                           // a load (1, 2, 4)
  int32_t tpr_log2[kCap];  // vw > 1: log2 of the threads per row
  uint32_t first_block[kCap + 1];  // exclusive prefix; [n] = total
  int32_t n_streams;
};
static_assert(sizeof(GatherPlan<1>) == 88 && sizeof(GatherPlan<2>) == 160
              && sizeof(GatherPlan<4>) == 312
              && sizeof(GatherPlan<8>) == 616,
              "row_kernels._gather_plan_struct");

// One stream's fields, read once per thread.
struct Stream {
  const uint32_t* tab;
  const uint32_t* mirror;
  const int32_t* idx;
  const int32_t* midx;
  uint32_t* out;
  int64_t n_rows;
  int64_t n_mirror_rows;
  uint32_t k;
};

// Table and mirror rows are random sectors that no other lane of the
// launch reads again: loaded through the read-only path without an L1
// line (ld.global.nc.L1::no_allocate), 4.6-8.3% faster than plain __ldg
// at the main paths' shapes on the H100 (PERF.md §6). An L2 evict_last
// policy on the mirror rows gained nothing there, and is not used.
__device__ __forceinline__ uint32_t ld_row(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_row(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 ld_row(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// The first word of the row lane (r, m) reads: the mirror's row m for a hot
// lane (m >= 0, kHot only), else the table's row r. Asserts the chosen
// index's range.
template <bool kHot>
__device__ __forceinline__ const uint32_t* row_src(const Stream& st,
                                                   int32_t r, int32_t m,
                                                   int vw) {
  const bool hot = kHot && m >= 0;
  const int64_t row = hot ? m : r;
  assert(row >= 0 && row < (hot ? st.n_mirror_rows : st.n_rows));
  return (hot ? st.mirror : st.tab) + row * vw;
}

template <int L>
__device__ __forceinline__ void ld_lanes(int32_t (&v)[L], const int32_t* p) {
  if constexpr (L == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int L>
__device__ __forceinline__ void st_lanes(uint32_t* p, const uint32_t (&v)[L]) {
  if constexpr (L == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// vw = 1: thread t takes lanes [t*L, t*L + L) of the stream.
template <bool kHot, int L>
__device__ __forceinline__ void gather_lanes(const Stream& st, uint32_t t) {
  const uint32_t i0 = t * L;
  if (i0 >= st.k) return;
  if (i0 + L <= st.k) {
    int32_t r[L], m[L];
    ld_lanes<L>(r, st.idx + i0);
    if constexpr (kHot) {
      ld_lanes<L>(m, st.midx + i0);
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) m[j] = -1;
    }
    uint32_t v[L];
#pragma unroll
    for (int j = 0; j < L; ++j)
      v[j] = ld_row(row_src<kHot>(st, r[j], m[j], 1));
    st_lanes<L>(st.out + i0, v);
    return;
  }
  for (uint32_t i = i0; i < st.k; ++i) {      // the ragged tail
    const int32_t r = __ldg(st.idx + i);
    const int32_t m = kHot ? __ldg(st.midx + i) : -1;
    st.out[i] = ld_row(row_src<kHot>(st, r, m, 1));
  }
}

// vw > 1: a group of 2^lg threads takes row t >> lg, moving units of T.
template <bool kHot, typename T>
__device__ __forceinline__ void gather_row(const Stream& st, uint32_t t,
                                           int vw, int lg) {
  const uint32_t row = t >> lg;
  if (row >= st.k) return;
  const int32_t r = __ldg(st.idx + row);      // one load a row, shared
  const int32_t m = kHot ? __ldg(st.midx + row) : -1;
  const T* src = reinterpret_cast<const T*>(row_src<kHot>(st, r, m, vw));
  T* dst = reinterpret_cast<T*>(st.out + row * static_cast<uint32_t>(vw));
  constexpr int kWords = sizeof(T) / 4;
  const int n = vw / kWords;
  const int group = 1 << lg;
#pragma unroll 4
  for (int c = t & (group - 1); c < n; c += group)
    dst[c] = ld_row(src + c);
}

template <bool kHot, int kCap>
__global__ void __launch_bounds__(kThreads)
gather_pass_kernel(const __grid_constant__ GatherPlan<kCap> p) {
  const unsigned b = blockIdx.x;
  // the stream whose block range holds b: the last non-empty stream whose
  // first block is <= b (an empty stream shares its successor's offset)
  int s = 0;
#pragma unroll
  for (int i = 1; i < kCap; ++i)
    s += (i < p.n_streams && p.first_block[i] <= b) ? 1 : 0;
  const Stream st{p.tab[s], p.mirror[s], p.idx[s], p.midx[s], p.out[s],
                  p.n_rows[s], p.n_mirror_rows[s],
                  static_cast<uint32_t>(p.k[s])};
  const uint32_t t = (b - p.first_block[s]) * kThreads + threadIdx.x;
  const int vw = p.vw[s];
  const int vec = p.vec[s];
  if (vw == 1) {
    if (vec == 2) {
      gather_lanes<kHot, 2>(st, t);
    } else {
      gather_lanes<kHot, 1>(st, t);
    }
  } else {
    const int lg = p.tpr_log2[s];
    switch (vec) {
      case 4: gather_row<kHot, uint4>(st, t, vw, lg); break;
      case 2: gather_row<kHot, uint2>(st, t, vw, lg); break;
      default: gather_row<kHot, uint32_t>(st, t, vw, lg);
    }
  }
}

template <bool kHot, int kCap>
int gather_launch_cap(const void* plan, void* stream) {
  const GatherPlan<kCap> p = *static_cast<const GatherPlan<kCap>*>(plan);
  if (p.n_streams < 1 || p.n_streams > kCap)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = p.first_block[p.n_streams];
  if (blocks > 0) {
    gather_pass_kernel<kHot, kCap><<<blocks, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// `plan` points to a host GatherPlan<capacity> laid out as above (the
// wrapper builds it with ctypes from row_kernels.gather_plan); it is copied
// into the launch's parameters. One launch of first_block[n_streams]
// blocks, none when every stream is empty.
template <bool kHot>
int gather_launch(const void* plan, int capacity, void* stream) {
  switch (capacity) {
    case 1: return gather_launch_cap<kHot, 1>(plan, stream);
    case 2: return gather_launch_cap<kHot, 2>(plan, stream);
    case 4: return gather_launch_cap<kHot, 4>(plan, stream);
    case kMaxStreams: return gather_launch_cap<kHot, kMaxStreams>(plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
