// scatter_pass.cuh: the one-launch masked row scatter shared by
// scatter_streams.cu (B3) and scatter_rows_hot.cu (B7), which differ only in
// B7's mirror and mask. Both kernels are `scatter_pass_kernel<kHot>` over a
// launch planned on the host (row_kernels.scatter_plan). Per stream s (at
// most 8 a launch), for 0 <= i < K_s and 0 <= j < vw_s:
//
//   no mirror:  if idx_s[i] >= 0:
//                 tab_s[idx_s[i]*vw_s + j] = vals_s[i*vw_s + j]
//   mirror:     if mask_s[i]:
//                 tab_s[idx_s[i]*vw_s + j] = vals_s[i*vw_s + j]
//               if mask_s[i] && midx_s[i] >= 0:
//                 mirror_s[midx_s[i]*vw_s + j] = vals_s[i*vw_s + j]
//
// Masked-in indices are unique within a stream (the engines' one-writer-per-
// row certification; a mirror row shadows one table row) and the tables and
// mirrors of a launch are distinct arrays (the wrapper checks it), so no two
// threads store to one word: plain stores, no atomics, and the result does
// not depend on the order the threads run in. The values are never a table
// or mirror of the launch (the wrapper checks their storages too), so they
// are loaded through the read-only path.
//
// Bound: bytes. Each masked-in lane writes vw words into one or a few
// 32-byte sectors of its table (and of the mirror), and reads its value row
// and its index and flag words; the arithmetic is nil. At the main paths'
// K (4,096 to 24,576 lanes) that is well under a µs of memory traffic, so a
// launch costs about the launch: the callers write all of an install's
// tables as the streams of one launch.
//
// Design (the plan shape of the gather pass, gather_pass.cuh):
//   - One flat 1-D grid of sum_s blocks_s blocks. Stream s owns blocks
//     [first_block[s], first_block[s+1]), sized from its own K and row
//     width; an empty stream owns none. A block finds its stream by
//     comparing blockIdx.x with the at most 8 offsets of the
//     __grid_constant__ plan, read from the parameter bank.
//   - vw = 1: a thread takes vec[s] = 2 lanes. It loads their indices,
//     mirror indices and values with one 8-byte load each and their mask
//     flags with one 2-byte load, all at once: a lane's value does not
//     depend on its index. Then the stores, independent of each other. The
//     host checks the alignment of idx, midx, vals and mask, so an offset
//     view takes one lane a thread (vec[s] = 1); a ragged tail takes its
//     lanes one at a time.
//   - vw > 1: a group of 2^tpr_log2[s] threads takes whole rows (B3's row
//     groups), moving vec[s] words a load and a store where the row width
//     and the table, mirror and value pointers allow it. With a mirror, a
//     thread loads its first value unit together with the row's index,
//     mirror index and flag: one round trip to memory, then the stores.
//     Without one, the value waits for the index, so that a masked-out
//     row reads no value: B3's mirror streams mask out most of their
//     lanes, and on the H100 the early load was 0.2-0.5% slower there
//     (PERF.md §6). Without a mirror, a thread whose row has more units
//     than its group loads kAhead of them before it stores them. No
//     divide by vw.
//   - The value row is read once and stored to both the table and the
//     mirror.
//   - Index arithmetic is 32-bit (the host checks K * vw < 2^31); only the
//     table and mirror offsets are 64-bit.
//
// A masked-out lane (mask == 0 with a mirror, idx < 0 without) stores
// nothing. With a mirror its idx and midx words may be loaded beside its
// neighbours' but never address anything and are never asserted: they may
// hold anything. A device assert checks each index that is used against its
// table's (or mirror's) rows, so an out-of-range index fails the launch's
// stream (reported at the next synchronise) instead of writing past the
// table.
#pragma once

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 8;

// Threads a block; the host's plan uses the same number
// (row_kernels.SCATTER_THREADS).
constexpr int kThreads = 128;

// Units a thread of a row group loads before it stores them, without a
// mirror. On the H100 at TATP's install_log, 2 took 6.51-6.55 µs a launch,
// 4 took 7.14-7.22 and a load-store pair at a time 7.33-7.42 (PERF.md §6).
constexpr int kAhead = 2;

// The by-value launch argument, for at most kCap streams; the host picks
// the smallest capacity of 1, 2, 4 and 8 that holds a call's streams (a
// larger parameter block costs launch time, as in the gather pass).
// row_kernels._SCATTER_STRUCTS mirrors it.
template <int kCap>
struct ScatterPlan {
  uint32_t* tab[kCap];
  uint32_t* mirror[kCap];        // null without a mirror
  const int32_t* idx[kCap];
  const int32_t* midx[kCap];     // null without a mirror
  const uint8_t* mask[kCap];     // null without a mirror
  const uint32_t* vals[kCap];
  int64_t n_rows[kCap];
  int64_t n_mirror_rows[kCap];
  int32_t k[kCap];
  int32_t vw[kCap];        // words per row
  int32_t vec[kCap];       // vw = 1: lanes a thread (1, 2); else words
                           // a load and a store (1, 2, 4)
  int32_t tpr_log2[kCap];  // vw > 1: log2 of the threads per row
  uint32_t first_block[kCap + 1];  // exclusive prefix; [n] = total
  int32_t n_streams;
};
static_assert(sizeof(ScatterPlan<1>) == 96 && sizeof(ScatterPlan<2>) == 176
              && sizeof(ScatterPlan<4>) == 344
              && sizeof(ScatterPlan<8>) == 680,
              "row_kernels._SCATTER_STRUCTS");

// One stream's fields, read once per thread.
struct Stream {
  uint32_t* tab;
  uint32_t* mirror;
  const int32_t* idx;
  const int32_t* midx;
  const uint8_t* mask;
  const uint32_t* vals;
  int64_t n_rows;
  int64_t n_mirror_rows;
  uint32_t k;
};

// L consecutive 4-byte words (indices or values) in one load.
template <int L, typename W>
__device__ __forceinline__ void ld_lanes(W (&v)[L], const W* p) {
  static_assert(sizeof(W) == 4, "4-byte lanes");
  if constexpr (L == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = static_cast<W>(x.x);
    v[1] = static_cast<W>(x.y);
  } else {
    v[0] = __ldg(p);
  }
}

// L consecutive mask flags (bool bytes) in one load.
template <int L>
__device__ __forceinline__ void ld_flags(bool (&on)[L], const uint8_t* p) {
  if constexpr (L == 2) {
    const unsigned short x = __ldg(reinterpret_cast<const unsigned short*>(p));
    on[0] = (x & 0xffu) != 0;
    on[1] = (x >> 8) != 0;
  } else {
    on[0] = __ldg(p) != 0;
  }
}

// vw = 1: one lane's write, if the lane is masked in.
template <bool kHot>
__device__ __forceinline__ void put_word(const Stream& st, bool on, int32_t r,
                                         int32_t m, uint32_t v) {
  if (kHot ? !on : r < 0) return;
  assert(r >= 0 && r < st.n_rows);
  st.tab[r] = v;
  if (kHot && m >= 0) {
    assert(m < st.n_mirror_rows);
    st.mirror[m] = v;
  }
}

// vw = 1: thread t takes lanes [t*L, t*L + L) of the stream.
template <bool kHot, int L>
__device__ __forceinline__ void scatter_lanes(const Stream& st, uint32_t t) {
  const uint32_t i0 = t * L;
  if (i0 >= st.k) return;
  if (i0 + L <= st.k) {
    int32_t r[L], m[L];
    uint32_t v[L];
    bool on[L];
    ld_lanes<L>(r, st.idx + i0);
    ld_lanes<L>(v, st.vals + i0);
    if constexpr (kHot) {
      ld_lanes<L>(m, st.midx + i0);
      ld_flags<L>(on, st.mask + i0);
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        m[j] = -1;
        on[j] = true;
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) put_word<kHot>(st, on[j], r[j], m[j], v[j]);
    return;
  }
  for (uint32_t i = i0; i < st.k; ++i) {      // the ragged tail
    put_word<kHot>(st, kHot ? __ldg(st.mask + i) != 0 : true,
                   __ldg(st.idx + i), kHot ? __ldg(st.midx + i) : -1,
                   __ldg(st.vals + i));
  }
}

// vw > 1: a group of 2^lg threads takes row t >> lg, moving units of T.
template <bool kHot, typename T>
__device__ __forceinline__ void scatter_row(const Stream& st, uint32_t t,
                                            int vw, int lg) {
  const uint32_t row = t >> lg;
  if (row >= st.k) return;
  constexpr int kWords = sizeof(T) / 4;
  const int n = vw / kWords;
  const int group = 1 << lg;
  int c = static_cast<int>(t) & (group - 1);
  if (c >= n) return;                         // a group wider than the row
  const T* src = reinterpret_cast<const T*>(
      st.vals + row * static_cast<uint32_t>(vw));
  const int32_t r = __ldg(st.idx + row);      // one load a row, shared
  const int32_t m = kHot ? __ldg(st.midx + row) : -1;
  T x;
  if constexpr (kHot) x = __ldg(src + c);     // with the row's flag load
  if (kHot ? __ldg(st.mask + row) == 0 : r < 0) return;
  if constexpr (!kHot) x = __ldg(src + c);    // only for a live row
  assert(r >= 0 && r < st.n_rows);
  T* dst = reinterpret_cast<T*>(st.tab + static_cast<int64_t>(r) * vw);
  T* mdst = nullptr;
  if (kHot && m >= 0) {
    assert(m < st.n_mirror_rows);
    mdst = reinterpret_cast<T*>(st.mirror + static_cast<int64_t>(m) * vw);
  }
  if constexpr (kHot) {
    for (;;) {
      dst[c] = x;
      if (mdst != nullptr) mdst[c] = x;
      c += group;
      if (c >= n) break;
      x = __ldg(src + c);
    }
  } else {
    // a row longer than its group (the log's 42-word rows: 21 units over
    // 16 threads): a thread loads its next unit before it stores either
    T y[kAhead];
    y[0] = x;
    for (;;) {
#pragma unroll
      for (int u = 1; u < kAhead; ++u)
        if (c + u * group < n) y[u] = __ldg(src + c + u * group);
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (c + u * group < n) dst[c + u * group] = y[u];
      c += kAhead * group;
      if (c >= n) break;
      y[0] = __ldg(src + c);
    }
  }
}

template <bool kHot, int kCap>
__global__ void __launch_bounds__(kThreads)
scatter_pass_kernel(const __grid_constant__ ScatterPlan<kCap> p) {
  const unsigned b = blockIdx.x;
  // the stream whose block range holds b: the last non-empty stream whose
  // first block is <= b (an empty stream shares its successor's offset)
  int s = 0;
#pragma unroll
  for (int i = 1; i < kCap; ++i)
    s += (i < p.n_streams && p.first_block[i] <= b) ? 1 : 0;
  const Stream st{p.tab[s], p.mirror[s], p.idx[s], p.midx[s], p.mask[s],
                  p.vals[s], p.n_rows[s], p.n_mirror_rows[s],
                  static_cast<uint32_t>(p.k[s])};
  const uint32_t t = (b - p.first_block[s]) * kThreads + threadIdx.x;
  const int vw = p.vw[s];
  const int vec = p.vec[s];
  if (vw == 1) {
    if (vec == 2) {
      scatter_lanes<kHot, 2>(st, t);
    } else {
      scatter_lanes<kHot, 1>(st, t);
    }
  } else {
    const int lg = p.tpr_log2[s];
    switch (vec) {
      case 4: scatter_row<kHot, uint4>(st, t, vw, lg); break;
      case 2: scatter_row<kHot, uint2>(st, t, vw, lg); break;
      default: scatter_row<kHot, uint32_t>(st, t, vw, lg);
    }
  }
}

template <bool kHot, int kCap>
int scatter_launch_cap(const void* plan, void* stream) {
  const ScatterPlan<kCap> p = *static_cast<const ScatterPlan<kCap>*>(plan);
  if (p.n_streams < 1 || p.n_streams > kCap)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = p.first_block[p.n_streams];
  if (blocks > 0) {
    scatter_pass_kernel<kHot, kCap><<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// `plan` points to a host ScatterPlan<capacity> laid out as above (the
// wrapper builds it with ctypes from row_kernels.scatter_plan); it is
// copied into the launch's parameters. One launch of first_block[n_streams]
// blocks, none when every stream is empty.
template <bool kHot>
int scatter_launch(const void* plan, int capacity, void* stream) {
  switch (capacity) {
    case 1: return scatter_launch_cap<kHot, 1>(plan, stream);
    case 2: return scatter_launch_cap<kHot, 2>(plan, stream);
    case 4: return scatter_launch_cap<kHot, 4>(plan, stream);
    case kMaxStreams:
      return scatter_launch_cap<kHot, kMaxStreams>(plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
