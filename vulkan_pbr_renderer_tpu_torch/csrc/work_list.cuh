// The raster kernels' work lists, built on the card by one block: shared by
// csrc/vis_folded.cu (K1), csrc/vis_rowblock.cu (K2) and csrc/vis_folded_hiz.cu
// (K1-hiz, which builds its own aligned list with the block scan).
//
// A work list is int4 rows (tile, lo, hi, pieces): each tile's pair range cut
// into pieces, then (-1, 0, 0, 0) to its static length.  Built in PyTorch ops
// the list costs some twenty launches a pass (raster/visibility_v2.py
// segment_work_list: clamp, cumsum, arange, searchsorted, four gathers, a
// stack and a cast), more host time than the raster kernel takes on the
// card; one block builds it here just before the raster kernel, from
// `starts`, with no host sync.  The plain versions stay in PyTorch: the CPU
// path and the tests use them, and chip_smoke.py holds these lists to them.
#pragma once

#include <cuda_runtime.h>

namespace work_list {

constexpr int kBuildThreads = 1024;

// Exclusive prefix sum of data[0, n) in place, by the whole block of
// kBuildThreads threads.
__device__ inline void block_exclusive_scan(unsigned* data, int n) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ unsigned warp_sum[kBuildThreads / 32];
  __shared__ unsigned carry;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) carry = 0u;
  __syncthreads();
  for (int base = 0; base < n; base += kBuildThreads) {
    const int i = base + threadIdx.x;
    const unsigned v = i < n ? data[i] : 0u;
    unsigned incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned up = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_up_sync(kAll, w, off);
        if (lane >= off) w += up;
      }
      warp_sum[lane] = w;   // inclusive over the warps
    }
    __syncthreads();
    const unsigned before = carry + (warp > 0 ? warp_sum[warp - 1] : 0u);
    if (i < n) data[i] = before + incl - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kBuildThreads / 32 - 1];
    __syncthreads();
  }
}

// The pieces of a range [lo, hi) of at most piece_rows rows: an empty range
// (hi <= lo) keeps one empty piece, which writes its tile's empty pixels.
__device__ __forceinline__ int range_pieces(int2 r, int piece_rows) {
  const int len = max(r.y - r.x, 0);
  return max(1, (len + piece_rows - 1) / piece_rows);
}

// visibility_v2.segment_work_list by the whole block: tile t's range
// range(t) = (lo, hi) cut into pieces of at most piece_rows rows, in (tile,
// piece) order; entries past the last piece (or past n_items) are
// (-1, 0, 0, 0).  `first` holds n_tiles words of scratch.  One thread per
// tile counts; one thread per entry finds its tile by binary search over
// the scanned counts and writes it.
template <class Range>
__device__ void build_segment_list(const Range& range, int n_tiles, int piece_rows, int n_items,
                                   int4* __restrict__ items, unsigned* __restrict__ first) {
  __shared__ int n_live;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  int live = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kBuildThreads) {
    const int p = range_pieces(range(t), piece_rows);
    first[t] = (unsigned)p;
    live += p;
  }
  atomicAdd(&n_live, live);
  block_exclusive_scan(first, n_tiles);   // its first barrier orders the adds
  const int n = min(n_live, n_items);
  for (int i = threadIdx.x; i < n; i += kBuildThreads) {
    int t = 0;   // the last tile whose first entry is at or before i
    for (int step = 1 << (31 - __clz(max(n_tiles, 1))); step > 0; step >>= 1) {
      if (t + step < n_tiles && first[t + step] <= (unsigned)i) t += step;
    }
    const int2 r = range(t);
    const int lo = r.x + (i - (int)first[t]) * piece_rows;
    items[i] = make_int4(t, lo, min(lo + piece_rows, r.x + max(r.y - r.x, 0)),
                         range_pieces(r, piece_rows));
  }
  for (int i = n + threadIdx.x; i < n_items; i += kBuildThreads) {
    items[i] = make_int4(-1, 0, 0, 0);
  }
}

}  // namespace work_list
