// Folded-tile visibility rasterizer, hierarchical-z variant, for Hopper (sm_90a).
//
// Replaces the `hiz=True` body of the TPU kernel
// vulkan_pbr_renderer_tpu/raster/visibility_v2.py _vis_kernel_folded
// (lines 128-185, selected by RenderConfig.raster_hiz).  Input: the binned
// pair buffer of raster/binning.py with z_order=True — rows of 13 f32 (9 edge
// coefficients, zx/zy/zc depth coefficients, ±(id+1) whose sign selects
// vertex-interpolated or plane depth) sorted by (tile, quantized minimum
// vertex depth, id) — starts[T+1], and chunk_minz[nb], a lower bound of the
// depth of every 128-row block of the buffer.  Output per pixel: the nearest
// covered depth and its id under the TPU kernel's tie rule; an empty pixel is
// (+inf, -1).  As in K1, the tiles cover the band of rows [y_origin, ...) of
// the viewport: a pixel's row is ty * 32 + its row in the tile + y_origin, an
// integer sum converted to f32, in the walk and in the tie re-resolve alike.
//
// The function.  The TPU kernel walks a tile's segment in global 128-row
// blocks, keeps 128 slot accumulators per pixel (slot = row % 128, a strict
// z < best per slot) and stops at the first block b with chunk_minz[b] above
// the farthest pixel depth so far.  Its result is a function of the segment
// alone: the nearest depth zf over the rows; per slot the FIRST row at exactly
// zf; the smallest id among those rows.  The rows it never reaches are
// strictly farther than every final depth, so they neither win nor tie.
//
// What bounds it on the card: as K1 (csrc/vis_folded.cu), the f32 instruction
// rate, at one evaluation per (pixel, walked pair row) and without FMA; the
// segments are very uneven (252 rows per tile on average on the SunTemple
// camera pass, 6,988 in the deepest), so one block per tile waits for the
// deepest tile.
//
// Design.
//  * A work list cuts every segment at the multiples of kPieceRows of the
//    GLOBAL row index, so a piece is a run of whole 128-row blocks clipped to
//    the segment and every block keeps its own chunk_minz bound and its rows
//    their slots.  A one-block kernel builds it from `starts` just before the
//    raster kernel (the list of raster/visibility_v2.py aligned_work_list,
//    which needs some twenty PyTorch launches: more host time than the raster
//    kernel takes on the card).  A persistent grid takes entries from a device
//    counter.  The list is ordered by piece index: every tile is walked front
//    to back across the grid, its far pieces start after its near ones have
//    merged.
//  * Inside one 128-row block every row has its own slot, so the tie rule is
//    plain: the nearer row wins, equal depths keep the smaller id.  No slot
//    mask is kept.  With kPieceRows > 128 a tie between two blocks of one
//    piece marks the pixel (below).
//  * A tile of one piece writes its pixels directly.  The pieces of a deeper
//    tile merge on the u64 key (bits(z + 0.0) << 32) | id with one atomicMin
//    per covered pixel: the smallest id among all rows at the nearest depth.
//    That differs from the tie rule only where rows of different pieces tie at
//    the final depth.  Whichever of two such pieces merges second reads the
//    other's depth bits in the old key (nothing nearer ever arrives) and marks
//    the pixel in a per-tile bit mask.  The last piece of a tile to arrive (a
//    per-tile counter) decodes the keys and re-resolves only the marked pixels
//    by the strict rule over the tile's whole segment: a warp per pixel, each
//    lane walking 4 slots' rows in order up to the first row at the final
//    depth.  The result does not depend on the order of arrival; a stale mark
//    costs time only.
//  * The early exit, without a serial walk.  Merged depths only fall.  After
//    its merge a piece reduces the largest merged depth over the tile's pixels
//    (the atomicMin's old value, or a load where the piece covers nothing;
//    +inf while a pixel is empty) and lowers the tile's bound to it.  A piece
//    about to start skips each of its blocks b with chunk_minz[b] above that
//    bound: the bound is at or above every final depth of the tile, so the
//    block's rows are strictly farther.  How many rows are walked depends on
//    timing; the result does not.  A device counter reports the rows walked.
//  * The walk is K1's: each warp owns an 8-pixel-wide column strip, each lane
//    kPerThread pixels of one column, 4 rows apart; the depth numerator, range
//    test and divide run only where some lane of the warp is covered
//    (__any_sync), a*px is shared by a lane's pixels, a plane depth is not
//    divided (its denominator is exactly 1), and the rows are staged 128 at a
//    time into shared memory padded to 16 floats, double-buffered with
//    cp.async.
//  * KHIZ_PIECE_ROWS and KHIZ_THREADS (128 and 256) were chosen by
//    khiz_sweep.py on an H100 (PERF.md): one block per piece skips most, and
//    256 threads (4 pixels each, 61 registers) beat 128 (8 pixels, 89).  The
//    piece-major order costs the SunTemple camera pass, where the exit can
//    save 7% of the rows, about 0.03 ms against the tile-major order and saves
//    the sun pass, where it can save 41%, about 0.2 ms.
//
// Exactness: every product, sum and the divide use the _rn intrinsics and the
// file is compiled with -fmad=false, in the operation order of
// raster/xla_raster.py::depth_at.  A covered pixel has a denominator > 0
// (esum > 0, or 1 for a plane), so the plain version's 1e-20 stand-in for a
// zero denominator never applies.

#include <cuda_runtime.h>
#include <math.h>

#include "work_list.cuh"

#ifndef KHIZ_PIECE_ROWS
#define KHIZ_PIECE_ROWS 128
#endif
#ifndef KHIZ_THREADS
#define KHIZ_THREADS 256
#endif

namespace {

typedef unsigned long long u64;

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = KHIZ_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = kTile / 8;                     // 8-pixel-wide column strips
constexpr int kStripRows = kTile / (kWarps / kStrips); // rows of a warp's strip
constexpr int kPerThread = kStripRows / 4;             // pixels per thread
constexpr int kChunk = 128;                            // rows per global block = slots
constexpr int kPieceRows = KHIZ_PIECE_ROWS;
constexpr int kStages = kPieceRows / kChunk;           // global blocks per piece
constexpr int kCols = 13;
constexpr int kPad = 16;
constexpr int kMarkWords = kPix / 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmptyBits = 0xffffffffu;           // depth bits of an empty key
static_assert(kWarps % kStrips == 0 && kStripRows % 4 == 0, "KHIZ_THREADS: 128, 256 or 512");
static_assert(kPieceRows % kChunk == 0 && kStages >= 1 && kStages <= 32,
              "KHIZ_PIECE_ROWS must be a multiple of 128, at most 4096");

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows [lo, lo + n) of the pair buffer into a padded stage buffer
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ pairs, int lo,
                                           int n) {
  const float* src = pairs + (size_t)lo * kCols;
  for (int i = threadIdx.x; i < n * kCols; i += kThreads) {
    const int r = i / kCols;
    cp_async4(dst + r * kPad + (i - r * kCols), src + i);
  }
}

// The scratch of one launch, carved from one u64 buffer filled with ones.
struct Scratch {
  u64* keys;       // [n_tiles * 1024] merge keys
  u64* arrivals;   // [n_tiles] pieces arrived, minus one
  u64* bound;      // [n_tiles] bits of an upper bound of the tile's final depths
  u64* marks;      // [n_tiles * 16] one bit per pixel; a CLEARED bit is a mark
  u64* next_item;  // work counter, minus one
  u64* rows_walked;    // rows of the blocks that were not skipped, minus one
  u64* marked_pixels;  // pixels re-resolved, minus one
};

// Depth of pair row `row` at one pixel centre, +inf where not covered: the
// plain version's depth_at, one row on one pixel.
__device__ __forceinline__ float depth_at(const float* __restrict__ row, float px, float py,
                                          int* id) {
  const float e0 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(row + 0), px),
                                       __fmul_rn(__ldg(row + 1), py)), __ldg(row + 2));
  const float e1 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(row + 3), px),
                                       __fmul_rn(__ldg(row + 4), py)), __ldg(row + 5));
  const float e2 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(row + 6), px),
                                       __fmul_rn(__ldg(row + 7), py)), __ldg(row + 8));
  const float esum = __fadd_rn(__fadd_rn(e0, e1), e2);
  if (!((e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) && (esum > 0.0f))) return INFINITY;
  const float zx = __ldg(row + 9), zy = __ldg(row + 10), zc = __ldg(row + 11);
  const float enc = __ldg(row + 12);
  *id = (int)fabsf(enc) - 1;
  if (enc > 0.0f) {
    const float num = __fadd_rn(__fmul_rn(zx, esum),
                                __fadd_rn(__fmul_rn(e1, zy), __fmul_rn(e2, zc)));
    return (num >= 0.0f && num <= esum) ? __fdiv_rn(num, esum) : INFINITY;
  }
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(zx, px), __fmul_rn(zy, py)), zc);
  return (z >= 0.0f && z <= 1.0f) ? z : INFINITY;
}

// The strict tie rule for one pixel whose final depth zf is known, by one
// warp: lane l walks the rows of slots l, l + 32, l + 64, l + 96 of the
// segment [start, end) in order up to the first row at exactly zf; the
// smallest id over the slots wins.
__device__ __forceinline__ int first_tied_id(const float* __restrict__ pairs, int start, int end,
                                             float zf, float px, float py) {
  const int lane = threadIdx.x % 32;
  int best = 0x7fffffff;
  for (int j = 0; j < kChunk / 32; ++j) {
    const int slot = lane + 32 * j;
    int r = start + ((slot - start % kChunk + kChunk) % kChunk);
    for (; r < end; r += kChunk) {
      int id = -1;
      const float z = depth_at(pairs + (size_t)r * kCols, px, py, &id);
      if (z == zf) {
        best = min(best, id);
        break;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(kFull, best, off));
  return best;
}

// One covered evaluation against a pixel's best: the nearer row wins, equal
// depths keep the smaller id (inside one 128-row block every row has its own
// slot); a tie with a row of another block of the piece sets the pixel's bit
// in `tied`, a nearer row clears it.
__device__ __forceinline__ void keep(float z, int id, int stage, int k, float& best_z,
                                     int& best_id, int& best_stage, unsigned& tied) {
  if (z < best_z) {
    best_z = z;
    best_id = id;
    if (kStages > 1) {
      best_stage = stage;
      tied &= ~(1u << k);
    }
  } else if (z == best_z) {
    best_id = min(best_id, id);
    if (kStages > 1 && best_stage != stage) tied |= 1u << k;
  }
}

// ---------------------------------------------------------------------------
// The work list, built by one block (its scan is csrc/work_list.cuh's).

using work_list::block_exclusive_scan;
using work_list::kBuildThreads;

__device__ __forceinline__ int tile_pieces(int lo, int hi) {
  return hi > lo ? (hi - 1) / kPieceRows - lo / kPieceRows + 1 : 1;
}

// items[n_items] = (tile, lo, hi, pieces) for every piece of every tile, then
// (-1, 0, 0, 0).  piece_major: grouped by the piece's index in its tile (the
// order inside a group is whatever the atomics give; no result depends on
// it), else by tile.  `work` holds 3 * n_items words.  One thread per tile
// counts, one thread per piece places it: a deep tile's pieces do not queue on
// one thread's atomics.
__global__ void __launch_bounds__(kBuildThreads)
hiz_work_list_kernel(const int* __restrict__ starts, int n_tiles, int n_items, int piece_major,
                     int4* __restrict__ items, unsigned* __restrict__ work) {
  unsigned* first = work;                 // per tile: its first entry in tile-major order
  unsigned* offset = work + n_items;      // per piece index: the group's first entry
  unsigned* cursor = work + 2 * n_items;  // per piece index: entries placed so far
  __shared__ int n_levels, n_live;
  if (threadIdx.x == 0) n_levels = 0, n_live = 0;
  for (int i = threadIdx.x; i < 3 * n_items; i += kBuildThreads) work[i] = 0u;
  __syncthreads();
  int live = 0, deepest = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kBuildThreads) {
    const int p = tile_pieces(starts[t], starts[t + 1]);
    first[t] = (unsigned)p;
    live += p;
    deepest = max(deepest, p);
    if (piece_major) {
      for (int j = 0; j < p; ++j) atomicAdd(offset + j, 1u);
    }
  }
  atomicAdd(&n_live, live);
  atomicMax(&n_levels, deepest);
  __syncthreads();
  block_exclusive_scan(first, n_tiles);
  if (piece_major) block_exclusive_scan(offset, n_levels);
  const int n = min(n_live, n_items);
  for (int i = threadIdx.x; i < n; i += kBuildThreads) {
    int t = 0;   // the last tile whose first entry is at or before i
    for (int step = 1 << (31 - __clz(max(n_tiles, 1))); step > 0; step >>= 1) {
      if (t + step < n_tiles && first[t + step] <= (unsigned)i) t += step;
    }
    const int j = i - (int)first[t];
    const int lo = starts[t], hi = max(starts[t + 1], lo);
    const int blk0 = lo / kPieceRows;
    const unsigned at = piece_major ? offset[j] + atomicAdd(cursor + j, 1u) : (unsigned)i;
    if (at < (unsigned)n_items) {
      items[at] = make_int4(t, max(lo, (blk0 + j) * kPieceRows),
                            min(hi, (blk0 + j + 1) * kPieceRows), tile_pieces(lo, hi));
    }
  }
  for (int i = n + threadIdx.x; i < n_items; i += kBuildThreads) {
    items[i] = make_int4(-1, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// The raster kernel.

struct Shared {
  float rows[2][kChunk * kPad];
  u64 marks[kMarkWords];
  unsigned warp_max[kWarps];
  int4 item;
  unsigned run_mask;   // bit s: walk global block lo / 128 + s of the piece
  int last_piece;
};

// One work-list entry (tile, lo, hi, pieces of the tile), by the whole block.
__device__ __forceinline__ void run_piece(Shared& sh, const int* __restrict__ starts,
                                          const float* __restrict__ pairs, int tiles_x,
                                          int y_origin, float* __restrict__ depth_out,
                                          int* __restrict__ id_out, const Scratch& sc) {
  const int4 item = sh.item;
  const int t = item.x;
  const int lo = item.y, hi = item.z, pieces = item.w;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = (warp % kStrips) * 8 + lane % 8;                     // in the tile
  const int row0 = (warp / kStrips) * kStripRows + lane / 8;           // + 4k

  const float px = (float)(tx * kTile + col) + 0.5f;
  float py[kPerThread];
  float best_z[kPerThread];
  int best_id[kPerThread];
  int best_stage[kPerThread];   // the block that set best_z (kStages > 1 only)
  unsigned tied = 0u;           // bit k: pixel k tied across two blocks of this piece
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    py[k] = (float)(ty * kTile + row0 + 4 * k + y_origin) + 0.5f;
    best_z[k] = INFINITY;
    best_id[k] = -1;
    best_stage[k] = -1;
  }

  const int blk0 = lo / kChunk;
  unsigned todo = sh.run_mask;
  int s = todo ? __ffs(todo) - 1 : -1;
  if (s >= 0) {
    const int r0 = max(lo, (blk0 + s) * kChunk);
    stage_rows(sh.rows[0], pairs, r0, min(hi, (blk0 + s + 1) * kChunk) - r0);
  }
  cp_async_commit();
  for (int buf_i = 0; s >= 0; buf_i ^= 1) {
    todo &= todo - 1;
    const int s_next = todo ? __ffs(todo) - 1 : -1;
    if (s_next >= 0) {
      const int r0 = max(lo, (blk0 + s_next) * kChunk);
      stage_rows(sh.rows[buf_i ^ 1], pairs, r0, min(hi, (blk0 + s_next + 1) * kChunk) - r0);
    }
    cp_async_commit();
    cp_async_wait_one();  // stage s has landed (this thread's copies)
    __syncthreads();      // ... and every thread's

    const float4* buf = reinterpret_cast<const float4*>(sh.rows[buf_i]);
    const int n = min(hi, (blk0 + s + 1) * kChunk) - max(lo, (blk0 + s) * kChunk);
    for (int r = 0; r < n; ++r) {
      // q0 = a0 b0 c0 a1 | q1 = b1 c1 a2 b2 | q2 = c2 zx zy zc | q3.x = enc
      const float4 q0 = buf[r * 4], q1 = buf[r * 4 + 1], q2 = buf[r * 4 + 2];
      const float ax0 = __fmul_rn(q0.x, px), ax1 = __fmul_rn(q0.w, px),
                  ax2 = __fmul_rn(q1.z, px);
      float e1[kPerThread], e2[kPerThread], esum[kPerThread];
      unsigned cov = 0u;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float e0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(q0.y, py[k])), q0.z);
        e1[k] = __fadd_rn(__fadd_rn(ax1, __fmul_rn(q1.x, py[k])), q1.y);
        e2[k] = __fadd_rn(__fadd_rn(ax2, __fmul_rn(q1.w, py[k])), q2.x);
        esum[k] = __fadd_rn(__fadd_rn(e0, e1[k]), e2[k]);
        // explicit compares (not fminf): a NaN edge fails coverage, as the
        // NaN-propagating minimum of the plain version does
        if ((e0 >= 0.0f) && (e1[k] >= 0.0f) && (e2[k] >= 0.0f) && (esum[k] > 0.0f)) {
          cov |= 1u << k;
        }
      }
      if (!__any_sync(kFull, cov != 0u)) continue;

      const float enc = buf[r * 4 + 3].x;
      const int id = (int)fabsf(enc) - 1;
      const float zx = q2.y, zy = q2.z, zc = q2.w;
      if (enc > 0.0f) {  // vertex-interpolated depth: N / esum (uniform branch)
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (!(cov & (1u << k))) continue;
          const float num = __fadd_rn(__fmul_rn(zx, esum[k]),
                                      __fadd_rn(__fmul_rn(e1[k], zy), __fmul_rn(e2[k], zc)));
          if (num >= 0.0f && num <= esum[k]) {
            keep(__fdiv_rn(num, esum[k]), id, s, k, best_z[k], best_id[k], best_stage[k], tied);
          }
        }
      } else {           // screen-plane depth
        const float zxp = __fmul_rn(zx, px);
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (!(cov & (1u << k))) continue;
          const float z = __fadd_rn(__fadd_rn(zxp, __fmul_rn(zy, py[k])), zc);
          if (z >= 0.0f && z <= 1.0f) {
            keep(z, id, s, k, best_z[k], best_id[k], best_stage[k], tied);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before the stage after next refills it
    s = s_next;
  }

  const size_t tile_base = (size_t)t * kPix;
  const bool direct = pieces == 1 && (kStages == 1 || !__syncthreads_or(tied != 0u));
  if (direct) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const size_t o = tile_base + (row0 + 4 * k) * kTile + col;
      depth_out[o] = best_z[k];
      id_out[o] = best_id[k];
    }
    return;
  }

  // merge on the (depth bits, id) key; a merge that meets its own depth marks
  // the pixel; the largest merged depth bounds the tile's final depths
  u64* tile_marks = sc.marks + (size_t)t * kMarkWords;
  const bool walked = sh.run_mask != 0u;   // a piece skipped whole only arrives
  unsigned far_bits = walked ? 0u : kEmptyBits;
#pragma unroll
  for (int k = 0; walked && k < kPerThread; ++k) {
    const int pix = (row0 + 4 * k) * kTile + col;
    unsigned merged_bits;
    bool mark = (tied >> k) & 1u;
    if (best_id[k] >= 0) {
      const unsigned zbits = __float_as_uint(__fadd_rn(best_z[k], 0.0f));
      const u64 old = atomicMin(sc.keys + tile_base + pix,
                                ((u64)zbits << 32) | (unsigned)best_id[k]);
      const unsigned old_bits = (unsigned)(old >> 32);
      mark = mark || old_bits == zbits;   // an empty key's bits equal no depth's
      merged_bits = min(old_bits, zbits);
    } else {
      merged_bits = (unsigned)(__ldcg(sc.keys + tile_base + pix) >> 32);
    }
    if (mark) atomicAnd(tile_marks + (pix >> 6), ~(1ull << (pix & 63)));
    far_bits = max(far_bits, merged_bits);
  }
  far_bits = __reduce_max_sync(kFull, far_bits);
  if (lane == 0) sh.warp_max[warp] = far_bits;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = sh.warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, sh.warp_max[w]);
    if (m != kEmptyBits) atomicMin(sc.bound + t, (u64)m);
    // the counter starts at all ones: the i-th arrival (from 0) reads i - 1
    sh.last_piece = atomicAdd(sc.arrivals + t, 1ull) + 1ull == (u64)(pieces - 1);
  }
  __syncthreads();
  if (!sh.last_piece) return;
  __threadfence();
  if (threadIdx.x < kMarkWords) sh.marks[threadIdx.x] = ~__ldcg(tile_marks + threadIdx.x);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t o = tile_base + (row0 + 4 * k) * kTile + col;
    const u64 key = __ldcg(sc.keys + o);
    const bool empty = key == ~0ull;
    depth_out[o] = empty ? INFINITY : __uint_as_float((unsigned)(key >> 32));
    id_out[o] = empty ? -1 : (int)(unsigned)(key & 0xffffffffull);
  }
  __syncthreads();

  // the marked pixels, warp by warp, by the strict rule over the whole segment
  const int start = starts[t], end = starts[t + 1];
  int n_marked = 0;
  for (int w = 0; w < kMarkWords; ++w) {
    for (u64 bits = sh.marks[w]; bits; bits &= bits - 1) {
      if (n_marked++ % kWarps != warp) continue;
      const int pix = w * 64 + __ffsll((long long)bits) - 1;
      const float zf = __uint_as_float((unsigned)(__ldcg(sc.keys + tile_base + pix) >> 32));
      const int id = first_tied_id(pairs, start, end, zf,
                                   (float)(tx * kTile + pix % kTile) + 0.5f,
                                   (float)(ty * kTile + pix / kTile + y_origin) + 0.5f);
      if (lane == 0) id_out[tile_base + pix] = id;
    }
  }
  if (threadIdx.x == 0 && n_marked > 0) atomicAdd(sc.marked_pixels, (u64)n_marked);
}

// A persistent grid: each block takes the next entry from a device counter
// (which starts at all ones) until the list, or its live part, is used up.
// Thread 0 also decides, once per piece, which of its blocks to walk.
__global__ void __launch_bounds__(kThreads)
vis_folded_hiz_kernel(const int4* __restrict__ items, int n_items, const int* __restrict__ starts,
                      const float* __restrict__ pairs, const float* __restrict__ chunk_minz,
                      int tiles_x, int y_origin, float* __restrict__ depth_out,
                      int* __restrict__ id_out,
                      Scratch sc) {
  __shared__ __align__(16) Shared sh;
  for (;;) {
    __syncthreads();  // the previous entry's shared state is consumed
    if (threadIdx.x == 0) {
      const u64 i = atomicAdd(sc.next_item, 1ull) + 1ull;
      const int4 it = i < (u64)n_items ? items[i] : make_int4(-1, 0, 0, 0);
      unsigned run = 0u;
      if (it.x >= 0 && it.z > it.y) {
        // a tile of one piece has nothing merged to compare against
        const u64 b = it.w > 1 ? __ldcg(sc.bound + it.x) : ~0ull;
        const float zmax = b == ~0ull ? INFINITY : __uint_as_float((unsigned)b);
        const int blk0 = it.y / kChunk;
        const int n_blocks = (it.z - 1) / kChunk - blk0 + 1;
        int walked = 0;
        for (int s = 0; s < n_blocks; ++s) {
          if (chunk_minz[blk0 + s] > zmax) continue;   // strictly farther than every pixel
          run |= 1u << s;
          walked += min(it.z, (blk0 + s + 1) * kChunk) - max(it.y, (blk0 + s) * kChunk);
        }
        if (walked > 0) atomicAdd(sc.rows_walked, (u64)walked);
      }
      sh.item = it;
      sh.run_mask = run;
    }
    __syncthreads();
    if (sh.item.x < 0) return;  // past the last piece (entries after it are surplus)
    run_piece(sh, starts, pairs, tiles_x, y_origin, depth_out, id_out, sc);
  }
}

}  // namespace

// Launch on `stream` the work-list kernel (one block; it fills items[n_items]
// using work[3 * n_items]; n_items >= n_tiles + ceil(capacity / piece rows)
// holds every piece) and then the raster kernel on as many blocks as fit on
// the card at once (at most n_items, and at most max_blocks if that is > 0:
// one block walks the list serially, every tile front to back).  `scratch`
// holds n_tiles * (1024 + 2 + 16) + 3 words filled with ones: the keys, the
// per-tile arrival counters and depth bounds, the mark bits, and the work,
// rows-walked and marked-pixel counters (each reads one less than its count).
// Returns the first CUDA error (0 = launched); the wrapper raises on anything
// else.
extern "C" int vis_folded_hiz_launch(const int* starts, const float* pairs,
                                     const float* chunk_minz, int tiles_x, int y_origin,
                                     int n_tiles,
                                     int* items, int n_items, unsigned* work, int piece_major,
                                     float* depth_out, int* id_out,
                                     unsigned long long* scratch, int max_blocks,
                                     void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vis_folded_hiz_kernel, kThreads,
                                                        0);
  }
  if (err != cudaSuccess) return (int)err;
  int grid = min(n_items, sms * per_sm);
  if (max_blocks > 0) grid = min(grid, max_blocks);
  if (grid > 0) {
    hiz_work_list_kernel<<<1, kBuildThreads, 0, (cudaStream_t)stream>>>(
        starts, n_tiles, n_items, piece_major, reinterpret_cast<int4*>(items), work);
    Scratch sc;
    sc.keys = scratch;
    sc.arrivals = sc.keys + (size_t)n_tiles * kPix;
    sc.bound = sc.arrivals + n_tiles;
    sc.marks = sc.bound + n_tiles;
    sc.next_item = sc.marks + (size_t)n_tiles * kMarkWords;
    sc.rows_walked = sc.next_item + 1;
    sc.marked_pixels = sc.next_item + 2;
    vis_folded_hiz_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const int4*>(items), n_items, starts, pairs, chunk_minz, tiles_x,
        y_origin, depth_out, id_out, sc);
  }
  return (int)cudaGetLastError();
}

// The piece length the kernel was built with (the work list must match it).
extern "C" int vis_folded_hiz_piece_rows() { return kPieceRows; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
