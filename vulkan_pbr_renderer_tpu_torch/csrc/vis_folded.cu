// Folded-tile visibility rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel vulkan_pbr_renderer_tpu/raster/visibility_v2.py
// _vis_kernel_folded (launched by rasterize_vis_folded, hiz=False).  Input:
// the binned pair buffer of raster/binning.py — rows of 13 f32 (9 edge
// coefficients, zx/zy/zc depth coefficients, ±(id+1) whose sign selects
// vertex-interpolated or plane depth), sorted by (tile, triangle id), and
// starts[T+1], the segment [starts[t], starts[t+1]) of each 32x32 tile.
// Output per pixel: the nearest covered depth and the smallest triangle id
// among equal depths; an empty pixel is (+inf, -1).  The tiles cover the band
// of rows [y_origin, y_origin + 32 * tiles_y) of the viewport (the row-sharded
// frame): a pixel's row is ty * 32 + its row in the tile + y_origin, an integer
// sum converted to f32, as in the JAX kernel (visibility_v2.py:76).
//
// What bounds it on the card.  A pass reads each live pair row once (26.7 MB
// on the SunTemple camera pass, 42.9 MB on the 2048^2 sun pass; the buffer's
// capacity is larger, its dead tail is never read) and writes 8 bytes per
// pixel: about 0.01-0.02 ms of HBM bandwidth.  The work is one evaluation per
// (pixel, pair row of its tile) — 526 M on the camera pass — of three edge
// values and their sum (14 flops), plus the depth on the few covered ones, so
// the kernel is bound by f32 issue, and without FMA (-fmad=false, below) at
// most half of the card's f32 peak is reachable.  The segments are very
// uneven: 252 rows per tile on average on the camera pass, 6,988 in the
// deepest tile, so one block per tile leaves the pass waiting on a few
// blocks, each alone on its SM.
//
// Design.
//  * A work list splits deep tiles: each tile's segment is cut into pieces
//    of at most kPieceRows rows.  Its length is the static bound n_tiles +
//    capacity/kPieceRows; surplus entries carry tile -1.  One block builds it
//    from `starts` just before the raster kernel, in the same C call
//    (csrc/work_list.cuh; the list of raster/visibility_v2.py
//    folded_work_list, whose twenty-odd PyTorch launches cost more host time
//    than this kernel takes on the card).  A persistent grid, as many blocks
//    as fit on the card, takes entries from a device counter until it meets
//    the first surplus entry.
//  * A tile of one piece writes its pixels directly.  The pieces of a deeper
//    tile merge on the u64 key (bits(z + 0.0) << 32) | id — the key of
//    raster/xla_raster.py::depth_id_key — with atomicMin into a scratch that
//    the wrapper fills with all ones; a per-tile arrival counter after the
//    keys lets the last piece to arrive decode the keys to (depth, id).  The
//    minimum key does not depend on the order of the pieces, so the result
//    is deterministic and equals a strict z < best over the id-sorted
//    segment.
//  * Each warp owns an 8-pixel-wide column strip of the tile, each lane
//    kPerThread pixels of one column, 4 rows apart.  Per pair row every lane
//    computes its edge values and the coverage test; the depth numerator,
//    the range test and the divide run only when some lane of the warp is
//    covered (__any_sync),
//    and only for the numerator that the row's uniform vert flag selects.
//    a*px, shared by a lane's pixels, is computed once per row.  A plane
//    depth divides by exactly 1, which leaves it unchanged, so it is not
//    divided.
//  * Rows are staged 128 at a time into shared memory padded to 16 floats
//    (four 16-byte broadcast loads per row), double-buffered with cp.async:
//    the next 128 rows load while this stage is evaluated.
//  * K1_PIECE_ROWS and K1_THREADS (128 and 128) were chosen by k1_sweep.py
//    on an H100 (PERF.md); shorter pieces won at every block size.
//
// Exactness: every product, sum and the divide use the _rn intrinsics and the
// file is compiled with -fmad=false, in the operation order of
// raster/xla_raster.py::depth_at, so no FMA contraction can move a boundary
// bit.  A covered pixel has a denominator > 0 (esum > 0, or 1 for a plane),
// so the plain version's 1e-20 stand-in for a zero denominator never applies.

#include <cuda_runtime.h>
#include <math.h>

#include "work_list.cuh"

#ifndef K1_PIECE_ROWS
#define K1_PIECE_ROWS 128
#endif
#ifndef K1_THREADS
#define K1_THREADS 128
#endif

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = K1_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = kTile / 8;                     // 8-pixel-wide column strips
constexpr int kStripRows = kTile / (kWarps / kStrips); // rows of a warp's strip
constexpr int kPerThread = kStripRows / 4;             // pixels per thread
constexpr int kStage = 128;                            // pair rows per shared-memory stage
constexpr int kPieceRows = K1_PIECE_ROWS;
constexpr int kCols = 13;
constexpr int kPad = 16;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps % kStrips == 0 && kStripRows % 4 == 0, "K1_THREADS: 128, 256 or 512");
static_assert(kPieceRows % kStage == 0, "K1_PIECE_ROWS must be a multiple of 128");

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

// One work-list entry (tile, lo, hi, pieces of the tile), by the whole block.
__device__ __forceinline__ void run_piece(int4 item, const float* __restrict__ pairs,
                                          int tiles_x, int y_origin,
                                          float* __restrict__ depth_out,
                                          int* __restrict__ id_out,
                                          unsigned long long* __restrict__ keys,
                                          unsigned long long* __restrict__ arrivals,
                                          float (*rows)[kStage * kPad], bool* last_piece) {
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
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    py[k] = (float)(ty * kTile + row0 + 4 * k + y_origin) + 0.5f;
    best_z[k] = INFINITY;
    best_id[k] = -1;
  }

  const int n_stages = (hi - lo + kStage - 1) / kStage;
  if (n_stages > 0) stage_rows(rows[0], pairs, lo, min(kStage, hi - lo));
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    const int base = lo + s * kStage;
    if (s + 1 < n_stages) {
      stage_rows(rows[(s + 1) & 1], pairs, base + kStage, min(kStage, hi - base - kStage));
    }
    cp_async_commit();
    cp_async_wait_one();  // stage s has landed (this thread's copies)
    __syncthreads();      // ... and every thread's

    const float4* buf = reinterpret_cast<const float4*>(rows[s & 1]);
    const int n = min(kStage, hi - base);
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
            const float z = __fdiv_rn(num, esum[k]);
            if (z < best_z[k]) {
              best_z[k] = z;
              best_id[k] = id;
            }
          }
        }
      } else {           // screen-plane depth
        const float zxp = __fmul_rn(zx, px);
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          if (!(cov & (1u << k))) continue;
          const float z = __fadd_rn(__fadd_rn(zxp, __fmul_rn(zy, py[k])), zc);
          if (z >= 0.0f && z <= 1.0f && z < best_z[k]) {
            best_z[k] = z;
            best_id[k] = id;
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before stage s + 2 refills it
  }

  const size_t tile_base = (size_t)t * kPix;
  if (pieces == 1) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const size_t o = tile_base + (row0 + 4 * k) * kTile + col;
      depth_out[o] = best_z[k];
      id_out[o] = best_id[k];
    }
    return;
  }

  // several pieces: merge on the (depth bits, id) key, the last to arrive decodes
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (best_id[k] >= 0) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(__fadd_rn(best_z[k], 0.0f)) << 32) |
          (unsigned)best_id[k];
      atomicMin(keys + tile_base + (row0 + 4 * k) * kTile + col, key);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    // the counter starts at all ones: the i-th arrival (from 0) reads i - 1
    *last_piece = atomicAdd(arrivals + t, 1ull) + 1ull == (unsigned long long)(pieces - 1);
  }
  __syncthreads();
  if (!*last_piece) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t o = tile_base + (row0 + 4 * k) * kTile + col;
    const unsigned long long key = __ldcg(keys + o);
    const bool empty = key == ~0ull;
    depth_out[o] = empty ? INFINITY : __uint_as_float((unsigned)(key >> 32));
    id_out[o] = empty ? -1 : (int)(unsigned)(key & 0xffffffffull);
  }
}

// K1's work list (visibility_v2.folded_work_list): tile t's whole segment
// [starts[t], starts[t+1]).
struct SegmentRange {
  const int* starts;
  __device__ __forceinline__ int2 operator()(int t) const {
    return make_int2(starts[t], starts[t + 1]);
  }
};

__global__ void __launch_bounds__(work_list::kBuildThreads)
folded_work_list_kernel(const int* __restrict__ starts, int n_tiles, int n_items,
                        int4* __restrict__ items, unsigned* __restrict__ first) {
  work_list::build_segment_list(SegmentRange{starts}, n_tiles, kPieceRows, n_items, items,
                                first);
}

// A persistent grid: each block takes the next entry from a device counter
// (which starts at all ones) until the list, or its live part, is used up.
__global__ void __launch_bounds__(kThreads)
vis_folded_kernel(const int4* __restrict__ items, int n_items, const float* __restrict__ pairs,
                  int tiles_x, int y_origin, float* __restrict__ depth_out,
                  int* __restrict__ id_out,
                  unsigned long long* __restrict__ keys,
                  unsigned long long* __restrict__ arrivals,
                  unsigned long long* __restrict__ next_item) {
  __shared__ __align__(16) float rows[2][kStage * kPad];
  __shared__ int4 item;
  __shared__ bool last_piece;
  for (;;) {
    __syncthreads();  // the previous entry's shared state is consumed
    if (threadIdx.x == 0) {
      const unsigned long long i = atomicAdd(next_item, 1ull) + 1ull;
      item = i < (unsigned long long)n_items ? items[i] : make_int4(-1, 0, 0, 0);
    }
    __syncthreads();
    const int4 it = item;
    if (it.x < 0) return;  // past the last piece (entries after it are surplus)
    run_piece(it, pairs, tiles_x, y_origin, depth_out, id_out, keys, arrivals, rows,
              &last_piece);
  }
}

}  // namespace

// Launch on `stream` the work-list kernel (one block: items[n_items] from
// starts[n_tiles + 1]; n_items >= n_tiles + capacity / piece rows holds every
// piece) and then the raster kernel on as many blocks as fit on the card at
// once (at most n_items).  `scratch` holds n_tiles * 1024 keys, n_tiles
// arrival counters, the work counter, all filled with ones, and then
// (n_tiles + 1) / 2 words the list build uses.  Returns the first CUDA error
// (0 = launched); the wrapper raises on anything else.
extern "C" int vis_folded_launch(const int* starts, int n_tiles, int* items, int n_items,
                                 const float* pairs, int tiles_x, int y_origin, float* depth_out,
                                 int* id_out, unsigned long long* scratch, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vis_folded_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int grid = min(n_items, sms * per_sm);
  if (grid > 0) {
    unsigned long long* arrivals = scratch + (size_t)n_tiles * kPix;
    unsigned long long* next_item = arrivals + n_tiles;
    folded_work_list_kernel<<<1, work_list::kBuildThreads, 0, (cudaStream_t)stream>>>(
        starts, n_tiles, n_items, reinterpret_cast<int4*>(items),
        reinterpret_cast<unsigned*>(next_item + 1));
    vis_folded_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const int4*>(items), n_items, pairs, tiles_x, y_origin, depth_out,
        id_out, scratch, arrivals, next_item);
  }
  return (int)cudaGetLastError();
}

// The piece length the kernel was built with (the work list must match it).
extern "C" int vis_folded_piece_rows() { return kPieceRows; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
