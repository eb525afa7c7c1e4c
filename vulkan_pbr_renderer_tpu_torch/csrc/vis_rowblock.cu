// Rowblock visibility rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel vulkan_pbr_renderer_tpu/raster/visibility.py
// _vis_kernel (launched by rasterize_vis_tiled, raster_kernel="rowblock").
// Input: the binned pair buffer of raster/binning.py in the "wide16" layout —
// rows of 16 f32 (9 edge coefficients, zx/zy/zc depth coefficients, the
// triangle id as f32, the pixel bbox rows y0/y1, z_mode) sorted by (tile,
// triangle id) — and a work list over each 32x128 tile's pair range (below).
// Output per pixel, tile-major [T, 32*128]: the depth of the first-processed
// nearest covering pair and its id; an empty pixel is (+inf, -1).  The tiles
// cover the band of rows [y_origin, ...) of the viewport (the row-sharded
// frame): a tile's first row is (float)(ty * 32) + (float)y_origin, one f32
// add as in the JAX kernel (visibility.py:66), and the row-block cull and the
// pixel rows start from it.
//
// The rules that make this K2 and not K1:
//  * capacity: tile t processes pair p iff
//      starts[t] <= p < min(starts[t+1], (starts[t]/chunk + capacity/chunk)*chunk)
//    — the TPU grid gives each tile capacity/chunk chunk-sized pair blocks
//    counted from the block holding starts[t]; deeper segments lose their
//    tail (the renderer's check_overflow reports it).  The work list is
//    built over these cut ranges;
//  * row-block cull: a pair is evaluated only on the 8-row blocks
//    rb0..rb1 of its bbox rows (cols 13-14), even if the bbox were not
//    conservative;
//  * depth test z < best, pairs in segment order: the first processed wins
//    ties, and depth starts at FAR = 3.4e38 (mapped to +inf on output).
//
// What bounds it on the card.  A pass reads each live pair row once (29.5 MB
// on the SunTemple camera pass, 48.3 MB on the 2048^2 sun pass) and writes
// 8 bytes per pixel: about 0.01-0.02 ms of HBM bandwidth.  The work is one
// evaluation per (pixel of a bbox row block, pair row) — 629 M on the camera
// pass — of three edge values and their sum, plus the depth on the covered
// ones, so the kernel is bound by f32 issue, and without FMA (-fmad=false,
// below) at most half of the card's f32 peak is reachable.  The segments are
// very uneven (904 rows per tile on average on the camera pass, 21,089 in
// the deepest), so one block per tile leaves the pass waiting on a few
// blocks, each alone on its SM.
//
// Design (K1's, csrc/vis_folded.cu, carried over).
//  * A work list splits deep tiles: each tile's capacity-cut range is cut
//    into pieces of at most kPieceRows rows.  One block builds it from
//    `starts` just before the raster kernel, in the same C call, the cut
//    computed there (csrc/work_list.cuh; the list of raster/visibility.py
//    rowblock_work_list).  A persistent grid, as many blocks as fit on the
//    card, takes entries from a device counter until it meets the first
//    surplus entry.
//  * A block runs one piece on one 8-row block of its tile (entry e of the
//    grid's counter is work item e / 4 on row block e % 4), so all its warps
//    walk the same rows: a piece's rows mostly touch one or two row blocks,
//    and warps bound to row blocks inside one block would wait for each
//    other at every stage.  Per 32 staged rows a warp tests the rows' bbox
//    row blocks once (a lane per row, __ballot_sync) and then walks only
//    the rows that touch its row block, in order.
//  * A tile of one piece writes its pixels directly.  The pieces of a deeper
//    tile merge on the u64 key (bits(z + 0.0) << 32) | pair index — the key
//    of vis_rowblock_plain, whose minimum is "nearest, then first processed"
//    — with atomicMin into a scratch that the wrapper fills with all ones; a
//    per-(tile, row block) arrival counter lets the last piece to arrive
//    decode the row block's keys (the id is the winning row's column 12).
//    The minimum does not depend on the order of the pieces, so the result
//    is deterministic.
//  * A lane owns one column of the row block, kPerLane pixel rows of it;
//    each warp stays inside the row block.  Per row and pixel every lane
//    computes its edge values and the coverage test; the depth numerator,
//    the range test and the divide run only when some lane of the warp is
//    covered (__any_sync), and only for the numerator that the row's uniform
//    z_mode selects.  a*px is computed once per row for a lane's column.  A
//    plane depth divides by exactly 1, which leaves it unchanged, so it is
//    not divided.
//  * Rows (64 bytes each) are staged 128 at a time into shared memory with
//    four 16-byte cp.async copies per row, double-buffered in pieces longer
//    than one stage: the next 128 rows load while this stage is evaluated.
//  * K2_PIECE_ROWS and K2_THREADS are compile-time constants; the defaults
//    were chosen by k2_sweep.py on an H100 (PERF.md).
//
// Exactness: every product, sum and the divide use the _rn intrinsics in the
// operation order of visibility.py:101-120 (and of the plain version,
// raster/visibility.py::vis_rowblock_plain), and the file is compiled with
// -fmad=false and without fast math, so no FMA contraction moves a bit.
// x / 8 is computed as x * 0.125, the same correctly rounded value.  A
// covered pixel has a denominator > 0 (esum > 0, or 1 for a plane), so the
// 1e-20 stand-in for a zero denominator never applies.  Depth is written as
// z + 0.0 (-0 becomes +0), as the key decodes it, so a tile's bits do not
// depend on how it was split.

#include <cuda_runtime.h>
#include <math.h>

#include "work_list.cuh"

#ifndef K2_PIECE_ROWS
#define K2_PIECE_ROWS 128
#endif
#ifndef K2_THREADS
#define K2_THREADS 128
#endif

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kBlockH = 8;
constexpr int kRowBlocks = kTileH / kBlockH;              // 4
constexpr int kPix = kTileH * kTileW;
constexpr int kThreads = K2_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kColGroups = kTileW / 32;                   // 32-column strips of a warp
constexpr int kRowGroups = kWarps / kColGroups;           // warps down the row block
constexpr int kPerLane = kBlockH / kRowGroups;            // pixel rows per lane
constexpr int kStage = 128;                               // pair rows per shared-memory stage
constexpr int kPieceRows = K2_PIECE_ROWS;
constexpr int kRowF = 16;                                 // floats per pair row
constexpr float kFar = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps % kColGroups == 0 && kPerLane * kRowGroups == kBlockH,
              "K2_THREADS: 128, 256 or 512");
static_assert(kPieceRows > 0, "K2_PIECE_ROWS must be positive");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows [lo, lo + n) of the pair buffer into a stage buffer, 16 bytes a copy
__device__ __forceinline__ void stage_rows(float4* dst, const float* __restrict__ pairs, int lo,
                                           int n) {
  const float4* src = reinterpret_cast<const float4*>(pairs + (size_t)lo * kRowF);
  for (int i = threadIdx.x; i < n * 4; i += kThreads) cp_async16(dst + i, src + i);
}

__device__ __forceinline__ float edge(float ax, float b, float c, float py) {
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, py)), c);
}

// The id of pair row p (column 12, an exact integer in f32).
__device__ __forceinline__ int pair_id(const float* __restrict__ pairs, int p) {
  return (int)__ldg(pairs + (size_t)p * kRowF + 12);
}

// One work-list entry (tile, lo, hi, pieces of the tile) on row block rb,
// by the whole block.
__device__ __forceinline__ void run_piece(int4 item, int rb, const float* __restrict__ pairs,
                                          int tiles_x, int y_origin,
                                          float* __restrict__ depth_out,
                                          int* __restrict__ id_out,
                                          unsigned long long* __restrict__ keys,
                                          unsigned long long* __restrict__ arrivals,
                                          float4 (*rows)[kStage * 4], bool* last_piece) {
  const int t = item.x;
  const int lo = item.y, hi = item.z, pieces = item.w;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = (warp % kColGroups) * 32 + lane;         // in the tile
  const int row0 = (warp / kColGroups) * kPerLane;         // in the row block, + k

  const float y0f = __fadd_rn((float)(ty * kTileH), (float)y_origin);
  const float rbf = (float)rb;
  const float ybase = __fadd_rn(y0f, (float)(rb * kBlockH));
  const float px = (float)(tx * kTileW + col) + 0.5f;
  float py[kPerLane];
  float best_z[kPerLane];
  int best_p[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    py[k] = __fadd_rn(0.5f + (float)(row0 + k), ybase);
    best_z[k] = kFar;
    best_p[k] = -1;
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

    const float4* buf = rows[s & 1];
    const int n = min(kStage, hi - base);
    for (int r0 = 0; r0 < n; r0 += 32) {
      // lane i tests row r0 + i against my row block; the plain version's
      // float compares, so a NaN bound culls nothing there or here
      bool mine = false;
      if (r0 + lane < n) {
        const float4 q3 = buf[(r0 + lane) * 4 + 3];
        const float f0 = floorf(__fmul_rn(__fsub_rn(q3.y, y0f), 0.125f));
        const float f1 = floorf(__fmul_rn(__fsub_rn(__fsub_rn(q3.z, 1.0f), y0f), 0.125f));
        const float rb0 = f0 < 0.0f ? 0.0f : f0;
        const float rb1 = f1 > (float)(kRowBlocks - 1) ? (float)(kRowBlocks - 1) : f1;
        mine = !(rbf < rb0 || rbf > rb1);
      }
      unsigned todo = __ballot_sync(kFull, mine);
      while (todo) {  // rows touching my row block, in segment order
        const int r = r0 + __ffs(todo) - 1;
        todo &= todo - 1;
        // q0 = a0 b0 c0 a1 | q1 = b1 c1 a2 b2 | q2 = c2 zx zy zc | q3.w = z_mode
        const float4 q0 = buf[r * 4], q1 = buf[r * 4 + 1], q2 = buf[r * 4 + 2];
        const bool vert = buf[r * 4 + 3].w > 0.5f;
        const int p = base + r;
        const float ax0 = __fmul_rn(q0.x, px), ax1 = __fmul_rn(q0.w, px),
                    ax2 = __fmul_rn(q1.z, px);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const float e0 = edge(ax0, q0.y, q0.z, py[k]);
          const float e1 = edge(ax1, q1.x, q1.y, py[k]);
          const float e2 = edge(ax2, q1.w, q2.x, py[k]);
          const float esum = __fadd_rn(__fadd_rn(e0, e1), e2);
          // explicit compares (not fminf): a NaN edge fails coverage, as in
          // the plain version
          const bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) && (esum > 0.0f);
          if (!__any_sync(kFull, cov) || !cov) continue;
          float z;
          if (vert) {  // vertex-interpolated depth: N / esum
            const float num = __fadd_rn(__fmul_rn(q2.y, esum),
                                        __fadd_rn(__fmul_rn(e1, q2.z), __fmul_rn(e2, q2.w)));
            if (!(num >= 0.0f && num <= esum)) continue;
            z = __fdiv_rn(num, esum);
          } else {     // screen-plane depth, over a denominator of 1
            z = edge(__fmul_rn(q2.y, px), q2.z, q2.w, py[k]);
            if (!(z >= 0.0f && z <= 1.0f)) continue;
          }
          if (z < best_z[k]) {
            best_z[k] = z;
            best_p[k] = p;
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before stage s + 2 refills it
  }

  const size_t blk_base = (size_t)t * kPix + (size_t)rb * kBlockH * kTileW;
  if (pieces == 1) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const size_t o = blk_base + (row0 + k) * kTileW + col;
      const bool empty = best_p[k] < 0;
      depth_out[o] = empty ? INFINITY : __fadd_rn(best_z[k], 0.0f);
      id_out[o] = empty ? -1 : pair_id(pairs, best_p[k]);
    }
    return;
  }

  // several pieces: merge on the (depth bits, pair index) key, the last to
  // arrive on this row block decodes it
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (best_p[k] >= 0) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(__fadd_rn(best_z[k], 0.0f)) << 32) |
          (unsigned)best_p[k];
      atomicMin(keys + blk_base + (row0 + k) * kTileW + col, key);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    // the counter starts at all ones: the i-th arrival (from 0) reads i - 1
    *last_piece = atomicAdd(arrivals + (size_t)t * kRowBlocks + rb, 1ull) + 1ull ==
                  (unsigned long long)(pieces - 1);
  }
  __syncthreads();
  if (!*last_piece) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const size_t o = blk_base + (row0 + k) * kTileW + col;
    const unsigned long long key = __ldcg(keys + o);
    const bool empty = key == ~0ull;
    depth_out[o] = empty ? INFINITY : __uint_as_float((unsigned)(key >> 32));
    id_out[o] = empty ? -1 : pair_id(pairs, (int)(unsigned)(key & 0xffffffffull));
  }
}

// K2's work list (visibility.rowblock_work_list): tile t's segment cut at
// its capacity, [starts[t], min(starts[t+1], (starts[t] / chunk +
// cap_chunks) * chunk)) (visibility.capacity_ranges).
struct CapacityRange {
  const int* starts;
  int chunk, cap_chunks;
  __device__ __forceinline__ int2 operator()(int t) const {
    const int lo = starts[t];
    const long long cap_end = ((long long)(lo / chunk) + cap_chunks) * chunk;
    return make_int2(lo, (int)min((long long)starts[t + 1], cap_end));
  }
};

__global__ void __launch_bounds__(work_list::kBuildThreads)
rowblock_work_list_kernel(const int* __restrict__ starts, int n_tiles, int chunk,
                          int cap_chunks, int n_items, int4* __restrict__ items,
                          unsigned* __restrict__ first) {
  work_list::build_segment_list(CapacityRange{starts, chunk, cap_chunks}, n_tiles, kPieceRows,
                                n_items, items, first);
}

// A persistent grid: each block takes the next entry from a device counter
// (which starts at all ones) — work item e / 4 on row block e % 4 — until
// the list, or its live part, is used up.
__global__ void __launch_bounds__(kThreads)
vis_rowblock_kernel(const int4* __restrict__ items, int n_items, const float* __restrict__ pairs,
                    int tiles_x, int y_origin, float* __restrict__ depth_out,
                    int* __restrict__ id_out,
                    unsigned long long* __restrict__ keys,
                    unsigned long long* __restrict__ arrivals,
                    unsigned long long* __restrict__ next_item) {
  __shared__ __align__(16) float4 rows[2][kStage * 4];
  __shared__ int4 item;
  __shared__ int item_rb;
  __shared__ bool last_piece;
  for (;;) {
    __syncthreads();  // the previous entry's shared state is consumed
    if (threadIdx.x == 0) {
      const unsigned long long e = atomicAdd(next_item, 1ull) + 1ull;
      const unsigned long long i = e / kRowBlocks;
      item = i < (unsigned long long)n_items ? items[i] : make_int4(-1, 0, 0, 0);
      item_rb = (int)(e % kRowBlocks);
    }
    __syncthreads();
    const int4 it = item;
    if (it.x < 0) return;  // past the last piece (entries after it are surplus)
    run_piece(it, item_rb, pairs, tiles_x, y_origin, depth_out, id_out, keys, arrivals, rows,
              &last_piece);
  }
}

}  // namespace

// Launch on `stream` the work-list kernel (one block: items[n_items] from
// starts[n_tiles + 1], each segment cut at tile_capacity = cap_chunks *
// chunk; n_items >= n_tiles + capacity / piece rows holds every piece) and
// then the raster kernel on as many blocks as fit on the card at once (at
// most 4 * n_items).  `pairs` must be 16-byte aligned, `scratch` holds
// n_tiles * 4096 keys, 4 * n_tiles arrival counters, the work counter, all
// filled with ones, and then (n_tiles + 1) / 2 words the list build uses.
// Returns the first CUDA error (0 = launched); the wrapper raises on
// anything else.
extern "C" int vis_rowblock_launch(const int* starts, int n_tiles, int chunk, int cap_chunks,
                                   int* items, int n_items, const float* pairs, int tiles_x,
                                   int y_origin, float* depth_out, int* id_out,
                                   unsigned long long* scratch, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vis_rowblock_kernel, kThreads,
                                                        0);
  }
  if (err != cudaSuccess) return (int)err;
  const int grid = min(n_items * kRowBlocks, sms * per_sm);
  if (grid > 0) {
    unsigned long long* arrivals = scratch + (size_t)n_tiles * kPix;
    unsigned long long* next_item = arrivals + (size_t)n_tiles * kRowBlocks;
    rowblock_work_list_kernel<<<1, work_list::kBuildThreads, 0, (cudaStream_t)stream>>>(
        starts, n_tiles, chunk, cap_chunks, n_items, reinterpret_cast<int4*>(items),
        reinterpret_cast<unsigned*>(next_item + 1));
    vis_rowblock_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const int4*>(items), n_items, pairs, tiles_x, y_origin, depth_out,
        id_out, scratch, arrivals, next_item);
  }
  return (int)cudaGetLastError();
}

// The piece length the kernel was built with (the work list must match it).
extern "C" int vis_rowblock_piece_rows() { return kPieceRows; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
