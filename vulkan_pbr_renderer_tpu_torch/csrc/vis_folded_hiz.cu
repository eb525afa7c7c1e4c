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
// (+inf, -1).
//
// The walk is the TPU kernel's: global 128-row blocks from start/128, rows
// outside [start, end) masked.  After each block the tile's farthest pixel
// depth zmax (+inf while a pixel is empty) is reduced over the block, and the
// walk stops when chunk_minz[min(blk + 1, nb - 1)] > zmax: nothing after it
// can be nearer than any pixel's depth.  Stopping at the same block as the
// TPU kernel keeps the result bit-equal to it.
//
// Tie rule.  The TPU kernel keeps 128 slot accumulators (slot = row % 128):
// in a slot the first processed row wins an exact depth tie (strict <);
// across slots the smallest id among the slots at the nearest depth wins.  On
// z-sorted segments that differs from "smallest id": a tie between two rows
// of one slot keeps the earlier row.  Each pixel keeps (best_z, best_id) and
// a 128-bit mask of the slots that already hold a row at best_z:
//   z <  best_z               -> best = (z, id), mask = {slot}
//   z == best_z, slot not set -> set the slot, best_id = min(best_id, id)
//   z == best_z, slot set     -> nothing (the slot's earlier row stays)
// which is the TPU kernel's resolve over the slots, computed as it streams.
//
// What bounds it on the card: as K1 (csrc/vis_folded.cu), the ALU work of
// every evaluated (pixel, pair) — about 30 flops — and the deepest tile, which
// one block walks alone; the early exit can cut exactly that tile short.
// Each block adds one block-wide max reduction (two barriers) per 128 rows.
//
// Design (simple and exact first): one 256-thread block per tile, each thread
// owning 4 pixels (column x, rows y, y+8, y+16, y+24); the block stages one
// 128-row block through shared memory and every thread reads the same row (a
// broadcast).  The slot of a row is the same for every thread, so the mask
// word is selected without divergence.
//
// Exactness: every product, sum and the divide use the _rn intrinsics and the
// file is compiled with -fmad=false, in the operation order of
// raster/xla_raster.py::depth_at.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPerThread = kPix / kThreads;   // 4 pixels per thread
constexpr int kRowStep = kThreads / kTile;    // 8 rows between a thread's pixels
constexpr int kChunk = 128;                   // rows per block = slots
constexpr int kWords = kChunk / 32;           // slot mask words
constexpr int kCols = 13;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float edge(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
vis_folded_hiz_kernel(const int* __restrict__ starts, const float* __restrict__ pairs,
                      const float* __restrict__ chunk_minz, int tiles_x, int nb_total,
                      float* __restrict__ depth_out, int* __restrict__ id_out) {
  __shared__ float rows[kChunk * kCols];
  __shared__ float warp_max[kWarps];

  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int lane = threadIdx.x;
  const int start = starts[t];
  const int end = starts[t + 1];

  const float px = (float)(tx * kTile + lane % kTile) + 0.5f;
  float py[kPerThread];
  float best_z[kPerThread];
  int best_id[kPerThread];
  unsigned mask[kPerThread][kWords];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    py[k] = (float)(ty * kTile + lane / kTile + k * kRowStep) + 0.5f;
    best_z[k] = INFINITY;
    best_id[k] = -1;
#pragma unroll
    for (int w = 0; w < kWords; ++w) mask[k][w] = 0u;
  }

  const int blk0 = start / kChunk;
  const int blk_end = end > start ? (end - 1) / kChunk + 1 : blk0;
  for (int blk = blk0; blk < blk_end; ++blk) {
    const int base = blk * kChunk;
    const int lo = max(start, base);
    const int hi = min(end, base + kChunk);
    __syncthreads();  // the previous stage and reduction are consumed
    const float* src = pairs + (size_t)lo * kCols;
    float* dst = rows + (lo - base) * kCols;
    for (int i = lane; i < (hi - lo) * kCols; i += kThreads) dst[i] = src[i];
    __syncthreads();

    for (int r = lo; r < hi; ++r) {
      const int slot = r - base;
      const int word = slot >> 5;
      const unsigned bit = 1u << (slot & 31);
      const float* d = rows + slot * kCols;
      const float zx = d[9], zy = d[10], zc = d[11], enc = d[12];
      const bool vert = enc > 0.0f;
      const int id = (int)fabsf(enc) - 1;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float e0 = edge(d[0], d[1], d[2], px, py[k]);
        const float e1 = edge(d[3], d[4], d[5], px, py[k]);
        const float e2 = edge(d[6], d[7], d[8], px, py[k]);
        const float esum = __fadd_rn(__fadd_rn(e0, e1), e2);
        const float n_hp = __fadd_rn(__fmul_rn(zx, esum),
                                     __fadd_rn(__fmul_rn(e1, zy), __fmul_rn(e2, zc)));
        const float z_pl = edge(zx, zy, zc, px, py[k]);
        const float n_sel = vert ? n_hp : z_pl;
        const float d_sel = vert ? esum : 1.0f;
        // explicit compares (not fminf): a NaN edge fails coverage, as the
        // NaN-propagating minimum of the plain version does
        const bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
                         (esum > 0.0f) && (n_sel >= 0.0f) && (n_sel <= d_sel);
        if (cov) {
          const float z = __fdiv_rn(n_sel, d_sel == 0.0f ? 1e-20f : d_sel);
          if (z < best_z[k]) {
            best_z[k] = z;
            best_id[k] = id;
#pragma unroll
            for (int w = 0; w < kWords; ++w) mask[k][w] = (w == word) ? bit : 0u;
          } else if (z == best_z[k]) {
#pragma unroll
            for (int w = 0; w < kWords; ++w) {
              if (w == word && !(mask[k][w] & bit)) {
                mask[k][w] |= bit;
                best_id[k] = min(best_id[k], id);
              }
            }
          }
        }
      }
    }

    // early exit: the tile's farthest pixel depth against the next block's bound
    float m = best_z[0];
#pragma unroll
    for (int k = 1; k < kPerThread; ++k) m = fmaxf(m, best_z[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((lane & 31) == 0) warp_max[lane >> 5] = m;
    __syncthreads();
    float zmax = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) zmax = fmaxf(zmax, warp_max[w]);
    if (chunk_minz[min(blk + 1, nb_total - 1)] > zmax) break;  // uniform in the block
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t o = (size_t)t * kPix + lane + k * kThreads;
    depth_out[o] = best_z[k];
    id_out[o] = best_id[k];
  }
}

}  // namespace

// Launch on `stream` with one block per tile.  Returns cudaGetLastError()
// after the launch (0 = launched); the wrapper raises on anything else.
extern "C" int vis_folded_hiz_launch(const int* starts, const float* pairs,
                                     const float* chunk_minz, int n_tiles, int tiles_x,
                                     int nb_total, float* depth_out, int* id_out,
                                     void* stream) {
  if (n_tiles > 0) {
    vis_folded_hiz_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        starts, pairs, chunk_minz, tiles_x, nb_total, depth_out, id_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
