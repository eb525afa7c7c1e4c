// Rowblock visibility rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel vulkan_pbr_renderer_tpu/raster/visibility.py
// _vis_kernel (launched by rasterize_vis_tiled, raster_kernel="rowblock").
// Input: the binned pair buffer of raster/binning.py in the "wide16" layout —
// rows of 16 f32 (9 edge coefficients, zx/zy/zc depth coefficients, the
// triangle id as f32, the pixel bbox rows y0/y1, z_mode) sorted by (tile,
// triangle id) — and starts[T+1], the segment [starts[t], starts[t+1]) of
// each 32x128 tile.  Output per pixel, tile-major [T, 32*128]: the depth of
// the first-processed nearest covering pair and its id; an empty pixel is
// (+inf, -1).
//
// The rules that make this K2 and not K1:
//  * capacity: tile t processes pair p iff
//      starts[t] <= p < min(starts[t+1], (starts[t]/chunk + capacity/chunk)*chunk)
//    — the TPU grid gives each tile capacity/chunk chunk-sized pair blocks
//    counted from the block holding starts[t]; deeper segments lose their
//    tail (the renderer's check_overflow reports it);
//  * row-block cull: a pair is evaluated only on the 8-row blocks
//    rb0..rb1 of its bbox rows (cols 13-14), even if the bbox were not
//    conservative;
//  * depth test z < best, pairs in segment order: the first processed wins
//    ties, and depth starts at FAR = 3.4e38 (mapped to +inf on output).
//
// Design (simple and exact first): one block per tile, 512 threads.  Thread
// (x, b) with x = tid % 128 and b = tid / 128 owns column x of row block b,
// 8 pixels, keeping their best (z, id) in registers; a warp's 32 threads
// share one row block, so the row-block cull skips whole warps.  The tile's
// pair rows are staged through shared memory 128 at a time and every thread
// reads the same row (a shared-memory broadcast).
//
// Exactness: every product, sum and the divide use the _rn intrinsics in the
// operation order of visibility.py:103-120 (and of the plain version,
// raster/visibility.py::vis_rowblock_plain), and the file is compiled with
// -fmad=false and without fast math, so no FMA contraction moves a bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kBlockH = 8;
constexpr int kRowBlocks = kTileH / kBlockH;   // 4
constexpr int kThreads = kTileW * kRowBlocks;  // 512
constexpr int kStage = 128;                    // pair rows per shared-memory stage
constexpr int kCols = 16;
constexpr float kFar = 3.4e38f;

__device__ __forceinline__ float edge(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
vis_rowblock_kernel(const int* __restrict__ starts, const float* __restrict__ pairs,
                    int tiles_x, int chunk, int n_chunks,
                    float* __restrict__ depth_out, int* __restrict__ id_out) {
  __shared__ float rows[kStage * kCols];

  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int x = threadIdx.x % kTileW;
  const int rb = threadIdx.x / kTileW;       // my row block
  const int start = starts[t];
  const int end = min(starts[t + 1], (start / chunk + n_chunks) * chunk);

  const float y0f = (float)(ty * kTileH);
  const float px = __fadd_rn((float)(tx * kTileW) + 0.5f, (float)x);
  const float ybase = __fadd_rn(y0f, (float)(rb * kBlockH));
  float best_z[kBlockH];
  float best_id[kBlockH];
#pragma unroll
  for (int k = 0; k < kBlockH; ++k) {
    best_z[k] = kFar;
    best_id[k] = -1.0f;
  }

  for (int base = start; base < end; base += kStage) {
    const int n = min(kStage, end - base);
    __syncthreads();  // the previous stage is fully consumed
    const float* src = pairs + (size_t)base * kCols;
    for (int i = threadIdx.x; i < n * kCols; i += kThreads) rows[i] = src[i];
    __syncthreads();

    for (int r = 0; r < n; ++r) {
      const float* d = rows + r * kCols;
      const int rb0 = max((int)floorf(__fdiv_rn(__fsub_rn(d[13], y0f), (float)kBlockH)), 0);
      const int rb1 = min((int)floorf(__fdiv_rn(__fsub_rn(__fsub_rn(d[14], 1.0f), y0f),
                                                (float)kBlockH)),
                          kRowBlocks - 1);
      if (rb < rb0 || rb > rb1) continue;   // uniform across the warp
      const float zx = d[9], zy = d[10], zc = d[11], idf = d[12];
      const bool vert = d[15] > 0.5f;
#pragma unroll
      for (int k = 0; k < kBlockH; ++k) {
        const float py = __fadd_rn(0.5f + (float)k, ybase);
        const float e0 = edge(d[0], d[1], d[2], px, py);
        const float e1 = edge(d[3], d[4], d[5], px, py);
        const float e2 = edge(d[6], d[7], d[8], px, py);
        const float esum = __fadd_rn(__fadd_rn(e0, e1), e2);
        const float n_hp = __fadd_rn(__fmul_rn(zx, esum),
                                     __fadd_rn(__fmul_rn(e1, zy), __fmul_rn(e2, zc)));
        const float z_pl = edge(zx, zy, zc, px, py);
        const float n_sel = vert ? n_hp : z_pl;
        const float d_sel = vert ? esum : 1.0f;
        const bool cov = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
                         (esum > 0.0f) && (n_sel >= 0.0f) && (n_sel <= d_sel);
        if (cov) {
          const float z = __fdiv_rn(n_sel, d_sel == 0.0f ? 1e-20f : d_sel);
          if (z < best_z[k]) {
            best_z[k] = z;
            best_id[k] = idf;
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kBlockH; ++k) {
    const size_t o = (size_t)t * (kTileH * kTileW) + (rb * kBlockH + k) * kTileW + x;
    depth_out[o] = best_z[k] >= kFar ? INFINITY : best_z[k];
    id_out[o] = (int)best_id[k];
  }
}

}  // namespace

// Launch on `stream` with one block per tile.  Returns cudaGetLastError()
// after the launch (0 = launched); the wrapper raises on anything else.
extern "C" int vis_rowblock_launch(const int* starts, const float* pairs, int n_tiles,
                                   int tiles_x, int chunk, int n_chunks,
                                   float* depth_out, int* id_out, void* stream) {
  if (n_tiles > 0) {
    vis_rowblock_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        starts, pairs, tiles_x, chunk, n_chunks, depth_out, id_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
