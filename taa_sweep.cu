// Sweep-only source (tile_sweep.py's "taa" group), never built by the
// package: TAA over 2D tiles with the neighbourhood, the history or the
// output staged in shared memory, each variant bit for bit with
// taa_resolve_plain.  The package keeps csrc/post.cu's thread-per-pixel
// taa_kernel: on the H100 none of these designs took less device time on
// path A's frame 1 or on a slow camera's (PERF.md), because the resolve is
// bound by its instructions at -fmad=false (~420 flops a pixel, each an
// instruction of its own, besides the loads, conversions and addressing),
// not by its 117 MB.
//
// The base design (no fork set).  A block resolves a TAA_TILE_W x
// TAA_TILE_H tile of output pixels, a thread each:
//  1. each pixel reads its 3x3 neighbourhood on the read-only path, rows
//     clamped as taa_kernel clamps them (so row windows and halo slabs read
//     what they read there), takes its source, moments and dilated
//     velocity, then the texels its history taps will read; the block
//     reduces them to the box its on-screen pixels' taps span;
//  2. the history under that box, at most the tile grown by Catmull-Rom's
//     reach (-1 .. +2 texels) and TAA_HIST_MARGIN texels each side, is
//     staged in shared memory in the form the taps consume, each texel
//     converted once by the very expression a tap uses (the f16 luma, Co
//     and Cg, or the f16 rgb, and the f16 previous velocity: an f16 holds
//     that rounded value exactly, so no bit changes);
//  3. a pixel whose every tap lies in the window reads them from shared
//     memory, any other from device memory with the same arithmetic; the
//     output is written in place.
// The forks:
//  - TAA_NB_STAGED: the tile's neighbourhood (lighting, depth, velocity and
//    a 1-pixel halo) staged in shared memory as 16-byte cp.async lines
//    before any pixel reads it, in place of each pixel's read-only loads;
//  - TAA_OUT_STAGED: the tile's output staged and written as 16-byte lines;
//  - TAA_WINDOW_FIXED: the history window fixed under the tile (the tile
//    grown by Catmull-Rom's reach and TAA_HIST_MARGIN each side), in place
//    of the box of the tile's reprojected taps;
//  - TAA_NO_STAGE: no history window, every tap from device memory.
//
// It compiles the package's post.cu into the same library, renaming that
// file's TAA launcher, so that its own takes its place behind
// shade/taa.py's wrapper.

#define taa_resolve_launch taa_resolve_launch_package
#include "vulkan_pbr_renderer_tpu_torch/csrc/post.cu"
#undef taa_resolve_launch

#include <limits.h>

// Defaults and sweep values (-D, tile_sweep.py's "taa" group).
#ifndef TAA_TILE_W
#define TAA_TILE_W 32
#endif
#ifndef TAA_TILE_H
#define TAA_TILE_H 4
#endif
#ifndef TAA_HIST_MARGIN
#define TAA_HIST_MARGIN 8
#endif
#ifndef TAA_MIN_BLOCKS
#define TAA_MIN_BLOCKS 8
#endif
#ifndef TAA_HIST_BATCH
#define TAA_HIST_BATCH 1
#endif

constexpr int kTaaW = TAA_TILE_W, kTaaH = TAA_TILE_H, kTaaThreads = kTaaW * kTaaH;
constexpr int kTaaWarps = kTaaThreads / 32;
static_assert(kTaaThreads % 32 == 0 && kTaaThreads <= 1024, "whole warps, one block");
// the history window's capacity
constexpr int kTaaMargin = TAA_HIST_MARGIN;
constexpr int kHistRows = kTaaH + 3 + 2 * kTaaMargin, kHistCols = kTaaW + 3 + 2 * kTaaMargin;
constexpr int kHistTexels = kHistRows * kHistCols;
constexpr int kHistPlanes = 5;   // mode 0: luma, Co, Cg; else r, g, b; then velocity_prev x, y
constexpr int kColSlots = (kHistCols + 31) / 32;   // window columns a lane stages
constexpr int kHistBatch = TAA_HIST_BATCH;         // window rows a warp stages at once

struct TaaSmem {
  __half hist[kHistPlanes][kHistTexels];
  int box[4];   // the on-screen pixels' taps: first and last row, first and last column
};

// The staged history window: texels [y0, y0 + rows) x [x0, x0 + cols)
struct HistWin {
  int y0, x0, rows, cols;
};

// The value a history tap consumes at texel t before its f16 rounding, by
// the expression each mode's tap used: plane 0-2 the luma, Co, Cg (mode 0)
// or r, g, b; planes 3-4 the previous velocity
__device__ __forceinline__ float hist_raw(const TaaArgs& a, int plane, size_t t) {
  if (plane >= 3) return __ldg(a.velocity_prev + t * 2 + (plane - 3));
  const float* p = a.history + t * 3;
  if (a.mode != 0) return __ldg(p + plane);
  const float h0 = __ldg(p), h1 = __ldg(p + 1), h2 = __ldg(p + 2);
  if (plane == 0) return (0.25f * h0 + 0.5f * h1) + 0.25f * h2;
  if (plane == 1) return 0.5f * h0 - 0.5f * h2;
  return (-0.25f * h0 + 0.5f * h1) - 0.25f * h2;
}

// hist_raw's five planes at texel t, for the staged window
__device__ __forceinline__ void hist_texel(const TaaArgs& a, size_t t, float* v) {
  const float* p = a.history + t * 3;
  const float h0 = __ldg(p), h1 = __ldg(p + 1), h2 = __ldg(p + 2);
  if (a.mode == 0) {
    v[0] = (0.25f * h0 + 0.5f * h1) + 0.25f * h2;
    v[1] = 0.5f * h0 - 0.5f * h2;
    v[2] = (-0.25f * h0 + 0.5f * h1) - 0.25f * h2;
  } else {
    v[0] = h0;
    v[1] = h1;
    v[2] = h2;
  }
  v[3] = __ldg(a.velocity_prev + t * 2);
  v[4] = __ldg(a.velocity_prev + t * 2 + 1);
}

// A pixel's history taps (f16-rounded) from the staged window: the four
// bilinear corners (indices into each plane) and the Catmull-Rom 4x4 from
// its first texel (rows ty .. ty + 3 and columns tx .. tx + 3 lie in the
// frame: catmull_axis clamps the origin to n - 4)
struct StagedTaps {
  const TaaSmem& sm;
  int corner_at[4], cr0;
  __device__ float corner(int plane, int q) const {
    return __half2float(sm.hist[plane][corner_at[q]]);
  }
  __device__ float cr(int plane, int i, int j) const {
    return __half2float(sm.hist[plane][cr0 + i * kHistCols + j]);
  }
};

// The same taps from device memory, by the expressions a tap used
struct GlobalTaps {
  const TaaArgs& a;
  size_t corner_at[4], cr0;
  __device__ float corner(int plane, int q) const {
    return f16r(hist_raw(a, plane, corner_at[q]));
  }
  __device__ float cr(int plane, int i, int j) const {
    return f16r(hist_raw(a, plane, cr0 + (size_t)i * a.w + j));
  }
};

// A pixel's neighbourhood on the read-only path: (dy, col) is the row
// offset and the clamped column
struct DirectNb {
  const TaaArgs& a;
  int r;
  __device__ size_t at(int dy, int col) const {
    return (size_t)clampi(r + a.in_shift + dy, 0, a.in_rows - 1) * a.w + col;
  }
  __device__ float lit(int dy, int col, int c) const {
    return __ldg(a.lighting + at(dy, col) * 3 + c);
  }
  __device__ float dep(int dy, int col) const { return __ldg(a.depth + at(dy, col)); }
  __device__ float vel(int dy, int col, int c) const {
    return __ldg(a.velocity + at(dy, col) * 2 + c);
  }
};

// A pixel's resolve up to its history: the Mitchell source, the clip box,
// the dilated velocity and the reprojected uv
struct TaaPixel {
  float src[3], minc[3], maxc[3], vel[2], ru, rv;
};

// The first half of the resolve of the in-bounds pixel (r, x) from its
// neighbourhood Nb; csrc/post.cu taa_kernel's arithmetic and order
template <class Nb>
__device__ void taa_source(const TaaArgs& a, const Nb& nb, int r, int x, TaaPixel& p) {
  const int w = a.w;
  // Mitchell 3x3 source and the moments
  float m1[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) p.src[c] = 0.0f;
  int k = 0;
  for (int dx = -1; dx <= 1; ++dx) {
    const int col = clampi(x + dx, 0, w - 1);
    for (int dy = -1; dy <= 1; ++dy, ++k) {
      for (int c = 0; c < 3; ++c) {
        const float v = nb.lit(dy, col, c);
        p.src[c] = p.src[c] + a.weights[k] * v;
        m1[c] = m1[c] + v;
        m2[c] = m2[c] + v * v;
      }
    }
  }
  for (int c = 0; c < 3; ++c) {
    p.src[c] = p.src[c] * a.inv_wsum;
    m1[c] = m1[c] * a.inv9;
    m2[c] = m2[c] * a.inv9;
    const float sigma = sqrtf(fabsf(m2[c] - m1[c] * m1[c]));
    p.minc[c] = m1[c] - a.gamma * sigma;
    p.maxc[c] = m1[c] + a.gamma * sigma;
  }

  // closest-depth velocity dilation: strict <, the centre first
  float best = nb.dep(0, x);
  p.vel[0] = nb.vel(0, x, 0);
  p.vel[1] = nb.vel(0, x, 1);
  for (int dx = -1; dx <= 1; ++dx) {
    const int col = clampi(x + dx, 0, w - 1);
    for (int dy = -1; dy <= 1; ++dy) {
      if (dx == 0 && dy == 0) continue;
      const float d = nb.dep(dy, col);
      if (d < best) {
        best = d;
        p.vel[0] = nb.vel(dy, col, 0);
        p.vel[1] = nb.vel(dy, col, 1);
      }
    }
  }

  const float u = ((float)x + 0.5f) * a.inv_w;
  const float v = ((float)(a.v_row0 + r) + 0.5f) * a.inv_fh;
  p.ru = u - p.vel[0] * 0.5f;
  p.rv = v - p.vel[1] * 0.5f;
}

__device__ __forceinline__ bool offscreen(const TaaPixel& p) {
  return p.ru < 0.0f || p.ru > 1.0f || p.rv < 0.0f || p.rv > 1.0f;
}

// The history's sample points: the bilinear corners (x0, x1) x (y0, y1)
// and weights, and in modes 0-1 the Catmull-Rom origin (tx, ty) and weights
struct TapPoints {
  int x0, x1, y0, y1, tx, ty;
  float fx, fy, wx[4], wy[4];
};

__device__ __forceinline__ void tap_points(const TaaArgs& a, const TaaPixel& p, TapPoints& t) {
  bilinear_axis(p.ru, a.w, &t.x0, &t.x1, &t.fx);
  bilinear_axis(p.rv, a.fh, &t.y0, &t.y1, &t.fy);
  t.tx = t.ty = 0;
  if (a.mode != 2) {
    catmull_axis(p.ru, a.w, &t.tx, t.wx);
    catmull_axis(p.rv, a.fh, &t.ty, t.wy);
  }
}

// The history texels the pixel's taps read: rows box[0] .. box[1], columns
// box[2] .. box[3] (the bilinear corners; in modes 0-1 the Catmull-Rom 4x4)
__device__ __forceinline__ void tap_box(const TaaArgs& a, const TapPoints& t, int* box) {
  box[0] = t.y0;
  box[1] = t.y1;
  box[2] = t.x0;
  box[3] = t.x1;
  if (a.mode != 2) {
    box[0] = min(box[0], t.ty);
    box[1] = max(box[1], t.ty + 3);
    box[2] = min(box[2], t.tx);
    box[3] = max(box[3], t.tx + 3);
  }
}

// The second half: the history taps (Taps: StagedTaps or GlobalTaps), the
// clip, the rejection and the blend
template <class Taps>
__device__ void taa_history(const TaaArgs& a, const Taps& taps, const TapPoints& t,
                            const TaaPixel& p, float* o) {
  float prev[3], pvel[2];
  if (a.mode == 2) {
    // bilinear f16 (history, prev velocity)
    for (int c = 0; c < 3; ++c)
      prev[c] = bilerp(taps.corner(c, 0), taps.corner(c, 1), taps.corner(c, 2),
                       taps.corner(c, 3), t.fx, t.fy);
  } else if (a.mode == 1) {
    // full-RGB 16-tap Catmull-Rom of the f16 history
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const float wt = t.wy[i] * t.wx[j];
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + taps.cr(c, i, j) * wt;
      }
    for (int c = 0; c < 3; ++c) prev[c] = acc[c] < 0.0f ? 0.0f : acc[c];
  } else {
    // YCoCg split: Catmull-Rom of the f16 luma, bilinear f16 Co/Cg
    float ys = 0.0f;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) ys = ys + taps.cr(0, i, j) * (t.wy[i] * t.wx[j]);
    if (ys < 0.0f) ys = 0.0f;
    const float cos_ = bilerp(taps.corner(1, 0), taps.corner(1, 1), taps.corner(1, 2),
                              taps.corner(1, 3), t.fx, t.fy);
    const float cgs = bilerp(taps.corner(2, 0), taps.corner(2, 1), taps.corner(2, 2),
                             taps.corner(2, 3), t.fx, t.fy);
    prev[0] = (ys + cos_) - cgs;
    prev[1] = ys + cgs;
    prev[2] = (ys - cos_) - cgs;
  }
  for (int c = 0; c < 2; ++c)
    pvel[c] = bilerp(taps.corner(3 + c, 0), taps.corner(3 + c, 1), taps.corner(3 + c, 2),
                     taps.corner(3 + c, 3), t.fx, t.fy);
  for (int c = 0; c < 3; ++c) prev[c] = minp(maxp(prev[c], p.minc[c]), p.maxc[c]);

  // velocity rejection; torch.linalg.vector_norm over the last dim of 2
  const float ddx = pvel[0] - p.vel[0], ddy = pvel[1] - p.vel[1];
  const float nrm = sqrtf(ddx * ddx + ddy * ddy);
  float wb = a.blend + a.velocity_rejection * nrm;
  float wa = a.one_minus_blend;
  if (offscreen(p)) {
    wb = 1.0f;
    wa = 0.0f;
  }
  const float den = maxp(wb + wa, 1e-5f);
  for (int c = 0; c < 3; ++c) o[c] = (p.src[c] * wb + prev[c] * wa) / den;
}

// The tile's window: the box of its on-screen pixels' taps (taps: this
// pixel's box; counted: on screen and in bounds), cut to the window's
// capacity from its first row and column.  sm.box starts empty; ends with
// a barrier.
__device__ HistWin taa_window(TaaSmem& sm, bool counted, const int* taps) {
  const int box[4] = {
      __reduce_min_sync(0xffffffffu, counted ? taps[0] : INT_MAX),
      __reduce_max_sync(0xffffffffu, counted ? taps[1] : INT_MIN),
      __reduce_min_sync(0xffffffffu, counted ? taps[2] : INT_MAX),
      __reduce_max_sync(0xffffffffu, counted ? taps[3] : INT_MIN)};
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sm.box[0], box[0]);
    atomicMax(&sm.box[1], box[1]);
    atomicMin(&sm.box[2], box[2]);
    atomicMax(&sm.box[3], box[3]);
  }
  __syncthreads();
  HistWin win = {0, 0, 0, 0};
  if (sm.box[0] <= sm.box[1]) {
    win.y0 = sm.box[0];
    win.x0 = sm.box[2];
    win.rows = min(sm.box[1] - sm.box[0] + 1, kHistRows);
    win.cols = min(sm.box[3] - sm.box[2] + 1, kHistCols);
  }
  return win;
}

// The window's texels into shared memory, each converted once: a warp a
// row, a lane a column, kHistBatch rows of a warp's at once with all their
// loads in flight
__device__ void stage_history(const TaaArgs& a, TaaSmem& sm, const HistWin& win) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int iy0 = warp; iy0 < win.rows; iy0 += kHistBatch * kTaaWarps) {
    float v[kHistBatch][kColSlots][kHistPlanes];
#pragma unroll
    for (int b = 0; b < kHistBatch; ++b) {
      const int iy = iy0 + b * kTaaWarps;
      const size_t g = (size_t)(win.y0 + iy) * a.w + win.x0;
#pragma unroll
      for (int q = 0; q < kColSlots; ++q)
        if (iy < win.rows && lane + 32 * q < win.cols) hist_texel(a, g + lane + 32 * q, v[b][q]);
    }
#pragma unroll
    for (int b = 0; b < kHistBatch; ++b) {
      const int iy = iy0 + b * kTaaWarps;
#pragma unroll
      for (int q = 0; q < kColSlots; ++q)
        if (iy < win.rows && lane + 32 * q < win.cols)
          for (int plane = 0; plane < kHistPlanes; ++plane)
            sm.hist[plane][iy * kHistCols + lane + 32 * q] = __float2half_rn(v[b][q][plane]);
    }
  }
}

// The pixel's history and blend: from the window where every tap lies in
// it, else from device memory (the sample points worked out again: fewer
// registers held over the barriers)
__device__ void taa_finish(const TaaArgs& a, const TaaSmem& sm, const HistWin& win,
                           const TaaPixel& p, float* o) {
  TapPoints tp;
  tap_points(a, p, tp);
  int b[4];
  tap_box(a, tp, b);
  if (b[0] >= win.y0 && b[1] < win.y0 + win.rows && b[2] >= win.x0 &&
      b[3] < win.x0 + win.cols) {
    const int r0 = (tp.y0 - win.y0) * kHistCols, r1 = (tp.y1 - win.y0) * kHistCols;
    const StagedTaps st = {sm, {r0 + tp.x0 - win.x0, r0 + tp.x1 - win.x0, r1 + tp.x0 - win.x0,
                                r1 + tp.x1 - win.x0},
                           (tp.ty - win.y0) * kHistCols + (tp.tx - win.x0)};
    taa_history(a, st, tp, p, o);
  } else {
    const size_t r0 = (size_t)tp.y0 * a.w, r1 = (size_t)tp.y1 * a.w;
    const GlobalTaps gt = {a, {r0 + tp.x0, r0 + tp.x1, r1 + tp.x0, r1 + tp.x1},
                           (size_t)tp.ty * a.w + tp.tx};
    taa_history(a, gt, tp, p, o);
  }
}

#ifndef TAA_NB_STAGED
#define TAA_NB_STAGED 0
#endif
#ifndef TAA_OUT_STAGED
#define TAA_OUT_STAGED 0
#endif
#ifndef TAA_WINDOW_FIXED
#define TAA_WINDOW_FIXED 0
#endif
#ifndef TAA_NO_STAGE
#define TAA_NO_STAGE 0
#endif

// a staged row of n floats that starts up to 3 floats into a 16-byte line
constexpr int line_pitch(int n) { return (n + 3 + 3) / 4 * 4; }
constexpr int kNbRows = kTaaH + 2, kNbCols = kTaaW + 2;   // the neighbourhood and its halo
constexpr int kLitPitch = line_pitch(3 * kNbCols), kDepPitch = line_pitch(kNbCols);
constexpr int kVelPitch = line_pitch(2 * kNbCols), kOutPitch = line_pitch(3 * kTaaW);

// the staged rows first: each starts on a 16-byte line
struct SweepSmem {
  float lit[TAA_NB_STAGED ? kNbRows * kLitPitch : 4];
  float dep[TAA_NB_STAGED ? kNbRows * kDepPitch : 4];
  float vel[TAA_NB_STAGED ? kNbRows * kVelPitch : 4];
  float out[TAA_OUT_STAGED ? kTaaH * kOutPitch : 4];
  TaaSmem t;
  int lit_off[kNbRows], dep_off[kNbRows], vel_off[kNbRows];   // each row's first float
};

// Where the float p lies within its 16-byte line (0-3 floats)
__device__ __forceinline__ int line_offset(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// Line q of the floats [g, g + n) of src into dst (the staged row, its
// first float at dst[line_offset(src + g)]): one 16-byte cp.async where
// the line lies inside the range, 4-byte ones at its ragged ends
__device__ __forceinline__ void stage_line_async(float* dst, const float* src, int n, int q) {
  const int off = line_offset(src);
  const int lo = 4 * q - off;
  if (lo >= n) return;
  if (lo >= 0 && lo + 4 <= n) {
    __pipeline_memcpy_async(dst + 4 * q, src + lo, 16);
  } else {
    for (int k = 0; k < 4; ++k)
      if (lo + k >= 0 && lo + k < n) __pipeline_memcpy_async(dst + 4 * q + k, src + lo + k, 4);
  }
}

// A pixel's neighbourhood from the staged rows: (dy, col) as DirectNb's;
// ty the pixel's row in the tile, cs the first staged column
struct StagedNb {
  const SweepSmem& sm;
  int ty, cs;
  __device__ float lit(int dy, int col, int c) const {
    const int i = ty + 1 + dy;
    return sm.lit[i * kLitPitch + sm.lit_off[i] + (col - cs) * 3 + c];
  }
  __device__ float dep(int dy, int col) const {
    const int i = ty + 1 + dy;
    return sm.dep[i * kDepPitch + sm.dep_off[i] + (col - cs)];
  }
  __device__ float vel(int dy, int col, int c) const {
    const int i = ty + 1 + dy;
    return sm.vel[i * kVelPitch + sm.vel_off[i] + (col - cs) * 2 + c];
  }
};

__global__ void __launch_bounds__(kTaaThreads, TAA_MIN_BLOCKS) taa_sweep_kernel(
    const __grid_constant__ TaaArgs a) {
  __shared__ __align__(16) SweepSmem sm;
  const int w = a.w, tid = threadIdx.x;
  const int x0 = blockIdx.x * kTaaW, r0 = blockIdx.y * kTaaH;
  const int cs = max(x0 - 1, 0), nc = min(x0 + kTaaW + 1, w) - cs;
  if (tid == 0) {
    sm.t.box[0] = sm.t.box[2] = INT_MAX;
    sm.t.box[1] = sm.t.box[3] = INT_MIN;
  }
#if TAA_NB_STAGED
  if (tid < kNbRows) {
    const size_t row = (size_t)clampi(r0 + a.in_shift - 1 + tid, 0, a.in_rows - 1) * w + cs;
    sm.lit_off[tid] = line_offset(a.lighting + row * 3);
    sm.dep_off[tid] = line_offset(a.depth + row);
    sm.vel_off[tid] = line_offset(a.velocity + row * 2);
  }
  constexpr int kLitLines = kLitPitch / 4, kDepLines = kDepPitch / 4, kVelLines = kVelPitch / 4;
  for (int it = tid; it < kNbRows * (kLitLines + kDepLines + kVelLines); it += kTaaThreads) {
    int q = it;
    const int part = q < kNbRows * kLitLines ? 0
                     : q < kNbRows * (kLitLines + kDepLines) ? 1 : 2;
    if (part == 1) q -= kNbRows * kLitLines;
    if (part == 2) q -= kNbRows * (kLitLines + kDepLines);
    const int lines = part == 0 ? kLitLines : part == 1 ? kDepLines : kVelLines;
    const int i = q / lines, line = q - i * lines;
    const size_t row = (size_t)clampi(r0 + a.in_shift - 1 + i, 0, a.in_rows - 1) * w + cs;
    if (part == 0)
      stage_line_async(sm.lit + i * kLitPitch, a.lighting + row * 3, 3 * nc, line);
    else if (part == 1)
      stage_line_async(sm.dep + i * kDepPitch, a.depth + row, nc, line);
    else
      stage_line_async(sm.vel + i * kVelPitch, a.velocity + row * 2, 2 * nc, line);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
#endif
  __syncthreads();

  const int tx = tid % kTaaW, ty = tid / kTaaW;
  const int r = r0 + ty, x = x0 + tx;
  const bool live = r < a.rows && x < w;
  TaaPixel p;
  int taps[4] = {0, -1, 0, -1};
  if (live) {
#if TAA_NB_STAGED
    taa_source(a, StagedNb{sm, ty, cs}, r, x, p);
#else
    taa_source(a, DirectNb{a, r}, r, x, p);
#endif
    TapPoints tp;
    tap_points(a, p, tp);
    tap_box(a, tp, taps);
  }
  HistWin win = {0, 0, 0, 0};
#if TAA_WINDOW_FIXED
  const int gy0 = a.v_row0 + r0;
  win.y0 = max(gy0 - 1 - kTaaMargin, 0);
  win.x0 = max(x0 - 1 - kTaaMargin, 0);
  win.rows = min(gy0 + kTaaH + 2 + kTaaMargin, a.fh) - win.y0;
  win.cols = min(x0 + kTaaW + 2 + kTaaMargin, w) - win.x0;
#elif !TAA_NO_STAGE
  win = taa_window(sm.t, live && !offscreen(p), taps);
#endif
#if !TAA_NO_STAGE
  stage_history(a, sm.t, win);
  __syncthreads();
#endif

  if (live) {
    float o[3];
    taa_finish(a, sm.t, win, p, o);
#if TAA_OUT_STAGED
    float* so = sm.out + ty * kOutPitch + line_offset(a.out + ((size_t)r * w + x0) * 3) + tx * 3;
#else
    float* so = a.out + ((size_t)r * w + x) * 3;
#endif
    for (int c = 0; c < 3; ++c) so[c] = o[c];
  }
#if TAA_OUT_STAGED
  __syncthreads();
  const int n_out = min(kTaaW, w - x0);
  constexpr int kOutLines = kOutPitch / 4;
  for (int it = tid; it < kTaaH * kOutLines; it += kTaaThreads) {
    const int i = it / kOutLines, q = it - i * kOutLines;
    if (r0 + i >= a.rows) continue;
    float* dst = a.out + ((size_t)(r0 + i) * w + x0) * 3;
    const int n = 3 * n_out, lo = 4 * q - line_offset(dst);
    if (lo >= n) continue;
    const float* s = sm.out + i * kOutPitch + 4 * q;
    if (lo >= 0 && lo + 4 <= n) {
      *reinterpret_cast<float4*>(dst + lo) = *reinterpret_cast<const float4*>(s);
    } else {
      for (int k = 0; k < 4; ++k)
        if (lo + k >= 0 && lo + k < n) dst[lo + k] = s[k];
    }
  }
#endif
}

extern "C" int taa_resolve_launch(const TaaArgs* args, void* stream) {
  const TaaArgs& a = *args;
  if (a.rows > 0 && a.w > 0) {
    const dim3 grid((a.w + kTaaW - 1) / kTaaW, (a.rows + kTaaH - 1) / kTaaH);
    taa_sweep_kernel<<<grid, kTaaThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int taa_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                             int* blocks_per_sm, int* tile_w, int* tile_h, int* margin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, taa_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *tile_w = kTaaW;
  *tile_h = kTaaH;
  *margin = kTaaMargin;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, taa_sweep_kernel,
                                                            kTaaThreads, 0);
}
