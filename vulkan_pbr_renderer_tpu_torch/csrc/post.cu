// The post stack for Hopper (sm_90a): TAA resolve, one bloom downsample
// level, the whole downsample chain in one launch, one bloom upsample level
// (the last one fused with the tonemap), the whole upsample chain and the
// tonemap in one launch.
//
// Replaces the JAX package's post stack, which XLA runs outside any Pallas
// kernel (vulkan_pbr_renderer_tpu/app/renderer.py:229 post_stack):
//  - taa_kernel: vulkan_pbr_renderer_tpu/shade/taa.py:32 taa_resolve;
//  - bloom_down_kernel: shade/bloom.py:65 downsample_13tap at one level
//    (the firefly clamp at level 1), plus its bf16 band of the next frame's
//    pyramid atlas (gpu/sampling.py pack_mip_atlas(...).astype(bfloat16));
//  - bloom_down_chain_kernel: every level of the same, one launch a frame
//    (its note below);
//  - bloom_up_kernel: shade/bloom.py:101 upsample_tent9 at one level; on
//    the last level also hdr + tent, the exposure, utils/color.py:14
//    aces_approx and :21 gamma_encode (with bloom off, the tonemap alone);
//  - bloom_up_chain_kernel: every up level of the same and the tonemap, one
//    launch a frame (its note below).
// Each computes its plain PyTorch version in the port (shade/taa.py
// taa_resolve_plain, shade/bloom.py bloom_down_level_plain /
// bloom_up_level_plain); TAA and the per-level kernels with a thread per
// output texel.
//
// Why three kernels.  PyTorch runs the plain post stack as ~1,750 small
// eager operations a 1920x1088 frame (every edge-clamped shift of the bloom
// taps is two aranges, two clamps and two index_selects; TAA's history
// windows are packed into 16-channel f16 copies of the frame and gathered).
// A kernel computes each output texel from the inputs directly: the 3x3
// neighbourhood, the history texels of its Catmull-Rom or bilinear window
// (rounded to f16 as the plain version's window packs store them), the 13
// taps of a downsample, the 9 taps of a tent with the 2x bilinear taken on
// the fly.  Nothing is packed, nothing intermediate goes to device memory.
//
// What bounds it on the card: bytes.  TAA reads 44 bytes a pixel and writes
// 12 (~117 MB at 1920x1088: ~35 us at 3.35 TB/s) for ~420 flops a pixel
// (~13 us at the f32 peak); the bloom levels are smaller still.  The texels
// a thread reads again (neighbours, window texels, boxes) come from L1/L2.
// TAA and the per-level bloom kernels keep a plain thread-per-texel shape;
// the two chains tile their levels in shared memory.
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// version's operation order: the 3x3 offsets dx-outer, dy-inner with f32
// Mitchell weights; the dilation's strict < in that order; the Catmull-Rom
// weights' and the bilinear lerp's order; the f16 rounding of each history
// texel before any weight touches it; the box2 means summed as
// (a + b) + (c + d) then x0.25 (shade/bloom.py _box2 writes that order
// out); _up2 rows first, then columns; aces then powf.  PyTorch on the card
// divides a tensor by a Python number as a product with the number's f32
// reciprocal: the uv's / w and / full_height are products here too.  The
// linear resize of a level whose sizes are not 2:1 (resize_linear, einsum
// in the plain version) sums its weight bands in index order, which the
// einsum need not: those levels agree within a tolerance, not in bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade_common.cuh"

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.maximum / minimum / clamp: NaN propagates
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a) ? a : (a > b ? a : b);
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a) ? a : (a < b ? a : b);
}

__device__ __forceinline__ float f16r(float v) { return __half2float(__float2half_rn(v)); }

// ---------------------------------------------------------------------------
// TAA

struct TaaArgs {
  const float* lighting;        // [in_rows, w, 3]
  const float* depth;           // [in_rows, w]
  const float* velocity;        // [in_rows, w, 2]
  const float* velocity_prev;   // [fh, w, 2]
  const float* history;         // [fh, w, 3]
  float* out;                   // [rows, w, 3]
  float weights[9];             // f32 Mitchell weights, offsets dx-outer, dy-inner
  float inv_wsum, inv9, blend, one_minus_blend, velocity_rejection, gamma, inv_w, inv_fh;
  int rows, w, in_rows, in_shift, v_row0, fh, mode;   // mode 0 YCoCg, 1 full RGB, 2 bilinear
};

// _catmull_weights along one axis: the 4x4 origin (clamped to [0, n-4]) and
// the weights of the unclamped position
__device__ __forceinline__ void catmull_axis(float uvc, int n, int* t0, float* wt) {
  const float sp = uvc * (float)n;
  const float t1 = floorf(sp - 0.5f);
  const float f = (sp - 0.5f) - t1;
  wt[0] = f * (-0.5f + f * (1.0f - 0.5f * f));
  wt[1] = 1.0f + (f * f) * (-2.5f + 1.5f * f);
  wt[2] = f * (0.5f + f * (2.0f - 1.5f * f));
  wt[3] = (f * f) * (-0.5f + 0.5f * f);
  *t0 = min(max((int)t1 - 1, 0), n - 4);
}

// sample_bilinear_window's corner along one axis: the clamped base texel,
// its edge-clamped neighbour and the weight (zero where floor < 0)
__device__ __forceinline__ void bilinear_axis(float uvc, int n, int* i0, int* i1, float* fr) {
  const float x = uvc * (float)n - 0.5f;
  const float x0f = floorf(x);
  float f = x - x0f;
  if (x0f < 0.0f) f = 0.0f;
  const int i = clampi((int)x0f, 0, n - 1);
  *i0 = i;
  *i1 = min(i + 1, n - 1);
  *fr = f;
}

__device__ __forceinline__ float bilerp(float t00, float t10, float t01, float t11, float fx,
                                        float fy) {
  const float top = t00 + (t10 - t00) * fx;
  const float bot = t01 + (t11 - t01) * fx;
  return top + (bot - top) * fy;
}

// TAA, a thread per pixel.  What bounds it is its instructions, not its
// 117 MB (35 us at 3.35 TB/s): with -fmad=false each of its ~420 flops a
// pixel is an instruction of its own, besides the loads, f16 conversions
// and addressing.  Tiles with the history (and the neighbourhood or the
// output) staged in shared memory, each texel converted once, were no
// faster on the H100 (the sweep-only taa_sweep.cu, PERF.md).
__global__ void __launch_bounds__(kThreads) taa_kernel(const TaaArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.rows * a.w) return;
  const int r = idx / a.w, x = idx - r * a.w, w = a.w;

  // Mitchell 3x3 source and the moments
  float src[3] = {0.0f, 0.0f, 0.0f}, m1[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
  int k = 0;
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy, ++k) {
      const int yy = clampi(r + a.in_shift + dy, 0, a.in_rows - 1);
      const int xx = clampi(x + dx, 0, w - 1);
      const float* p = a.lighting + ((size_t)yy * w + xx) * 3;
      for (int c = 0; c < 3; ++c) {
        const float nb = p[c];
        src[c] = src[c] + a.weights[k] * nb;
        m1[c] = m1[c] + nb;
        m2[c] = m2[c] + nb * nb;
      }
    }
  }
  float minc[3], maxc[3];
  for (int c = 0; c < 3; ++c) {
    src[c] = src[c] * a.inv_wsum;
    m1[c] = m1[c] * a.inv9;
    m2[c] = m2[c] * a.inv9;
    const float sigma = sqrtf(fabsf(m2[c] - m1[c] * m1[c]));
    minc[c] = m1[c] - a.gamma * sigma;
    maxc[c] = m1[c] + a.gamma * sigma;
  }

  // closest-depth velocity dilation: strict <, the centre first
  const int yc = r + a.in_shift;
  float best = a.depth[(size_t)yc * w + x];
  float vel[2] = {a.velocity[((size_t)yc * w + x) * 2], a.velocity[((size_t)yc * w + x) * 2 + 1]};
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      if (dx == 0 && dy == 0) continue;
      const int yy = clampi(yc + dy, 0, a.in_rows - 1);
      const int xx = clampi(x + dx, 0, w - 1);
      const float d = a.depth[(size_t)yy * w + xx];
      if (d < best) {
        best = d;
        vel[0] = a.velocity[((size_t)yy * w + xx) * 2];
        vel[1] = a.velocity[((size_t)yy * w + xx) * 2 + 1];
      }
    }
  }

  const float u = ((float)x + 0.5f) * a.inv_w;
  const float v = ((float)(a.v_row0 + r) + 0.5f) * a.inv_fh;
  const float ru = u - vel[0] * 0.5f;
  const float rv = v - vel[1] * 0.5f;
  const int fh = a.fh;
  const float* hist = a.history;
  const float* vprev = a.velocity_prev;

  float prev[3], pvel[2];
  if (a.mode == 2) {
    // bilinear f16 (history, prev velocity)
    int x0, x1, y0, y1;
    float fx, fy;
    bilinear_axis(ru, w, &x0, &x1, &fx);
    bilinear_axis(rv, fh, &y0, &y1, &fy);
    const size_t t00 = (size_t)y0 * w + x0, t10 = (size_t)y0 * w + x1;
    const size_t t01 = (size_t)y1 * w + x0, t11 = (size_t)y1 * w + x1;
    for (int c = 0; c < 3; ++c)
      prev[c] = bilerp(f16r(hist[t00 * 3 + c]), f16r(hist[t10 * 3 + c]),
                       f16r(hist[t01 * 3 + c]), f16r(hist[t11 * 3 + c]), fx, fy);
    for (int c = 0; c < 2; ++c)
      pvel[c] = bilerp(f16r(vprev[t00 * 2 + c]), f16r(vprev[t10 * 2 + c]),
                       f16r(vprev[t01 * 2 + c]), f16r(vprev[t11 * 2 + c]), fx, fy);
  } else {
    int tx, ty;
    float wx[4], wy[4];
    catmull_axis(ru, w, &tx, wx);
    catmull_axis(rv, fh, &ty, wy);
    int x0, x1, y0, y1;
    float fx, fy;
    bilinear_axis(ru, w, &x0, &x1, &fx);
    bilinear_axis(rv, fh, &y0, &y1, &fy);
    const size_t t00 = (size_t)y0 * w + x0, t10 = (size_t)y0 * w + x1;
    const size_t t01 = (size_t)y1 * w + x0, t11 = (size_t)y1 * w + x1;
    if (a.mode == 1) {
      // full-RGB 16-tap Catmull-Rom of the f16 history
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < 4; ++i) {
        const int yy = min(ty + i, fh - 1);
        for (int j = 0; j < 4; ++j) {
          const int xx = min(tx + j, w - 1);
          const float wt = wy[i] * wx[j];
          const float* p = hist + ((size_t)yy * w + xx) * 3;
          for (int c = 0; c < 3; ++c) acc[c] = acc[c] + f16r(p[c]) * wt;
        }
      }
      for (int c = 0; c < 3; ++c) prev[c] = acc[c] < 0.0f ? 0.0f : acc[c];
    } else {
      // YCoCg split: Catmull-Rom of the f16 luma, bilinear f16 Co/Cg
      float ys = 0.0f;
      for (int i = 0; i < 4; ++i) {
        const int yy = min(ty + i, fh - 1);
        for (int j = 0; j < 4; ++j) {
          const int xx = min(tx + j, w - 1);
          const float* p = hist + ((size_t)yy * w + xx) * 3;
          const float luma = (0.25f * p[0] + 0.5f * p[1]) + 0.25f * p[2];
          ys = ys + f16r(luma) * (wy[i] * wx[j]);
        }
      }
      if (ys < 0.0f) ys = 0.0f;
      float co[4], cg[4];
      const size_t ts[4] = {t00, t10, t01, t11};
      for (int q = 0; q < 4; ++q) {
        const float* p = hist + ts[q] * 3;
        co[q] = f16r(0.5f * p[0] - 0.5f * p[2]);
        cg[q] = f16r((-0.25f * p[0] + 0.5f * p[1]) - 0.25f * p[2]);
      }
      const float cos_ = bilerp(co[0], co[1], co[2], co[3], fx, fy);
      const float cgs = bilerp(cg[0], cg[1], cg[2], cg[3], fx, fy);
      prev[0] = (ys + cos_) - cgs;
      prev[1] = ys + cgs;
      prev[2] = (ys - cos_) - cgs;
    }
    for (int c = 0; c < 2; ++c)
      pvel[c] = bilerp(f16r(vprev[t00 * 2 + c]), f16r(vprev[t10 * 2 + c]),
                       f16r(vprev[t01 * 2 + c]), f16r(vprev[t11 * 2 + c]), fx, fy);
  }
  for (int c = 0; c < 3; ++c) prev[c] = minp(maxp(prev[c], minc[c]), maxc[c]);

  // velocity rejection; torch.linalg.vector_norm over the last dim of 2
  const float ddx = pvel[0] - vel[0], ddy = pvel[1] - vel[1];
  const float nrm = sqrtf(ddx * ddx + ddy * ddy);
  float wb = a.blend + a.velocity_rejection * nrm;
  float wa = a.one_minus_blend;
  if (ru < 0.0f || ru > 1.0f || rv < 0.0f || rv > 1.0f) {
    wb = 1.0f;
    wa = 0.0f;
  }
  const float den = maxp(wb + wa, 1e-5f);
  float* o = a.out + (size_t)idx * 3;
  for (int c = 0; c < 3; ++c) o[c] = (src[c] * wb + prev[c] * wa) / den;
}

// ---------------------------------------------------------------------------
// bloom: the linear resize bands and the atlas band

// One axis of resize_linear: out[o] = sum_k wt[o*K + k] * in[first[o] + k]
// (k < K; padded weights are 0 at a clamped index).  first == nullptr: the
// axis keeps its size (out[o] = in[o]).
struct Band {
  const int* first;
  const float* wt;
  int k;
};

// The atlas band of one level: rows [0, atlas_h) of columns [col, col + lw);
// the level's texels above, zeros below (pack_mip_atlas's zero fill)
__device__ __forceinline__ void atlas_store(__nv_bfloat16* atlas, int wa, int col, int y, int x,
                                            const float* v) {
  __nv_bfloat16* p = atlas + ((size_t)y * wa + col + x) * 3;
  for (int c = 0; c < 3; ++c) p[c] = __float2bfloat16_rn(v[c]);
}

struct DownArgs {
  const float* src;   // [sh, sw, 3]
  float* out;         // [row_count, dw, 3]: rows [row_begin, row_begin + row_count)
  Band rows_band, cols_band;
  __nv_bfloat16* atlas;   // [atlas_h, atlas_wa, 3] or nullptr
  int sh, sw, dh, dw, row_begin, row_count, exact2, firefly;
  int atlas_h, atlas_wa, atlas_col, src_atlas_col;   // src_atlas_col < 0: no source band
};

__device__ __forceinline__ void box2(const float* src, int sw, int y0, int y1, int x0, int x1,
                                     float* b) {
  const float* p00 = src + ((size_t)y0 * sw + x0) * 3;
  const float* p01 = src + ((size_t)y0 * sw + x1) * 3;
  const float* p10 = src + ((size_t)y1 * sw + x0) * 3;
  const float* p11 = src + ((size_t)y1 * sw + x1) * 3;
  for (int c = 0; c < 3; ++c) b[c] = ((p00[c] + p01[c]) + (p10[c] + p11[c])) * 0.25f;
}

// b00 at half-res (i, j): source rows 2i, 2i+1, columns 2j, 2j+1
__device__ __forceinline__ void b00_at(const DownArgs& a, int i, int j, float* b) {
  i = clampi(i, 0, a.dh - 1);
  j = clampi(j, 0, a.dw - 1);
  box2(a.src, a.sw, 2 * i, 2 * i + 1, 2 * j, 2 * j + 1, b);
}

// b11 = box2 of the source shifted (1, 1), edge clamped
__device__ __forceinline__ void b11_at(const DownArgs& a, int i, int j, float* b) {
  i = clampi(i, 0, a.dh - 1);
  j = clampi(j, 0, a.dw - 1);
  box2(a.src, a.sw, min(2 * i + 1, a.sh - 1), min(2 * i + 2, a.sh - 1), min(2 * j + 1, a.sw - 1),
       min(2 * j + 2, a.sw - 1), b);
}

// resize_linear(shift_edge(src, dy, dx), dh, dw)[i, j]: rows first, then
// columns, each only where its size changes.  kCg: read src at L2 (__ldcg),
// for a source written earlier in the same launch
template <bool kCg = false>
__device__ void resized_tap(const float* src, int sh, int sw, const Band& rb, const Band& cb,
                            int dy, int dx, int i, int j, float* v) {
  const int nci = cb.first ? cb.k : 1;
  const int nri = rb.first ? rb.k : 1;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int q = 0; q < nci; ++q) {
    const int xs = cb.first ? min(cb.first[j] + q, sw - 1) : j;
    const int xx = clampi(xs + dx, 0, sw - 1);
    float col[3] = {0.0f, 0.0f, 0.0f};
    for (int p = 0; p < nri; ++p) {
      const int ys = rb.first ? min(rb.first[i] + p, sh - 1) : i;
      const int yy = clampi(ys + dy, 0, sh - 1);
      const float* t = src + ((size_t)yy * sw + xx) * 3;
      float tv[3];
      for (int c = 0; c < 3; ++c) tv[c] = kCg ? __ldcg(t + c) : t[c];
      if (rb.first) {
        const float wt = rb.wt[(size_t)i * rb.k + p];
        for (int c = 0; c < 3; ++c) col[c] = col[c] + wt * tv[c];
      } else {
        for (int c = 0; c < 3; ++c) col[c] = tv[c];
      }
    }
    if (cb.first) {
      const float wt = cb.wt[(size_t)j * cb.k + q];
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + wt * col[c];
    } else {
      for (int c = 0; c < 3; ++c) acc[c] = col[c];
    }
  }
  for (int c = 0; c < 3; ++c) v[c] = acc[c];
}

// the 13 taps (dx, dy, weight) of downsample_13tap's general branch (in
// constant memory: a loop indexes them)
__constant__ int kTaps13[13][2] = {{0, 0}, {-2, -2}, {2, -2}, {-2, 2}, {2, 2}, {0, -2}, {-2, 0},
                                   {2, 0}, {0, 2}, {-1, -1}, {1, -1}, {-1, 1}, {1, 1}};
__constant__ float kWts13[13] = {0.125f, 0.03125f, 0.03125f, 0.03125f, 0.03125f, 0.0625f,
                                 0.0625f, 0.0625f, 0.0625f, 0.125f, 0.125f, 0.125f, 0.125f};

// the 13 taps of downsample_13tap's general branch at (i, j), each a resize
// of an edge-clamped shift of src
template <bool kCg = false>
__device__ void down_resized(const float* src, int sh, int sw, const Band& rb, const Band& cb,
                             int i, int j, float* out) {
  const int (*taps)[2] = kTaps13;
  const float* wts = kWts13;
  for (int t = 0; t < 13; ++t) {
    float v[3];
    resized_tap<kCg>(src, sh, sw, rb, cb, taps[t][1], taps[t][0], i, j, v);
    for (int c = 0; c < 3; ++c) out[c] = t == 0 ? wts[t] * v[c] : out[c] + wts[t] * v[c];
  }
}

__device__ void down_texel(const DownArgs& a, int i, int j, float* out) {
  if (a.exact2) {
    float b[3];
    b00_at(a, i, j, b);
    for (int c = 0; c < 3; ++c) out[c] = 0.125f * b[c];
    const int diag[4][2] = {{-1, -1}, {-1, 1}, {1, -1}, {1, 1}};
    const int cross[4][2] = {{-1, 0}, {0, -1}, {1, 0}, {0, 1}};
    const int odd[4][2] = {{-1, -1}, {-1, 0}, {0, -1}, {0, 0}};
    for (int t = 0; t < 4; ++t) {
      b00_at(a, i + diag[t][0], j + diag[t][1], b);
      for (int c = 0; c < 3; ++c) out[c] = out[c] + 0.03125f * b[c];
    }
    for (int t = 0; t < 4; ++t) {
      b00_at(a, i + cross[t][0], j + cross[t][1], b);
      for (int c = 0; c < 3; ++c) out[c] = out[c] + 0.0625f * b[c];
    }
    for (int t = 0; t < 4; ++t) {
      b11_at(a, i + odd[t][0], j + odd[t][1], b);
      for (int c = 0; c < 3; ++c) out[c] = out[c] + 0.125f * b[c];
    }
  } else {
    down_resized(a.src, a.sh, a.sw, a.rows_band, a.cols_band, i, j, out);
  }
  if (a.firefly)
    for (int c = 0; c < 3; ++c) out[c] = minp(out[c], 1.0f);
}

// Threads [0, n_level): the level's texels (with an atlas, its whole band of
// atlas_h rows, zeros below the level); [n_level, n_level + n_src): the
// source's band, where src_atlas_col >= 0.
__global__ void __launch_bounds__(kThreads) bloom_down_kernel(const DownArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int level_rows = a.atlas ? a.atlas_h : a.row_count;
  const int n_level = level_rows * a.dw;
  if (idx < n_level) {
    const int r = idx / a.dw, j = idx - r * a.dw;
    if (a.atlas && r >= a.dh) {
      const float zero[3] = {0.0f, 0.0f, 0.0f};
      atlas_store(a.atlas, a.atlas_wa, a.atlas_col, r, j, zero);
      return;
    }
    float v[3];
    down_texel(a, a.row_begin + r, j, v);
    float* o = a.out + ((size_t)r * a.dw + j) * 3;
    for (int c = 0; c < 3; ++c) o[c] = v[c];
    if (a.atlas) atlas_store(a.atlas, a.atlas_wa, a.atlas_col, r, j, v);
    return;
  }
  if (a.src_atlas_col < 0) return;
  const int s = idx - n_level;
  if (s >= a.atlas_h * a.sw) return;
  const int y = s / a.sw, x = s - y * a.sw;
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (y < a.sh)
    for (int c = 0; c < 3; ++c) v[c] = a.src[((size_t)y * a.sw + x) * 3 + c];
  atlas_store(a.atlas, a.atlas_wa, a.src_atlas_col, y, x, v);
}

// ---------------------------------------------------------------------------
// bloom down chain: every level of a frame's downsample chain in one launch
//
// Why.  Six launches of bloom_down_kernel, one per level, cost ~40 us of
// Python and ctypes each on the host (checks, an output, the bands, a struct,
// the stream), five times the chain's device time; and the deep levels
// (240x136 down to 30x17) are a few blocks each, run one after another.
// This kernel takes the whole chain in one launch: a persistent grid of as
// many blocks as are resident at once walks the units of every level in
// order (level 1's tiles, then level 2's, ...), unit u on block u mod grid.
//
// Dependencies, not a barrier.  A unit of level l + 1 reads a window of
// level l: before it starts, its block waits until every unit of level l
// that writes into that window is complete (an exact tile reads a 20 x 72
// texel window: at most 4 x 4 tiles above it; a unit of an odd-size level
// waits for the whole level above).  Each unit, once written, stores the
// launch's epoch into its flag (the host counts launches; no flag is ever
// reset).  So level 2 starts where level 1 is done while level 1's last
// tiles still run, and the deep levels' chain of small steps waits on a
// few flags, not on the whole grid: a grid-wide barrier would hold every
// level for the slowest tile of the one above, with hundreds of blocks
// spinning on one counter.  A unit waits only for units earlier in the order,
// which blocks already resident run in order, so the waits end: the kernel
// is launched with cudaLaunchCooperativeKernel, which refuses a grid that
// would not all be resident, at the occupancy query's size.  Levels after
// the first read a source written in this launch: those reads go to L2
// (__ldcg), never to an SM's L1, and each level starts at a 128-byte line
// of the chain buffer.
//
// What bounds it: bytes, and level 1 holds almost all of them (1920x1088
// f32 in, 960x544 out).  An exact 2:1 level is tiled 2D: a block loads its
// tile's source rows plus a halo into shared memory in 16-byte lines, forms
// the two box2 phase images b00 / b11 there once, and takes each texel's 13
// taps from them (9 b00 and 4 b11 box means: 2 per texel instead of 13).
// Odd sizes keep the per-texel weight-band path, a unit per 256 texels.
// The atlas rows below each level are zero-filled by the whole grid once
// its units are done.
//
// Exactness: the box means and the tap sums in bloom_down_kernel's order.

// blocks of the chain kernel an SM keeps resident (the register bound) and
// the rows of a tile; -D values for a sweep
#ifndef CHAIN_MIN_BLOCKS
#define CHAIN_MIN_BLOCKS 4
#endif
#ifndef CHAIN_TILE_H
#define CHAIN_TILE_H 8
#endif

constexpr int kMaxLevels = 16;
constexpr int kChainThreads = 256;
constexpr int kTileH = CHAIN_TILE_H, kTileW = 32;   // destination texels of a tile
// source rows [2 i0 - 2, 2 i0 + 2 kTileH + 2) and texels [2 j0 - 4,
// 2 j0 + 2 kTileW + 4): the halo is widened to 4 texels on the left so that
// a row of the tile starts on a 16-byte line (12 B a texel, j0 even)
constexpr int kSrcRows = 2 * kTileH + 4, kSrcCols = 2 * kTileW + 8;
constexpr int kSrcPitch = kSrcCols * 3;    // floats
constexpr int kB00Rows = kTileH + 2, kB00Cols = kTileW + 2;   // b00 at i0-1 .. i0+kTileH
constexpr int kB11Rows = kTileH + 1, kB11Cols = kTileW + 1;   // b11 at i0-1 .. i0+kTileH-1
static_assert(kSrcPitch % 4 == 0, "source rows are 16-byte lines");

// One level of the chain: its source is the chain's input (level 0) or the
// level before it in the chain buffer.
struct ChainLevel {
  Band rows_band, cols_band;   // odd sizes (exact2 0) only
  int sh, sw, dh, dw;
  int out_off;                 // floats into the chain buffer, a multiple of 32
  int exact2, firefly, atlas_col;
};

struct ChainArgs {
  const float* src;            // [sh, sw, 3] the chain's input
  float* buf;                  // the levels, each at its out_off
  __nv_bfloat16* atlas;        // [atlas_h, atlas_wa, 3] or nullptr
  unsigned* flags;             // a flag per unit of every level (bloom_down_chain_units)
  unsigned epoch;              // this launch's mark, never 0, new every launch
  int passes, atlas_h, atlas_wa;
  ChainLevel lv[kMaxLevels];
};

// The units of a level: its tiles (exact 2:1) or blocks of 256 texels
__host__ __device__ __forceinline__ int level_units(const ChainLevel& L) {
  return L.exact2 ? ((L.dh + kTileH - 1) / kTileH) * ((L.dw + kTileW - 1) / kTileW)
                  : (int)(((long long)L.dh * L.dw + kChainThreads - 1) / kChainThreads);
}

// Each unit's flag (shade_common.cuh's acquire / release helpers)
using shade::st_release;
using shade::wait_flag;

// Wait until the units of level l - 1 (the first of them at `base`) that
// write the part of its output unit t of level l reads are complete
__device__ void wait_sources(const ChainArgs& a, int l, int t, int base) {
  const ChainLevel& L = a.lv[l];
  const ChainLevel& P = a.lv[l - 1];    // P's texels are L's source
  int r0 = 0, r1 = P.dh - 1, c0 = 0, c1 = P.dw - 1;
  if (L.exact2) {   // the tile's source window (chain_tile_exact)
    const int tiles_x = (L.dw + kTileW - 1) / kTileW;
    const int i0 = (t / tiles_x) * kTileH, j0 = (t % tiles_x) * kTileW;
    r0 = max(2 * i0 - 2, 0);
    r1 = min(2 * i0 + kSrcRows - 2, P.dh) - 1;
    c0 = max(2 * j0 - 4, 0);
    c1 = min(2 * j0 + kSrcCols - 4, P.dw) - 1;
  }
  if (P.exact2) {
    const int tiles_x = (P.dw + kTileW - 1) / kTileW;
    const int ty0 = r0 / kTileH, tx0 = c0 / kTileW, nx = c1 / kTileW - tx0 + 1;
    const int n = (r1 / kTileH - ty0 + 1) * nx;
    for (int f = threadIdx.x; f < n; f += kChainThreads)
      wait_flag(a.flags + base + (ty0 + f / nx) * tiles_x + tx0 + f % nx, a.epoch);
  } else {          // the blocks of texels over those rows
    const int u0 = (int)((long long)r0 * P.dw / kChainThreads);
    const int u1 = (int)(((long long)(r1 + 1) * P.dw - 1) / kChainThreads);
    for (int f = u0 + threadIdx.x; f <= u1; f += kChainThreads)
      wait_flag(a.flags + base + f, a.epoch);
  }
  __syncthreads();
}

// box2 of the staged source: rows y0, y1 and texels x0, x1 of the tile
__device__ __forceinline__ void box2_tile(const float* s, int y0, int y1, int x0, int x1,
                                          float* b) {
  const float* p00 = s + y0 * kSrcPitch + x0 * 3;
  const float* p01 = s + y0 * kSrcPitch + x1 * 3;
  const float* p10 = s + y1 * kSrcPitch + x0 * 3;
  const float* p11 = s + y1 * kSrcPitch + x1 * 3;
  for (int c = 0; c < 3; ++c) b[c] = ((p00[c] + p01[c]) + (p10[c] + p11[c])) * 0.25f;
}

// 16-byte lines of a staged source row
constexpr int kSrcLines = kSrcPitch / 4;

struct ChainSmem {
  float src[kSrcRows * kSrcPitch];
  float b00[kB00Rows * kB00Cols * 3];
  float b11[kB11Rows * kB11Cols * 3];
};

// One kTileH x kTileW tile of an exact 2:1 level
__device__ void chain_tile_exact(const ChainArgs& a, const ChainLevel& L, const float* src,
                                 float* out, int tile, ChainSmem& sm) {
  const int tiles_x = (L.dw + kTileW - 1) / kTileW;
  const int ti = tile / tiles_x, tj = tile - ti * tiles_x;
  const int i0 = ti * kTileH, j0 = tj * kTileW;
  const int yb = 2 * i0 - 2, xb = 2 * j0 - 4;
  const int sh = L.sh, sw = L.sw, dh = L.dh, dw = L.dw;

  // the source rows of the tile that lie in the image, in 16-byte lines
  // where the line lies inside the row and is aligned
  const int xlo = max(xb, 0), xhi = min(xb + kSrcCols, sw);
  for (int q = threadIdx.x; q < kSrcRows * kSrcLines; q += kChainThreads) {
    const int r = q / kSrcLines, f = 4 * (q - r * kSrcLines);
    const int y = yb + r;
    if (y < 0 || y >= sh) continue;
    const long long row = (long long)y * sw;
    const long long g = (row + xb) * 3 + f, lo = (row + xlo) * 3, hi = (row + xhi) * 3;
    float* d = sm.src + r * kSrcPitch + f;
    if (g >= lo && g + 4 <= hi && (reinterpret_cast<uintptr_t>(src + g) & 15) == 0) {
      *reinterpret_cast<float4*>(d) = __ldcg(reinterpret_cast<const float4*>(src + g));
    } else {
      for (int k = 0; k < 4; ++k)
        if (g + k >= lo && g + k < hi) d[k] = __ldcg(src + g + k);
    }
  }
  __syncthreads();

  // the two phase images over the tile and its one-texel halo, edge clamped
  for (int q = threadIdx.x; q < kB00Rows * kB00Cols; q += kChainThreads) {
    const int r = q / kB00Cols, c = q - r * kB00Cols;
    const int i = clampi(i0 - 1 + r, 0, dh - 1), j = clampi(j0 - 1 + c, 0, dw - 1);
    box2_tile(sm.src, 2 * i - yb, 2 * i + 1 - yb, 2 * j - xb, 2 * j + 1 - xb, sm.b00 + q * 3);
  }
  for (int q = threadIdx.x; q < kB11Rows * kB11Cols; q += kChainThreads) {
    const int r = q / kB11Cols, c = q - r * kB11Cols;
    const int i = clampi(i0 - 1 + r, 0, dh - 1), j = clampi(j0 - 1 + c, 0, dw - 1);
    box2_tile(sm.src, min(2 * i + 1, sh - 1) - yb, min(2 * i + 2, sh - 1) - yb,
              min(2 * j + 1, sw - 1) - xb, min(2 * j + 2, sw - 1) - xb, sm.b11 + q * 3);
  }
  __syncthreads();

  // the 13 taps of each texel (down_texel's exact branch, in its order)
  for (int q = threadIdx.x; q < kTileH * kTileW; q += kChainThreads) {
    const int r = q / kTileW, c = q - r * kTileW;
    const int i = i0 + r, j = j0 + c;
    if (i >= dh || j >= dw) continue;
    const float* b0 = sm.b00 + ((r + 1) * kB00Cols + c + 1) * 3;
    const float* b1 = sm.b11 + ((r + 1) * kB11Cols + c + 1) * 3;
    // the taps' offsets in the phase images, in down_texel's order: the
    // diagonals and the cross of b00, the four b11 around the texel
    constexpr int kDiag[4] = {-kB00Cols - 1, -kB00Cols + 1, kB00Cols - 1, kB00Cols + 1};
    constexpr int kCross[4] = {-kB00Cols, -1, kB00Cols, 1};
    constexpr int kOdd[4] = {-kB11Cols - 1, -kB11Cols, -1, 0};
    float o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = 0.125f * b0[k];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = o[k] + 0.03125f * b0[kDiag[t] * 3 + k];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = o[k] + 0.0625f * b0[kCross[t] * 3 + k];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = o[k] + 0.125f * b1[kOdd[t] * 3 + k];
    if (L.firefly)
      for (int k = 0; k < 3; ++k) o[k] = minp(o[k], 1.0f);
    float* p = out + ((size_t)i * dw + j) * 3;
    for (int k = 0; k < 3; ++k) p[k] = o[k];
    if (a.atlas) atlas_store(a.atlas, a.atlas_wa, L.atlas_col, i, j, o);
  }
  __syncthreads();   // the next tile's rows overwrite this one's
}

// 256 texels (unit t) of an odd-size level: down_texel's general branch
__device__ void chain_texels_resized(const ChainArgs& a, const ChainLevel& L, const float* src,
                                     float* out, int t) {
  const long long q = (long long)t * kChainThreads + threadIdx.x;
  if (q >= (long long)L.dh * L.dw) return;
  const int i = (int)(q / L.dw), j = (int)(q - (long long)i * L.dw);
  float o[3];
  down_resized<true>(src, L.sh, L.sw, L.rows_band, L.cols_band, i, j, o);
  if (L.firefly)
    for (int k = 0; k < 3; ++k) o[k] = minp(o[k], 1.0f);
  float* p = out + q * 3;
  for (int k = 0; k < 3; ++k) p[k] = o[k];
  if (a.atlas) atlas_store(a.atlas, a.atlas_wa, L.atlas_col, i, j, o);
}

__global__ void __launch_bounds__(kChainThreads, CHAIN_MIN_BLOCKS) bloom_down_chain_kernel(
    const __grid_constant__ ChainArgs a) {
  __shared__ __align__(16) ChainSmem sm;
  // the units of every level in order: level l's are [first, first + n)
  int l = 0, first = 0, prev = 0, n = level_units(a.lv[0]);
  for (int u = blockIdx.x;; u += gridDim.x) {
    while (l < a.passes && u >= first + n) {
      prev = first;
      first += n;
      if (++l < a.passes) n = level_units(a.lv[l]);
    }
    if (l >= a.passes) break;
    const ChainLevel& L = a.lv[l];
    const float* src = l == 0 ? a.src : a.buf + a.lv[l - 1].out_off;
    float* out = a.buf + L.out_off;
    if (l > 0) wait_sources(a, l, u - first, prev);
    if (L.exact2) {
      chain_tile_exact(a, L, src, out, u - first, sm);
    } else {
      chain_texels_resized(a, L, src, out, u - first);
      __syncthreads();
    }
    if (threadIdx.x == 0) st_release(a.flags + u, a.epoch);   // the unit is written
  }
  if (a.atlas == nullptr) return;
  // every level's atlas rows below its texels (pack_mip_atlas's zeros)
  const float zero[3] = {0.0f, 0.0f, 0.0f};
  const long long stride = (long long)gridDim.x * kChainThreads;
  const long long tid = (long long)blockIdx.x * kChainThreads + threadIdx.x;
  for (int m = 0; m < a.passes; ++m) {
    const ChainLevel& M = a.lv[m];
    const long long rows = a.atlas_h - M.dh;
    for (long long q = tid; q < rows * M.dw; q += stride) {
      const int r = (int)(q / M.dw);
      atlas_store(a.atlas, a.atlas_wa, M.atlas_col, M.dh + r, (int)(q - (long long)r * M.dw),
                  zero);
    }
  }
}

// ---------------------------------------------------------------------------
// bloom up (+ the tonemap)

struct UpArgs {
  const float* src;    // [sh, sw, 3], nullptr: tonemap of base only
  float* out;          // [row_count, dw, 3]: rows [row_begin, row_begin + row_count)
  const float* base;   // [row_count, dw, 3] or nullptr
  Band rows_band, cols_band;
  float scale, exposure, gamma_exp;
  int sh, sw, dh, dw, row_begin, row_count, up2, tonemap;
};

// _up2's rows pass at output row y, source column x: 0.75 the texel, 0.25
// its edge-clamped neighbour on y's side
__device__ __forceinline__ void up2_row(const float* src, int sh, int sw, int y, int x,
                                        float* v) {
  const int i = y >> 1;
  const int nb = (y & 1) ? min(i + 1, sh - 1) : max(i - 1, 0);
  const float* p = src + ((size_t)i * sw + x) * 3;
  const float* q = src + ((size_t)nb * sw + x) * 3;
  for (int c = 0; c < 3; ++c) v[c] = 0.75f * p[c] + 0.25f * q[c];
}

__device__ void up_texel(const UpArgs& a, int y, int x, float* v) {
  if (a.up2) {
    const int j = x >> 1;
    const int nb = (x & 1) ? min(j + 1, a.sw - 1) : max(j - 1, 0);
    float p[3], q[3];
    up2_row(a.src, a.sh, a.sw, y, j, p);
    up2_row(a.src, a.sh, a.sw, y, nb, q);
    for (int c = 0; c < 3; ++c) v[c] = 0.75f * p[c] + 0.25f * q[c];
  } else {
    resized_tap(a.src, a.sh, a.sw, a.rows_band, a.cols_band, 0, 0, y, x, v);
  }
}

__device__ __forceinline__ float aces(float v) {
  v = v * 0.6f;
  const float r = (v * (2.51f * v + 0.03f)) / (v * (2.43f * v + 0.59f) + 0.14f);
  return minp(maxp(r, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads) bloom_up_kernel(const UpArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.row_count * a.dw) return;
  const int r = idx / a.dw, x = idx - r * a.dw, y = a.row_begin + r;
  float v[3];
  if (a.src) {
    const int offs[3] = {-3, 0, 3};
    const float wgt[3] = {1.0f, 2.0f, 1.0f};
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int ty = 0; ty < 3; ++ty) {
      const int yy = clampi(y + offs[ty], 0, a.dh - 1);
      for (int tx = 0; tx < 3; ++tx) {
        const int xx = clampi(x + offs[tx], 0, a.dw - 1);
        float u[3];
        up_texel(a, yy, xx, u);
        const float wt = wgt[tx] * wgt[ty];
        for (int c = 0; c < 3; ++c) acc[c] = acc[c] + wt * u[c];
      }
    }
    for (int c = 0; c < 3; ++c) v[c] = acc[c] * a.scale;
    if (a.base)
      for (int c = 0; c < 3; ++c) v[c] = a.base[(size_t)idx * 3 + c] + v[c];
  } else {
    for (int c = 0; c < 3; ++c) v[c] = a.base[(size_t)idx * 3 + c];
  }
  if (a.tonemap)
    for (int c = 0; c < 3; ++c) {
      const float t = aces(a.exposure * v[c]);
      v[c] = powf(t < 0.0f ? 0.0f : t, a.gamma_exp);
    }
  float* o = a.out + (size_t)idx * 3;
  for (int c = 0; c < 3; ++c) o[c] = v[c];
}

// ---------------------------------------------------------------------------
// bloom up chain: every up level of a frame and the tonemap in one launch
//
// Why.  Six launches of bloom_up_kernel cost ~40 us of Python and ctypes
// each on the host (bloom_up_level's checks, output, bands and struct), and
// each of their threads takes its 9 taps' 2x bilinear on the fly: 4 source
// texels a tap, 108 scalar loads a texel, nothing shared between
// neighbours.  This kernel takes the whole up chain, from the deepest down
// level to the tonemapped image, in one launch, with the down chain's
// scheme (its note above): a cooperative persistent grid walks every
// level's tiles in order, deepest first, each tile waiting on the
// acquire / release flags of the tiles of the level before it that its
// source window covers (a resized level waits for the whole level before
// it), the flags marked with a per-launch epoch; sources written in the
// launch are read at L2 (__ldcg) and each intermediate level starts on a
// 128-byte line of the chain buffer.
//
// A unit is a kUpTileH x kUpTileW tile of a level's output.  The last
// level's base lines are copied to shared memory first (cp.async), so that
// their reads overlap the tile's work.  At 2x, the tile's source window
// (the tile's half and a halo: the up image's 3-texel tap halo, its
// 1-texel bilinear neighbour) is staged in shared memory in 16-byte lines;
// _up2's rows pass is made over it, then its columns pass, so that the
// tile's 2x up image with its 3-texel halo (edge clamped) lies in shared
// memory, each value exactly up_texel's.  A resized level makes the same up
// image from resized_tap's weight bands.  Each output texel's 9 taps are
// then read from the up image (a texel a thread: stride-3 words, no bank
// conflict), in bloom_up_kernel's order (ty outer, tx inner, acc + wt * u,
// then * scale), and staged again; the tile's rows go out as 16-byte lines
// of their [rows, dw, 3] rows, the last level adding base in the same
// lines and tonemapping.  The last level computes the rows of its row
// window only (the row-sharded frame's rows); the levels before it are
// whole.
//
// What bounds it: bytes, in principle.  The chain must read the deepest
// level (6 KB at 1920x1088) and base and write the image (2 x 25 MB):
// ~0.015 ms at 3.35 TB/s.  The levels between are its own scratch (the
// 544x960 level alone 6.3 MB, the rest a quarter of it), written and read
// once each, and can stay in the 50 MB L2.  On the H100 it is the instructions and the chain of
// dependent levels (tile_sweep.py, PERF.md): the last level's tonemap
// (ACES's IEEE divide and an accurate powf a value) is ~0.026 ms of it,
// and each dependent level before it ~5 us.  32x32 tiles beat 16x32 and
// 8x64 (less halo); 3 blocks an SM (80 registers) lost, 5 (48) spilled.

// blocks of the up chain kernel an SM keeps resident (the register bound)
// and its tile; -D values for a sweep
#ifndef UP_MIN_BLOCKS
#define UP_MIN_BLOCKS 4
#endif
#ifndef UP_TILE_H
#define UP_TILE_H 32
#endif
#ifndef UP_TILE_W
#define UP_TILE_W 32
#endif

constexpr int kUpThreads = 256;
constexpr int kUpTileH = UP_TILE_H, kUpTileW = UP_TILE_W;
static_assert(kUpTileH % 2 == 0 && kUpTileW % 8 == 0, "a tile's source rows start on 16-byte lines");
// the source window of a 2x tile at (y0, x0): rows [((y0 - 3) >> 1) - 1, ...
// + kUpSrcRows), texels [x0 / 2 - 4, x0 / 2 + kUpTileW / 2 + 4)
constexpr int kUpSrcRows = kUpTileH / 2 + 6, kUpSrcCols = kUpTileW / 2 + 8;
constexpr int kUpSrcPitch = kUpSrcCols * 3;     // floats
// the up image: rows y0 - 3 .. y0 + kUpTileH + 2, texels x0 - 3 .. x0 + kUpTileW + 2
constexpr int kUpRows = kUpTileH + 6, kUpCols = kUpTileW + 6;
constexpr int kUpPitch = kUpCols * 3;
constexpr int kUpOutPitch = kUpTileW * 3;
static_assert(kUpOutPitch % 4 == 0, "a staged output row is 16-byte lines");

// One level of the up chain: its source is the chain's input (the first
// level) or the level before it in the chain buffer.
struct UpLevel {
  Band rows_band, cols_band;   // resized levels (up2 0) only
  int sh, sw, dh, dw;
  int out_off;                 // floats into the chain buffer, a multiple of 32 (not the last)
  int up2;
  int row_begin, row_count;    // the output rows computed: the last level's window, else all
  float scale;                 // factor / 16
};

struct UpChainArgs {
  const float* src;    // [sh, sw, 3] the deepest down level
  float* buf;          // the levels but the last, each at its out_off
  const float* base;   // [row_count, dw, 3] of the last level
  float* out;          // [row_count, dw, 3]: the last level's rows
  unsigned* flags;     // a flag per unit of every level (bloom_up_chain_units)
  unsigned epoch;      // this launch's mark, never 0, new every launch
  float exposure, gamma_exp;
  int passes, tonemap;
  UpLevel lv[kMaxLevels];
};

__host__ __device__ __forceinline__ int up_tiles_x(const UpLevel& L) {
  return (L.dw + kUpTileW - 1) / kUpTileW;
}

// The units of a level: its tiles over the rows it computes
__host__ __device__ __forceinline__ int up_level_units(const UpLevel& L) {
  return ((L.row_count + kUpTileH - 1) / kUpTileH) * up_tiles_x(L);
}

// The first source row of a 2x tile's window (floor division: y0 - 3 < 0
// at the top)
__device__ __forceinline__ int up_src_row0(int y0) { return ((y0 - 3) >> 1) - 1; }

// Wait until the tiles of level k - 1 (the first at `base`) that write the
// part of its output that unit t of level k reads are complete
__device__ void up_wait_sources(const UpChainArgs& a, int k, int t, int base) {
  const UpLevel& L = a.lv[k];
  const UpLevel& P = a.lv[k - 1];   // P's texels are L's source; P is whole
  int r0 = 0, r1 = P.dh - 1, c0 = 0, c1 = P.dw - 1;
  if (L.up2) {   // the tile's source window (up_tile)
    const int tiles_x = up_tiles_x(L);
    const int y0 = L.row_begin + (t / tiles_x) * kUpTileH, x0 = (t % tiles_x) * kUpTileW;
    const int sy0 = up_src_row0(y0), sx0 = x0 / 2 - 4;
    r0 = max(sy0, 0);
    r1 = min(sy0 + kUpSrcRows, P.dh) - 1;
    c0 = max(sx0, 0);
    c1 = min(sx0 + kUpSrcCols, P.dw) - 1;
  }
  const int tiles_x = up_tiles_x(P);
  const int ty0 = r0 / kUpTileH, tx0 = c0 / kUpTileW, nx = c1 / kUpTileW - tx0 + 1;
  const int n = (r1 / kUpTileH - ty0 + 1) * nx;
  for (int f = threadIdx.x; f < n; f += kUpThreads)
    wait_flag(a.flags + base + (ty0 + f / nx) * tiles_x + tx0 + f % nx, a.epoch);
  __syncthreads();
}

struct UpSmem {
  float src[kUpSrcRows * kUpSrcPitch];   // the staged source window (2x)
  union {
    float rows[kUpRows * kUpSrcPitch];   // _up2's rows pass over it (2x)
    float out[kUpTileH * kUpOutPitch];   // the tile's outputs, * scale
  };
  float up[kUpRows * kUpPitch];          // the up image with its halo
  float base[kUpTileH * kUpOutPitch];    // the last level's base lines (cp.async)
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The last level's finish of one value: + base b, then the tonemap
__device__ __forceinline__ float up_finish(const UpChainArgs& a, float v, float b) {
  v = b + v;
  if (a.tonemap) {
    const float t = aces(a.exposure * v);
    v = powf(t < 0.0f ? 0.0f : t, a.gamma_exp);
  }
  return v;
}

// The 16-byte lines of a tile's output rows: line m of row r covers the
// floats [gl, gl + 4) of dst around the row's [g0, g1) (r < rows); whole:
// the line lies inside the row and dst (and base, on the last level) hold
// it on a 16-byte line; staged: also the row starts on a line, so the line
// is one in shared memory too
struct UpLine {
  long long g0, g1, gl;
  bool whole, staged;
};

__device__ __forceinline__ UpLine up_line(const UpLevel& L, int y0, int x0, int r, int m,
                                          int cols, const float* dst, const float* base) {
  UpLine l;
  l.g0 = ((long long)(y0 - L.row_begin + r) * L.dw + x0) * 3;
  l.g1 = l.g0 + 3 * cols;
  l.gl = (l.g0 & ~3LL) + 4 * m;
  l.whole = l.gl >= l.g0 && l.gl + 4 <= l.g1 && aligned16(dst + l.gl) &&
            (!base || aligned16(base + l.gl));
  l.staged = l.whole && (l.g0 & 3) == 0;
  return l;
}

constexpr int kUpLines = kUpOutPitch / 4 + 1;   // lines a tile's output row touches, at most

// One tile (unit t) of level L
__device__ void up_tile(const UpChainArgs& a, const UpLevel& L, const float* src, int t,
                        bool last, UpSmem& sm) {
  const int tiles_x = up_tiles_x(L);
  const int ti = t / tiles_x;
  const int y0 = L.row_begin + ti * kUpTileH, x0 = (t - ti * tiles_x) * kUpTileW;
  const int sh = L.sh, sw = L.sw, dh = L.dh, dw = L.dw;
  const int rows = min(kUpTileH, L.row_begin + L.row_count - y0);
  const int cols = min(kUpTileW, dw - x0);
  float* dst = last ? a.out : a.buf + L.out_off;
  const float* base = last ? a.base : nullptr;

  // the last level's base lines, copied to shared memory (cp.async) while
  // the tile is made: each thread the lines it finishes below
  if (last) {
    for (int q = threadIdx.x; q < kUpTileH * kUpLines; q += kUpThreads) {
      const int r = q / kUpLines;
      if (r >= rows) continue;
      const UpLine l = up_line(L, y0, x0, r, q - r * kUpLines, cols, dst, base);
      if (l.staged)
        __pipeline_memcpy_async(sm.base + r * kUpOutPitch + (l.gl - l.g0), base + l.gl, 16);
    }
    __pipeline_commit();
  }

  if (L.up2) {
    // the source window's rows that lie in the image, in the source's
    // 16-byte lines (float4 where a line lies inside the window, aligned)
    const int sy0 = up_src_row0(y0), sx0 = x0 / 2 - 4;
    const int xlo = max(sx0, 0), xhi = min(sx0 + kUpSrcCols, sw);
    constexpr int kLines = kUpSrcPitch / 4 + 1;
    for (int q = threadIdx.x; q < kUpSrcRows * kLines; q += kUpThreads) {
      const int r = q / kLines, m = q - r * kLines;
      const int y = sy0 + r;
      if (y < 0 || y >= sh) continue;
      const long long row = (long long)y * sw;
      const long long g0 = (row + xlo) * 3, g1 = (row + xhi) * 3, gs = (row + sx0) * 3;
      const long long gl = (g0 & ~3LL) + 4 * m;
      if (gl >= g1) continue;
      float* d = sm.src + r * kUpSrcPitch + (int)(gl - gs);   // the line's first float
      if (gl >= g0 && gl + 4 <= g1 && aligned16(src + gl)) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + gl));
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      } else {
        for (int k = 0; k < 4; ++k)
          if (gl + k >= g0 && gl + k < g1) d[k] = __ldcg(src + gl + k);
      }
    }
    __syncthreads();
    // _up2's rows pass (up2_row) at the up image's rows, edge clamped, over
    // the staged source texels that lie in the image (a texel a thread:
    // stride-3 words, no bank conflict)
    for (int q = threadIdx.x; q < kUpRows * kUpSrcCols; q += kUpThreads) {
      const int r = q / kUpSrcCols, c = q - r * kUpSrcCols;
      const int sx = sx0 + c;
      if (sx < 0 || sx >= sw) continue;
      const int y = clampi(y0 - 3 + r, 0, dh - 1);
      const int i = y >> 1;
      const int nb = (y & 1) ? min(i + 1, sh - 1) : max(i - 1, 0);
      const float* p = sm.src + (i - sy0) * kUpSrcPitch + 3 * c;
      const float* n = sm.src + (nb - sy0) * kUpSrcPitch + 3 * c;
      float* o = sm.rows + r * kUpSrcPitch + 3 * c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = 0.75f * p[ch] + 0.25f * n[ch];
    }
    __syncthreads();
    // its columns pass (up_texel) at the up image's texels, edge clamped
    for (int q = threadIdx.x; q < kUpRows * kUpCols; q += kUpThreads) {
      const int r = q / kUpCols, c = q - r * kUpCols;
      const int x = clampi(x0 - 3 + c, 0, dw - 1);
      const int j = x >> 1;
      const int nb = (x & 1) ? min(j + 1, sw - 1) : max(j - 1, 0);
      const float* p = sm.rows + r * kUpSrcPitch + (j - sx0) * 3;
      const float* n = sm.rows + r * kUpSrcPitch + (nb - sx0) * 3;
      float* o = sm.up + r * kUpPitch + 3 * c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = 0.75f * p[ch] + 0.25f * n[ch];
    }
  } else {
    // a resized level: up_texel's weight-band branch at each up texel
    for (int q = threadIdx.x; q < kUpRows * kUpCols; q += kUpThreads) {
      const int r = q / kUpCols, c = q - r * kUpCols;
      float v[3];
      resized_tap<true>(src, sh, sw, L.rows_band, L.cols_band, 0, 0,
                        clampi(y0 - 3 + r, 0, dh - 1), clampi(x0 - 3 + c, 0, dw - 1), v);
      for (int ch = 0; ch < 3; ++ch) sm.up[r * kUpPitch + c * 3 + ch] = v[ch];
    }
  }
  __syncthreads();

  // the 9 taps of each output texel (bloom_up_kernel's order), * scale
  for (int q = threadIdx.x; q < kUpTileH * kUpTileW; q += kUpThreads) {
    const int r = q / kUpTileW, c = q - r * kUpTileW;
    const float* u = sm.up + (r + 3) * kUpPitch + 3 * (c + 3);   // the texel's own up texel
    constexpr int kOff[3] = {-3, 0, 3};
    constexpr float kWgt[3] = {1.0f, 2.0f, 1.0f};
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        const float* t = u + kOff[ty] * kUpPitch + kOff[tx] * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[ch] = acc[ch] + (kWgt[tx] * kWgt[ty]) * t[ch];
      }
    float* o = sm.out + r * kUpOutPitch + 3 * c;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = acc[ch] * L.scale;
  }
  __pipeline_wait_prior(0);   // this thread's lines of base (up_prefetch_base)
  __syncthreads();

  // the tile's rows out in 16-byte lines of [rows, dw, 3]; the last level
  // adds base, in the same lines, and tonemaps
  for (int q = threadIdx.x; q < kUpTileH * kUpLines; q += kUpThreads) {
    const int r = q / kUpLines;
    if (r >= rows) continue;
    const UpLine l = up_line(L, y0, x0, r, q - r * kUpLines, cols, dst, base);
    const long long g0 = l.g0, g1 = l.g1, gl = l.gl;
    if (gl >= g1) continue;
    const float* s = sm.out + r * kUpOutPitch;   // s[g - g0] for g in [g0, g1)
    if (l.whole) {
      float4 v = l.staged ? *reinterpret_cast<const float4*>(s + (gl - g0))
                          : make_float4(s[gl - g0], s[gl - g0 + 1], s[gl - g0 + 2],
                                        s[gl - g0 + 3]);
      if (last) {
        const float4 b =
            l.staged ? *reinterpret_cast<const float4*>(sm.base + r * kUpOutPitch + (gl - g0))
                     : __ldcs(reinterpret_cast<const float4*>(base + gl));
        v.x = up_finish(a, v.x, b.x);
        v.y = up_finish(a, v.y, b.y);
        v.z = up_finish(a, v.z, b.z);
        v.w = up_finish(a, v.w, b.w);
        __stcs(reinterpret_cast<float4*>(dst + gl), v);
      } else {
        *reinterpret_cast<float4*>(dst + gl) = v;
      }
    } else {
      for (int k = 0; k < 4; ++k) {
        const long long g = gl + k;
        if (g < g0 || g >= g1) continue;
        const float v = s[g - g0];
        dst[g] = last ? up_finish(a, v, base[g]) : v;
      }
    }
  }
  __syncthreads();   // the next tile's staging overwrites this one's
}

__global__ void __launch_bounds__(kUpThreads, UP_MIN_BLOCKS) bloom_up_chain_kernel(
    const __grid_constant__ UpChainArgs a) {
  __shared__ __align__(16) UpSmem sm;
  // the units of every level in order: level k's are [first, first + n)
  int k = 0, first = 0, prev = 0, n = up_level_units(a.lv[0]);
  for (int u = blockIdx.x;; u += gridDim.x) {
    while (k < a.passes && u >= first + n) {
      prev = first;
      first += n;
      if (++k < a.passes) n = up_level_units(a.lv[k]);
    }
    if (k >= a.passes) break;
    const UpLevel& L = a.lv[k];
    const float* src = k == 0 ? a.src : a.buf + a.lv[k - 1].out_off;
    if (k > 0) up_wait_sources(a, k, u - first, prev);
    up_tile(a, L, src, u - first, k == a.passes - 1, sm);
    if (threadIdx.x == 0) st_release(a.flags + u, a.epoch);   // the unit is written
  }
}

static int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

extern "C" int taa_resolve_launch(const TaaArgs* args, void* stream) {
  const long long n = (long long)args->rows * args->w;
  if (n > 0) taa_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int bloom_down_launch(const DownArgs* args, void* stream) {
  const DownArgs& a = *args;
  long long n = (long long)(a.atlas ? a.atlas_h : a.row_count) * a.dw;
  if (a.atlas && a.src_atlas_col >= 0) n += (long long)a.atlas_h * a.sw;
  if (n > 0) bloom_down_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The units of a chain's levels: the flags a launch needs
extern "C" int bloom_down_chain_units(const ChainArgs* args) {
  int n = 0;
  for (int l = 0; l < args->passes; ++l) n += level_units(args->lv[l]);
  return n;
}

// The chain in one cooperative launch on `device` (made current for the
// call): as many blocks as are resident at once on the card, at most one
// per unit.
extern "C" int bloom_down_chain_launch(const ChainArgs* args, int device, void* stream) {
  static int resident[64];   // blocks of the kernel resident at once, per device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bloom_down_chain_kernel,
                                                          kChainThreads, 0);
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err == cudaSuccess && args->passes > 0) {
    const int grid = min(bloom_down_chain_units(args), resident[device]);
    void* params[] = {const_cast<ChainArgs*>(args)};
    err = cudaLaunchCooperativeKernel((const void*)bloom_down_chain_kernel, dim3(grid),
                                      dim3(kChainThreads), params, 0, (cudaStream_t)stream);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The chain kernel's registers a thread, resident blocks an SM and threads
// a block on the current card, for chip_smoke.py.
extern "C" int bloom_down_chain_occupancy(int* registers, int* blocks_per_sm, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bloom_down_chain_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *threads = kChainThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            bloom_down_chain_kernel,
                                                            kChainThreads, 0);
}

extern "C" int bloom_up_launch(const UpArgs* args, void* stream) {
  const long long n = (long long)args->row_count * args->dw;
  if (n > 0) bloom_up_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// The units of an up chain's levels: the flags a launch needs
extern "C" int bloom_up_chain_units(const UpChainArgs* args) {
  int n = 0;
  for (int l = 0; l < args->passes; ++l) n += up_level_units(args->lv[l]);
  return n;
}

// The up chain in one cooperative launch on `device` (made current for the
// call): as many blocks as are resident at once on the card, at most one
// per unit.
extern "C" int bloom_up_chain_launch(const UpChainArgs* args, int device, void* stream) {
  static int resident[64];   // blocks of the kernel resident at once, per device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bloom_up_chain_kernel,
                                                          kUpThreads, 0);
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err == cudaSuccess && args->passes > 0) {
    const int grid = min(bloom_up_chain_units(args), resident[device]);
    void* params[] = {const_cast<UpChainArgs*>(args)};
    err = cudaLaunchCooperativeKernel((const void*)bloom_up_chain_kernel, dim3(grid),
                                      dim3(kUpThreads), params, 0, (cudaStream_t)stream);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The up chain kernel on the current card, for chip_smoke.py: registers and
// local memory a thread, shared memory a block, resident blocks an SM,
// threads a block, and its tile.
extern "C" int bloom_up_chain_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                                        int* blocks_per_sm, int* threads, int* tile_w,
                                        int* tile_h) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bloom_up_chain_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *threads = kUpThreads;
  *tile_w = kUpTileW;
  *tile_h = kUpTileH;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bloom_up_chain_kernel,
                                                            kUpThreads, 0);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
