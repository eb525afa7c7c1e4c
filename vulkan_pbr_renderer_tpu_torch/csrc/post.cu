// The post stack for Hopper (sm_90a): TAA resolve, one bloom downsample
// level, one bloom upsample level (the last one fused with the tonemap).
//
// Replaces the JAX package's post stack, which XLA runs outside any Pallas
// kernel (vulkan_pbr_renderer_tpu/app/renderer.py:229 post_stack):
//  - taa_kernel: vulkan_pbr_renderer_tpu/shade/taa.py:32 taa_resolve;
//  - bloom_down_kernel: shade/bloom.py:65 downsample_13tap at one level
//    (the firefly clamp at level 1), plus its bf16 band of the next frame's
//    pyramid atlas (gpu/sampling.py pack_mip_atlas(...).astype(bfloat16));
//  - bloom_up_kernel: shade/bloom.py:101 upsample_tent9 at one level; on
//    the last level also hdr + tent, the exposure, utils/color.py:14
//    aces_approx and :21 gamma_encode.
// Each computes its plain PyTorch version in the port (shade/taa.py
// taa_resolve_plain, shade/bloom.py bloom_down_level_plain /
// bloom_up_level_plain) with a thread per output texel.
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
// This first version keeps a plain thread-per-texel shape: no shared-memory
// tiling.
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
#include <cuda_runtime.h>
#include <math.h>

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
// columns, each only where its size changes
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
      if (rb.first) {
        const float wt = rb.wt[(size_t)i * rb.k + p];
        for (int c = 0; c < 3; ++c) col[c] = col[c] + wt * t[c];
      } else {
        for (int c = 0; c < 3; ++c) col[c] = t[c];
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
    // the 13 taps (dx, dy, weight) of downsample_13tap's general branch
    const int taps[13][2] = {{0, 0}, {-2, -2}, {2, -2}, {-2, 2}, {2, 2}, {0, -2}, {-2, 0},
                             {2, 0}, {0, 2}, {-1, -1}, {1, -1}, {-1, 1}, {1, 1}};
    const float wts[13] = {0.125f, 0.03125f, 0.03125f, 0.03125f, 0.03125f, 0.0625f, 0.0625f,
                           0.0625f, 0.0625f, 0.125f, 0.125f, 0.125f, 0.125f};
    for (int t = 0; t < 13; ++t) {
      float v[3];
      resized_tap(a.src, a.sh, a.sw, a.rows_band, a.cols_band, taps[t][1], taps[t][0], i, j, v);
      for (int c = 0; c < 3; ++c) out[c] = t == 0 ? wts[t] * v[c] : out[c] + wts[t] * v[c];
    }
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

extern "C" int bloom_up_launch(const UpArgs* args, void* stream) {
  const long long n = (long long)args->row_count * args->dw;
  if (n > 0) bloom_up_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
