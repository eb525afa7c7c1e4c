// The sampling helpers of the GI ray kernels (gi_fast_ray.cu,
// gi_reference_ray.cu): the u8 lightgrid table's trilinear fetch, the trace
// table's nearest fetch, the bf16 previous-frame pyramid's bilinear level,
// the tone compressor and the point transform, each in its plain version's
// order on the card (see gi_fast_ray.cu's "Exactness").
//
// The fetches are templates over the kernel's argument struct, which names
// the tables and their sizes alike in both kernels: table, gd, gh, gw (the
// u8 [D,H,W,4] table); depth, th, tw (the [th,tw] f32 trace table); atlas,
// atlas_wa, prev_h, prev_w (the [>=prev_h, atlas_wa, 3] bf16 pyramid).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kInv255 = (float)(1.0 / 255.0);

// sampling._clamp_index: clamp the float, then convert
__device__ __forceinline__ int clamp_index(float x0f, int n) {
  const int i = (int)fminf(fmaxf(x0f, 0.0f), (float)(n - 1));
  return min(max(i, 0), n - 1);
}

// below 0 the fractional clamps to 0, so the edge texel repeats
__device__ __forceinline__ float window_frac(float x, float x0f) {
  return x0f < 0.0f ? 0.0f : fminf(fmaxf(x - x0f, 0.0f), 1.0f);
}

__device__ __forceinline__ float lerp8(const float k[8], float fx, float fy, float fz) {
  const float c00 = k[0] + (k[1] - k[0]) * fx;
  const float c10 = k[2] + (k[3] - k[2]) * fx;
  const float c01 = k[4] + (k[5] - k[4]) * fx;
  const float c11 = k[6] + (k[7] - k[6]) * fx;
  const float c0 = c00 + (c10 - c00) * fy;
  const float c1 = c01 + (c11 - c01) * fy;
  return c0 + (c1 - c0) * fz;
}

// gi._decode_grid_u8 of one rgb level
__device__ __forceinline__ float decode_rgb(unsigned int q) {
  const float s = (float)q * kInv255;
  const float c2 = s * s;
  return c2 / fmaxf(1.0f - c2, 1.0f / 256.0f);
}

// a level (0..255) as f32, exactly: the level in the low mantissa bits of 2^23
__device__ __forceinline__ float level_f32(unsigned int q) {
  return __uint_as_float(0x4B000000u | q) - 8388608.0f;
}

// The 8 corners (layout dz*4+dy*2+dx) and fractionals of a trilinear fetch
// of the u8 table at uvw (sampling.sample_trilinear_table).
struct Corners {
  unsigned int c[8];
  float fx, fy, fz;

  template <class A>
  __device__ __forceinline__ void load(const A& a, float u, float v, float w) {
    const float x = u * (float)a.gw - 0.5f;
    const float y = v * (float)a.gh - 0.5f;
    const float z = w * (float)a.gd - 0.5f;
    const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
    fx = window_frac(x, x0f);
    fy = window_frac(y, y0f);
    fz = window_frac(z, z0f);
    const int ix = clamp_index(x0f, a.gw), iy = clamp_index(y0f, a.gh);
    const int iz = clamp_index(z0f, a.gd);
    const int cell = (iz * a.gh + iy) * a.gw + ix;
    const int dy = iy + 1 < a.gh ? a.gw : 0;
    const int dz = iz + 1 < a.gd ? a.gh * a.gw : 0;
    const int dx = ix + 1 < a.gw ? 1 : 0;
    const unsigned int* t = reinterpret_cast<const unsigned int*>(a.table);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int off = ((k & 1) ? dx : 0) + ((k & 2) ? dy : 0) + ((k & 4) ? dz : 0);
      c[k] = __ldg(t + cell + off);
    }
  }

  // load() on a table of G x G x G texels (G a compile-time size: the
  // index math folds, and off the table's upper faces the 8 words lie at
  // constant offsets from the cell's; on them, load()'s clamped offsets)
  template <int G, class A>
  __device__ __forceinline__ void load_cube(const A& a, float u, float v, float w) {
    const float x = u * (float)G - 0.5f;
    const float y = v * (float)G - 0.5f;
    const float z = w * (float)G - 0.5f;
    const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
    fx = window_frac(x, x0f);
    fy = window_frac(y, y0f);
    fz = window_frac(z, z0f);
    // clamp_index without its integer clamp, which the float clamp makes a
    // no-op (a NaN clamps to 0)
    const int ix = (int)fminf(fmaxf(x0f, 0.0f), (float)(G - 1));
    const int iy = (int)fminf(fmaxf(y0f, 0.0f), (float)(G - 1));
    const int iz = (int)fminf(fmaxf(z0f, 0.0f), (float)(G - 1));
    const unsigned int* t =
        reinterpret_cast<const unsigned int*>(a.table) + ((iz * G + iy) * G + ix);
    if (max(ix, max(iy, iz)) < G - 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c[k] = __ldg(t + ((k & 1) ? 1 : 0) + ((k & 2) ? G : 0) + ((k & 4) ? G * G : 0));
    } else {
      const int dx = ix + 1 < G ? 1 : 0, dy = iy + 1 < G ? G : 0;
      const int dz = iz + 1 < G ? G * G : 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        c[k] = __ldg(t + (((k & 1) ? dx : 0) + ((k & 2) ? dy : 0) + ((k & 4) ? dz : 0)));
    }
  }

  __device__ __forceinline__ float alpha() const {
    float k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = level_f32(c[i] >> 24) * kInv255;
    return lerp8(k, fx, fy, fz);
  }

  // decode: the rgb decode of the 256 levels (decode_rgb), in shared memory
  __device__ __forceinline__ void rgb(const float* decode, float out[3]) const {
    float k[8];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int i = 0; i < 8; ++i) k[i] = decode[(c[i] >> (8 * ch)) & 0xFFu];
      out[ch] = lerp8(k, fx, fy, fz);
    }
  }
};

// utils/color.py::tone_compress_sqrt
__device__ __forceinline__ void tone_compress(const float m[3], float out[3]) {
  const float lum = (0.299f * m[0] + 0.587f * m[1]) + 0.114f * m[2];
  const float sq = sqrtf(fmaxf(lum, 0.0f));
  const float den = fmaxf(lum, 1e-4f);
  for (int c = 0; c < 3; ++c) out[c] = m[c] * sq / den;
}

// m3.transform_points, row i: (x*m0 + y*m1) + (z*m2 + m3)
__device__ __forceinline__ float xform(const float* m, int i, float x, float y, float z) {
  return (x * m[4 * i] + y * m[4 * i + 1]) + (z * m[4 * i + 2] + m[4 * i + 3]);
}

// sampling.sample_nearest of the trace table (a -0.0 texel reads +0.0)
template <class A>
__device__ __forceinline__ float depth_nearest(const A& a, float u, float v) {
  const int ix = clamp_index(floorf(u * (float)a.tw), a.tw);
  const int iy = clamp_index(floorf(v * (float)a.th), a.th);
  return __ldg(a.depth + (iy * a.tw + ix)) + 0.0f;
}

// a bf16 texel widened to f32 (exact)
template <class A>
__device__ __forceinline__ float bf16_at(const A& a, int i) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(a.atlas) + i);
  return __uint_as_float((unsigned int)bits << 16);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One level of sampling.sample_mip_atlas: bilinear, clamp addressing, the
// texel differences rounded to bf16 as bf16 tensors subtract.  level_off:
// each level's first column in the atlas.
template <class A>
__device__ void atlas_level(const A& a, const int* level_off, int lv, float u, float v,
                            float out[3]) {
  const int off = level_off[lv];
  const int lh = max(1, a.prev_h >> lv), lw = max(1, a.prev_w >> lv);
  const float x = u * (float)lw - 0.5f, y = v * (float)lh - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int ya = min(max(y0, 0), lh - 1), yb = min(max(y0 + 1, 0), lh - 1);
  const int xa = min(max(x0, 0), lw - 1), xb = min(max(x0 + 1, 0), lw - 1);
  const int i00 = (ya * a.atlas_wa + off + xa) * 3, i10 = (ya * a.atlas_wa + off + xb) * 3;
  const int i01 = (yb * a.atlas_wa + off + xa) * 3, i11 = (yb * a.atlas_wa + off + xb) * 3;
  for (int c = 0; c < 3; ++c) {
    const float t00 = bf16_at(a, i00 + c), t10 = bf16_at(a, i10 + c);
    const float t01 = bf16_at(a, i01 + c), t11 = bf16_at(a, i11 + c);
    const float top = t00 + bf16_round(t10 - t00) * fx;
    const float bot = t01 + bf16_round(t11 - t01) * fx;
    out[c] = top + (bot - top) * fy;
  }
}

// The previous frame's pyramid at (u, v), lod min(5 * slen, 5) clamped to
// its levels, times ss_intensity (gi.sample_radiance_with_screen_trace's
// and fast_ray_resolve_plain's resolve).
template <class A>
__device__ __forceinline__ void pyramid_resolve(const A& a, const int* level_off, float slen,
                                                float u, float v, float ss_intensity,
                                                float out[3]) {
  const int levels = a.prev_levels;
  const float lod = fminf(fmaxf(fminf(slen * 5.0f, 5.0f), 0.0f), (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const int l1 = min(l0 + 1, levels - 1);
  const float fl = lod - (float)l0;
  float s0[3], s1[3];
  atlas_level(a, level_off, l0, u, v, s0);
  atlas_level(a, level_off, l1, u, v, s1);
  for (int c = 0; c < 3; ++c) out[c] = (s0[c] + (s1[c] - s0[c]) * fl) * ss_intensity;
}

// The flat lane of slot `slot` (0..31) of lane tile t, or -1 past the edge
// (gi.lane_tiles): tiles of tile_h x (32 / tile_h) lanes over a grid of rows
// of `width` lanes, n lanes in all.
__device__ __forceinline__ int tile_lane(int n, int width, int tile_h, int t, int slot,
                                         int tiles_x) {
  const int tw = 32 / tile_h;
  const int row = (t / tiles_x) * tile_h + slot / tw;
  const int col = (t % tiles_x) * tw + slot % tw;
  const int lane = row * width + col;
  return col < width && lane < n ? lane : -1;
}

}  // namespace
