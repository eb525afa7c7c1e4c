// The fast-GI ray kernel's variants and probes, for gi_sweep.py alone.
//
// This is vulkan_pbr_renderer_tpu_torch/csrc/gi_fast_ray.cu (which the
// package builds; its header explains the kernel) with the designs that
// gi_sweep.py measured and did not keep, and two diagnostics, as
// compile-time forks.  With no -D value it computes what that kernel
// computes, in the same way, on the same RayArgs (shade/gi.py::_RayArgs).
//
// Variants: GI_THREADS, GI_MIN_BLOCKS (__launch_bounds__' blocks per SM, 0
// none), GI_PERSISTENT (0, the default: one tile per warp, a grid over all
// tiles; 1: a persistent grid of the resident blocks whose warps each take
// their next tile from a device counter; 2: the same, a block taking kWarps
// tiles at a time; the grid's last warp sets the counter back to 0), GI_LUT
// (0: the divide in every corner's decode, as the first design did),
// GI_PAIRED (1: gi_sweep.pair_table_x's [D,H,W,8] table, a texel beside its
// +x neighbour, so a fetch's 8 corners are 4 loads of 8 bytes).
// Diagnostics: GI_PROBE_FULL (a stopped lane keeps fetching at its frozen
// position until every loop's budget is spent; the results stay the same)
// and GI_PROBE_FIXED (every corner load reads the table's first texel; the
// results change).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef GI_THREADS
#define GI_THREADS 128
#endif
#ifndef GI_MIN_BLOCKS
#define GI_MIN_BLOCKS 0
#endif
#ifndef GI_PERSISTENT
#define GI_PERSISTENT 0
#endif
#ifndef GI_LUT
#define GI_LUT 1
#endif
#ifndef GI_PAIRED
#define GI_PAIRED 0
#endif

#ifndef GI_PROBE_FULL
#define GI_PROBE_FULL 0
#endif
#ifndef GI_PROBE_FIXED
#define GI_PROBE_FIXED 0
#endif

namespace {

constexpr int kThreads = GI_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;                   // the pyramid's levels (checked by the wrapper)
constexpr bool kProbeFull = GI_PROBE_FULL != 0;
constexpr float kHitThresh = 0.3f;               // sample_radiance_fog's hit_thresh
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kInv100 = 1.0f / 100.0f;

}  // namespace

// shade/gi.py::_RayArgs mirrors this struct field for field.
struct RayArgs {
  const unsigned char* table;          // [D,H,W,4] u8 levels
  const __half* fgrid;                 // [D,H,W,4] f16 (nearest march) or null
  const float* depth;                  // [th,tw] trace table
  const __nv_bfloat16* atlas;          // [>=prev_h, atlas_wa, 3] previous-frame pyramid
  const float* view_from_world;        // [4,4] row-major
  const float* clip_from_view;
  const float* world_from_view;
  const float* camera_pos;             // [3]
  const float* pw;                     // [n,3] world position
  const float* rd;                     // [n,3] unit ray direction
  const float* pv;                     // [n,3] view position
  const float* noise;                  // [n]
  const float* fog_lane;               // [n] per-lane foggyness, or null: `fog`
  float* out_rgb;                      // [n,3]
  int* out_status;                     // [n]
  float fog, scale, inv_scale, voxel, voxel_step, open_thresh, step_scale, jitter_scale,
      ss_intensity, half_scale;
  int n, gd, gh, gw, th, tw, atlas_wa, prev_h, prev_w, prev_levels, skip_steps, march_steps,
      screen, trace_steps, trace_rounds, trace_steps2, solid_taps;
  int width;                           // lanes per row of the lane grid (n for 1-D lanes)
  int tile_h;                          // rows of a warp's lane tile: 1, 2, 4, 8, 16 or 32
};

namespace {

// the persistent grid's counter: [0] tiles taken, [1] warps done; 0 at
// load and after every launch
__device__ int g_counter[2];

// What a block keeps in shared memory: view_from_world, clip_from_view,
// world_from_view, the camera position, the pyramid's level offsets and the
// rgb decode of every u8 level.
struct Shared {
  float mats[51];
  int level_off[kMaxLevels];
  float decode[256];
  int next_tile;                       // the block's next tiles (GI_PERSISTENT 2)
};

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
// of the u8 table at uvw (sampling.sample_trilinear_table).  With
// GI_PAIRED the table is gi_sweep.pair_table_x's [D,H,W,8]: a texel beside its
// +x neighbour, so the 8 corners are 4 loads of 8 bytes.
struct Corners {
  unsigned int c[8];
  float fx, fy, fz;

  __device__ __forceinline__ void load(const RayArgs& a, float u, float v, float w) {
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
    if (GI_PAIRED) {
      const uint2* t = reinterpret_cast<const uint2*>(a.table);
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const int off = ((k & 2) ? dy : 0) + ((k & 4) ? dz : 0);
        const uint2 pair = __ldg(GI_PROBE_FIXED ? t : t + cell + off);
        c[k] = pair.x;
        c[k + 1] = pair.y;
      }
      return;
    }
    const int dx = ix + 1 < a.gw ? 1 : 0;
    const unsigned int* t = reinterpret_cast<const unsigned int*>(a.table);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int off = ((k & 1) ? dx : 0) + ((k & 2) ? dy : 0) + ((k & 4) ? dz : 0);
      c[k] = __ldg(GI_PROBE_FIXED ? t : t + cell + off);
    }
  }

  __device__ __forceinline__ float alpha() const {
    float k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = level_f32(c[i] >> 24) * kInv255;
    return lerp8(k, fx, fy, fz);
  }

  __device__ __forceinline__ void rgb(const Shared& sm, float out[3]) const {
    float k[8];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned int q = (c[i] >> (8 * ch)) & 0xFFu;
        k[i] = GI_LUT ? sm.decode[q] : decode_rgb(q);
      }
      out[ch] = lerp8(k, fx, fy, fz);
    }
  }
};

// One fog-march sample at grid-NDC p (uvw = p*0.5+0.5): trilinear from the
// u8 table, or nearest (truncating, gi._sample_nearest_grid) from the f16 grid.
template <bool kNearest>
struct MarchTap {
  Corners corners;
  float v[4];

  __device__ __forceinline__ float alpha(const RayArgs& a, float px, float py, float pz) {
    const float u = px * 0.5f + 0.5f, vv = py * 0.5f + 0.5f, w = pz * 0.5f + 0.5f;
    if (kNearest) {
      const int iz = clamp_index(truncf(w * (float)a.gd), a.gd);
      const int iy = clamp_index(truncf(vv * (float)a.gh), a.gh);
      const int ix = clamp_index(truncf(u * (float)a.gw), a.gw);
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(a.fgrid) + ((iz * a.gh + iy) * a.gw + ix));
      v[0] = __half2float(__ushort_as_half((unsigned short)(raw.x & 0xFFFFu)));
      v[1] = __half2float(__ushort_as_half((unsigned short)(raw.x >> 16)));
      v[2] = __half2float(__ushort_as_half((unsigned short)(raw.y & 0xFFFFu)));
      v[3] = __half2float(__ushort_as_half((unsigned short)(raw.y >> 16)));
      return v[3];
    }
    corners.load(a, u, vv, w);
    return corners.alpha();
  }

  __device__ __forceinline__ void rgb(const Shared& sm, float out[3]) const {
    if (kNearest) {
      out[0] = v[0];
      out[1] = v[1];
      out[2] = v[2];
    } else {
      corners.rgb(sm, out);
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
__device__ __forceinline__ float depth_nearest(const RayArgs& a, float u, float v) {
  const int ix = clamp_index(floorf(u * (float)a.tw), a.tw);
  const int iy = clamp_index(floorf(v * (float)a.th), a.th);
  return __ldg(a.depth + (iy * a.tw + ix)) + 0.0f;
}

// a bf16 texel widened to f32 (exact)
__device__ __forceinline__ float bf16_at(const RayArgs& a, int i) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(a.atlas) + i);
  return __uint_as_float((unsigned int)bits << 16);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One level of sampling.sample_mip_atlas: bilinear, clamp addressing, the
// texel differences rounded to bf16 as bf16 tensors subtract.
__device__ void atlas_level(const RayArgs& a, const Shared& sm, int lv, float u, float v,
                            float out[3]) {
  const int off = sm.level_off[lv];
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

// screen_trace_linear's solidity tap fractions for 1, 2 or 3 taps
__device__ __forceinline__ float tap_frac(int taps, int k) {
  if (taps == 3) return k == 0 ? 0.2f : k == 1 ? 0.4f : 0.6f;
  if (taps == 1) return 0.4f;
  return k == 0 ? 0.3f : 0.5f;
}

// The ray of one lane: fast_ray_resolve_plain's rgb and status.
template <bool kNearest>
__device__ void ray(const RayArgs& a, const Shared& sm, int lane) {
  const float* vfw = sm.mats;
  const float* cfv = sm.mats + 16;
  const float* wfv = sm.mats + 32;
  const float* cam = sm.mats + 48;
  float sink = 0.0f;   // GI_PROBE_FULL: what a stopped lane fetched

  const float pw[3] = {a.pw[3 * lane], a.pw[3 * lane + 1], a.pw[3 * lane + 2]};
  const float noise = a.noise[lane];
  const float fog = a.fog_lane != nullptr ? a.fog_lane[lane] : a.fog;
  float rd[3], ro[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = a.rd[3 * lane + c] * a.voxel;
    ro[c] = pw[c] * a.scale;
  }

  // -- fog march (gi.sample_radiance_fog): skip the initial blockage
  MarchTap<kNearest> tap;
  bool found = false;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < a.skip_steps; ++i) {
    if (found) {
      if (!kProbeFull) break;
      sink += tap.alpha(a, ro[0], ro[1], ro[2]);
      continue;
    }
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rd[c];
    if (tap.alpha(a, ro[0], ro[1], ro[2]) < a.open_thresh) {
      tap.rgb(sm, sum);
      found = true;
    }
  }
  const float ro_open[3] = {ro[0], ro[1], ro[2]};
  sum[3] = (found ? 1.0f : 0.0f) + 1e-4f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (found || kProbeFull) {
    float rdm[3];
    const float jit = a.jitter_scale * noise;
    for (int c = 0; c < 3; ++c) {
      rdm[c] = rd[c] * a.step_scale;
      ro[c] = ro_open[c] + rdm[c] * jit;
    }
    bool live = found;
    for (int i = 0; i < a.march_steps; ++i) {
      if (!live) {
        if (!kProbeFull) break;
        sink += tap.alpha(a, ro[0], ro[1], ro[2]);
        continue;
      }
      for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rdm[c];
      if (tap.alpha(a, ro[0], ro[1], ro[2]) > kHitThresh) {
        live = false;
        continue;
      }
      float s[3];
      tap.rgb(sm, s);
      for (int c = 0; c < 3; ++c) sum[c] = sum[c] * fog + s[c];
      sum[3] = sum[3] * fog + 1.0f;
    }
    if (found) {
      const float w = fmaxf(sum[3], 1e-4f);
      const float mean[3] = {sum[0] / w, sum[1] / w, sum[2] / w};
      tone_compress(mean, rgb);
    }
  }

  int status = 2;
  if (a.screen) {
    // -- the linear screen trace (gi.screen_trace_linear) toward the open point
    const float p0[3] = {a.pv[3 * lane], a.pv[3 * lane + 1], a.pv[3 * lane + 2]};
    const float q[3] = {ro_open[0] * a.inv_scale, ro_open[1] * a.inv_scale,
                        ro_open[2] * a.inv_scale};
    float to[3];
    for (int c = 0; c < 3; ++c) to[c] = xform(vfw, c, q[0], q[1], q[2]) - p0[c];
    const float step_len0 = fmaxf(p0[2], 1.0f) * (1.0f + noise) * kInv100;
    const float xy_len = fmaxf(sqrtf(to[0] * to[0] + to[1] * to[1]), 1e-8f);
    const float sd[3] = {to[0] / xy_len, to[1] / xy_len, to[2] / xy_len};
    const float dist = sqrtf((to[0] * to[0] + to[1] * to[1]) + to[2] * to[2]);
    const float p00 = cfv[0], p11 = cfv[5], p22 = cfv[10], p23 = cfv[11];
    const float inv00 = 1.0f / (p00 * p00), inv11 = 1.0f / (p11 * p11);
    const float c0x = p00 * p0[0], cdx = p00 * sd[0];
    const float c0y = p11 * p0[1], cdy = p11 * sd[1];
    const float c0w = p0[2], cdw = sd[2];
    const float a2 = (p0[0] * p0[0] + p0[1] * p0[1]) + p0[2] * p0[2];
    const float b2 = 2.0f * ((p0[0] * sd[0] + p0[1] * sd[1]) + p0[2] * sd[2]);
    const float c2 = (sd[0] * sd[0] + sd[1] * sd[1]) + sd[2] * sd[2];
    const float noff = noise * 0.2f;
    float slen = step_len0, trav = 0.0f, res_u = 0.0f, res_v = 0.0f, res_d = 1.0f;
    // 0 marching, 1 off screen, 2 exhausted, 3 resolved, 4 crossing pending
    status = 0;
    const int rounds = max(a.trace_rounds, 1);
    for (int r = 0; r < rounds; ++r) {
      if (status != 0 && !kProbeFull) break;
      const int steps = r == 0 ? a.trace_steps : a.trace_steps2;
      for (int i = 0; i < steps; ++i) {
        const bool live = status == 0;
        if (!live && !kProbeFull) break;
        const float s = trav + slen;
        const float cx = c0x + s * cdx, cy = c0y + s * cdy, cw = c0w + s * cdw;
        const float iw = 1.0f / (fabsf(cw) < 1e-8f ? 1e-8f : cw);
        const float nx = cx * iw, ny = cy * iw;
        const float u = nx * 0.5f + 0.5f, v = ny * 0.5f + 0.5f;
        if (!live) {
          sink += depth_nearest(a, u, v);
          continue;
        }
        trav = s;
        slen = slen * 1.2f;
        if (fmaxf(fabsf(nx), fabsf(ny)) > 1.0f) {
          status = 1;
          continue;
        }
        const float d = depth_nearest(a, u, v);
        const float zv = p23 / (d - p22);
        const float surf2 = (zv * zv) * (((nx * nx) * inv00 + (ny * ny) * inv11) + 1.0f);
        const float pos2 = a2 + (b2 + c2 * s) * s;
        if (surf2 < pos2) {
          status = 4;
          res_u = u;
          res_v = v;
          res_d = d;
        } else if (s > dist) {
          status = 2;
        }
      }
      if (status != 4 && !kProbeFull) continue;
      // solidity of the crossing: alpha taps between the surface and the ray
      const float pos[3] = {p0[0] + sd[0] * trav, p0[1] + sd[1] * trav, p0[2] + sd[2] * trav};
      const float rzv = p23 / (res_d - p22);
      const float surf[3] = {((res_u * 2.0f - 1.0f) * rzv) / p00,
                             ((res_v * 2.0f - 1.0f) * rzv) / p11, rzv};
      float t0[3], t1[3];
      for (int c = 0; c < 3; ++c) {
        t0[c] = xform(wfv, c, surf[0], surf[1], surf[2]) * a.half_scale + 0.5f;
        t1[c] = xform(wfv, c, pos[0], pos[1], pos[2]) * a.half_scale + 0.5f;
      }
      const int taps = a.solid_taps >= 3 ? 3 : a.solid_taps == 1 ? 1 : 2;
      float asum = 0.0f;
      for (int k = 0; k < taps; ++k) {
        const float f = noff + tap_frac(taps, k);
        Corners cs;
        cs.load(a, t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                t0[2] + (t1[2] - t0[2]) * f);
        asum = asum + cs.alpha();
      }
      if (status != 4) {
        sink += asum;
      } else if (asum >= 0.5f * (float)taps) {
        status = 3;
      } else {
        status = 0;
        slen = slen * (2.0f + noise);
      }
    }
    if (status == 0) status = 2;   // still marching at the budget: the march result

    if (status == 1 || kProbeFull) {
      // the lightgrid 2.5 voxels camera-ward (m3.normalize, gi.grid_sample);
      // torch.linalg.vector_norm over a last dim of 3 sums (x^2 + z^2) + y^2
      // on the card (measured on the H100)
      const float vc[3] = {cam[0] - pw[0], cam[1] - pw[1], cam[2] - pw[2]};
      const float nrm = fmaxf(sqrtf((vc[0] * vc[0] + vc[2] * vc[2]) + vc[1] * vc[1]), 1e-12f);
      float p[3];
      for (int c = 0; c < 3; ++c) p[c] = pw[c] * a.scale + (2.5f * (vc[c] / nrm)) * a.voxel_step;
      Corners cs;
      cs.load(a, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
      float fb[3];
      cs.rgb(sm, fb);
      if (status == 1) {
        tone_compress(fb, rgb);
      } else {
        sink += fb[0];
      }
    }
    if (status == 3 || kProbeFull) {
      // the previous frame's pyramid at the crossing, lod min(5*step, 5)
      const int levels = a.prev_levels;
      const float lod = fminf(fmaxf(fminf(slen * 5.0f, 5.0f), 0.0f), (float)(levels - 1));
      const int l0 = (int)floorf(lod);
      const int l1 = min(l0 + 1, levels - 1);
      const float fl = lod - (float)l0;
      float s0[3], s1[3];
      atlas_level(a, sm, l0, res_u, res_v, s0);
      atlas_level(a, sm, l1, res_u, res_v, s1);
      for (int c = 0; c < 3; ++c) {
        const float value = (s0[c] + (s1[c] - s0[c]) * fl) * a.ss_intensity;
        if (status == 3) {
          rgb[c] = value;
        } else {
          sink += value;
        }
      }
    }
  }
  // a sum of finite fetches never has this NaN's bits: the probe's fetches
  // stay in the program, and the output does not change
  if (kProbeFull && __float_as_uint(sink) == 0x7FC0DEADu) status = -1;
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
}

// A warp of the persistent grid is done: the grid's last warp sets the
// counter (counter[0] tiles taken, counter[1] warps done) back to 0 for the
// next launch on the stream.
__device__ __forceinline__ void finish_grid(int* counter, int warps, int slot) {
  if (slot != 0) return;
  __threadfence();
  if (atomicAdd(counter + 1, 1) == warps - 1) {
    atomicExch(counter, 0);
    atomicExch(counter + 1, 0);
  }
}

// The flat lane of slot `slot` (0..31) of lane tile t, or -1 past the edge
// (gi.lane_tiles).
__device__ __forceinline__ int tile_lane(const RayArgs& a, int t, int slot, int tiles_x) {
  const int tw = 32 / a.tile_h;
  const int row = (t / tiles_x) * a.tile_h + slot / tw;
  const int col = (t % tiles_x) * tw + slot % tw;
  const int lane = row * a.width + col;
  return col < a.width && lane < a.n ? lane : -1;
}

#if GI_MIN_BLOCKS > 0
#define GI_BOUNDS __launch_bounds__(kThreads, GI_MIN_BLOCKS)
#else
#define GI_BOUNDS __launch_bounds__(kThreads)
#endif

template <bool kNearest>
__global__ void GI_BOUNDS gi_fast_ray_kernel(const RayArgs a) {
  __shared__ Shared sm;
  const int tid = threadIdx.x;
  if (tid < 16) {
    sm.mats[tid] = a.view_from_world[tid];
    sm.mats[16 + tid] = a.clip_from_view[tid];
    sm.mats[32 + tid] = a.world_from_view[tid];
  } else if (tid < 19) {
    sm.mats[48 + tid - 16] = a.camera_pos[tid - 16];
  }
  if (tid < kMaxLevels) {
    int off = 0;
    for (int j = 0; j < tid; ++j) off += max(1, a.prev_w >> j);
    sm.level_off[tid] = off;
  }
  for (int q = tid; q < 256; q += kThreads) sm.decode[q] = decode_rgb(q);
  __syncthreads();

  const int slot = tid & 31;
  const int tiles_x = (a.width + 32 / a.tile_h - 1) / (32 / a.tile_h);
  const int tiles = tiles_x * ((a.n / a.width + a.tile_h - 1) / a.tile_h);
#if GI_PERSISTENT
  const int warps = gridDim.x * kWarps;
#endif
#if GI_PERSISTENT == 2
  // the block's warps take kWarps neighbouring tiles, one each; when all
  // are done the block takes the next kWarps from the counter (asked for
  // before the tiles run).  The first kWarps are the block's own.
  int base = blockIdx.x * kWarps;
  while (base < tiles) {
    int next = 0;
    if (tid == 0) next = warps + atomicAdd(g_counter, kWarps);
    const int t = base + (tid >> 5);
    const int lane = t < tiles ? tile_lane(a, t, slot, tiles_x) : -1;
    if (lane >= 0) ray<kNearest>(a, sm, lane);
    __syncthreads();
    if (tid == 0) sm.next_tile = next;
    __syncthreads();
    base = sm.next_tile;
  }
  finish_grid(g_counter, warps, slot);
#elif GI_PERSISTENT == 1
  // each warp takes its next tile from the counter when its lanes are done
  int t = blockIdx.x * kWarps + (tid >> 5);
  while (t < tiles) {
    int next = 0;
    if (slot == 0) next = warps + atomicAdd(g_counter, 1);
    const int lane = tile_lane(a, t, slot, tiles_x);
    if (lane >= 0) ray<kNearest>(a, sm, lane);
    t = __shfl_sync(0xFFFFFFFFu, next, 0);
  }
  finish_grid(g_counter, warps, slot);
#else
  // one tile per warp, a grid over all tiles
  const int t = blockIdx.x * kWarps + (tid >> 5);
  const int lane = t < tiles ? tile_lane(a, t, slot, tiles_x) : -1;
  if (lane >= 0) ray<kNearest>(a, sm, lane);
#endif
}

template <bool kNearest>
int launch(const RayArgs& a, cudaStream_t stream) {
  const int tw = 32 / a.tile_h;
  const long long tiles = (long long)((a.width + tw - 1) / tw) *
                          ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  int grid = (int)((tiles + kWarps - 1) / kWarps);
#if GI_PERSISTENT
  static int resident[64] = {0};   // resident blocks of the card, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gi_fast_ray_kernel<kNearest>,
                                                  kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident[dev] = max(1, per_sm * sms);
  }
  grid = min(grid, dev < 64 ? resident[dev] : grid);
#endif
  gi_fast_ray_kernel<kNearest><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gi_fast_ray_launch(const RayArgs* args, void* stream) {
  const RayArgs& a = *args;
  if (a.n <= 0) return (int)cudaGetLastError();
  return a.fgrid != nullptr ? launch<true>(a, (cudaStream_t)stream)
                            : launch<false>(a, (cudaStream_t)stream);
}

// The compiled kernel's registers a thread and resident blocks an SM (the
// trilinear march's kernel; the nearest one's are alike), for chip_smoke.py.
extern "C" int gi_fast_ray_occupancy(int* registers, int* blocks_per_sm, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gi_fast_ray_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gi_fast_ray_kernel<false>, kThreads, 0);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
