// The fast GI's probe and hierarchical-z screen terms and its economy mode
// for Hopper (sm_90a): one thread per lane, two kernels.
//
// gi_screen_ray replaces the per-lane loops of the JAX package's fast GI
// with gi_fast_screen_mode "probes" or "hiz", which XLA runs inside the
// jitted frame: the fog march vulkan_pbr_renderer_tpu/shade/gi.py:398
// sample_radiance_fog, then the screen term of gi_modes.py:292-354 over the
// segment [surface, first open] in grid NDC ([surface, march stop] with
// to_stop): "probes" gi.py:806 screen_probe_multi (K points at the host's
// fractions, dithered by noise, an off-screen point ending the search, the
// first point behind the probe depth resolving, optionally only where
// solidity taps between it and the surface reach 0.5 alpha each), the
// overshoot and the edge fallback into the lightgrid; "hiz" gi.py:1391
// screen_trace_hiz (the segment clipped at w = 1e-3, gi.py:1258 hiz_trace's
// walk of hiz_iters rounds over the min-depth pyramid, the optional
// solidity tap at the perspective-correct hit, the end-point fallback).
// gi_probe_ray replaces gi_modes.py:403 fast_probe_gi's ray: gi.py:648
// sample_radiance_fast (the blockage skip on the alpha levels, then
// `samples` openness-weighted samples past the open point), gi.py:778
// march_to_hit, and the probe from the surface on the full-resolution depth
// (screen_probe_multi of k_points points, or gi.py:1470 screen_probe).  Both
// compute shade/gi.py::screen_ray_resolve_plain: rgb [N,3] f32 and the
// status [N] i32 (1 the edge fallback, 3 resolved on screen, 2 the march).
//
// The previous frame.  The reference package samples it from an f16 window
// pack of the bf16 pyramid (gi_modes.py:147 _probe_prev_setup): one level
// (prev_h >> probe_level texels) with edge clamping, or with dist_mip > 0
// the whole atlas at a per-lane level round(distance * dist_mip).  The
// kernels read the bf16 atlas and round each texel to f16 as the pack does
// (values past 65504 become inf, subnormals lose bits); no pack is built.
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// version's operation order on the card.  Where the plain version divides
// a tensor by a Python number, PyTorch multiplies by the number's f32
// reciprocal; where it divides a Python number by a tensor, it multiplies
// the tensor's true reciprocal by the number (Tensor.__rtruediv__): the
// kernels do the same (inv_scale, inv_seg_scale, inv_hiz_w / inv_hiz_h;
// hi-z's eps_t, first t and view-space z).  The host computes every
// fraction in double and rounds it to f32 once, as PyTorch does with a
// Python number (the probe fractions, the tap fractions, the quadrature's
// offsets).  torch.round is rintf (half to even); torch.exp2 is exp2f.
//
// What bounds it.  Path F's and G's rays have 261,120 lanes at 1920x1088
// (the interleave's half of a 960x544 GI grid), path E's 522,240; each
// lane's steps wait on their own dependent gathers, as in gi_fast_ray.cu.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gi_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;     // the previous-frame pyramid's levels (checked by the wrapper)
constexpr int kMaxPoints = 16;     // probe points
constexpr int kMaxTaps = 8;        // solidity taps a probe point
constexpr int kMaxSamples = 8;     // the quadrature's samples
constexpr int kHizLevels = 6;      // hiz_trace's levels 0..5 (max_level 5)

// the screen term
constexpr int kTermNone = 0, kTermProbes = 1, kTermHiz = 2, kTermProbe = 3;

}  // namespace

// shade/gi.py::_ScreenArgs mirrors this struct field for field.
struct ScreenArgs {
  const unsigned char* table;          // [D,H,W,4] u8 levels
  const __half* fgrid;                 // [D,H,W,4] f16 (nearest fog march) or null
  const float* depth;                  // [th,tw] probe depth, or the [th,tw] hi-z atlas
  const __nv_bfloat16* atlas;          // [atlas_h, atlas_wa, 3] previous-frame pyramid
  const float* clip_from_world;        // [4,4] row-major
  const float* world_from_clip;
  const float* view_from_world;
  const float* camera_pos;             // [3]
  const float* pw;                     // [n,3] world position
  const float* rd;                     // [n,3] unit ray direction
  const float* noise;                  // [n] (gi_screen_ray)
  const float* fog_lane;               // [n] per-lane foggyness, or null: `fog`
  float* out_rgb;                      // [n,3]
  int* out_status;                     // [n]
  float fog, scale, inv_scale, voxel, open_thresh, step_scale, jitter_scale, ss_intensity,
      hit_step, fb_step, z_margin, jitter_k, overshoot, dist_mip, inv_seg_scale,
      hiz_thickness, hiz_bias, hiz_solid, zv_num, zv_far, zv_span, inv_hiz_w, inv_hiz_h,
      taps_half;
  float fracs[kMaxPoints];             // the probe points' fractions
  float tap_fracs[kMaxTaps];           // t / (taps + 1), t = 1..taps
  float sample_off[kMaxSamples];       // the quadrature's offsets in steps
  int n, gd, gh, gw, th, tw, atlas_h, atlas_wa, prev_h, prev_w, prev_levels, plh, plw,
      level_off, skip_steps, march_steps, samples, term, to_stop, edge_fallback, k_points,
      solid_taps, jitter, hiz_iters, hiz_h, hiz_w;
  int width;                           // lanes per row of the lane grid (n for 1-D lanes)
  int tile_h;                          // rows of a warp's lane tile: 1, 2, 4, 8, 16 or 32
};

namespace {

// What a block keeps in shared memory: clip_from_world, world_from_clip,
// view_from_world, the camera position, the pyramid's and the hi-z
// atlas's level offsets and the rgb decode of every u8 level.
struct Shared {
  float mats[51];
  int level_off[kMaxLevels];
  int hiz_off[kHizLevels];
  float decode[256];
};

// (ndc, w) of p under m (m3.transform_points), |w| < 1e-8 divided as 1e-8
__device__ __forceinline__ float project(const float* m, float x, float y, float z,
                                         float ndc[3]) {
  const float w = xform(m, 3, x, y, z);
  const float d = fabsf(w) < 1e-8f ? 1e-8f : w;
  for (int c = 0; c < 3; ++c) ndc[c] = xform(m, c, x, y, z) / d;
  return w;
}

// A texel of the previous frame as the f16 window pack holds it
__device__ __forceinline__ float prev16(const ScreenArgs& a, int i) {
  return __half2float(__float2half_rn(bf16_at(a, i)));
}

__device__ __forceinline__ void bilerp(const ScreenArgs& a, int i00, int i10, int i01, int i11,
                                       float fx, float fy, float out[3]) {
  for (int c = 0; c < 3; ++c) {
    const float t00 = prev16(a, i00 + c), t10 = prev16(a, i10 + c);
    const float t01 = prev16(a, i01 + c), t11 = prev16(a, i11 + c);
    const float top = t00 + (t10 - t00) * fx;
    const float bot = t01 + (t11 - t01) * fx;
    out[c] = (top + (bot - top) * fy) * a.ss_intensity;
  }
}

// sampling.sample_bilinear_window of the probe level's pack at (u, v),
// times ss_intensity
__device__ void prev_level(const ScreenArgs& a, float u, float v, float out[3]) {
  const float x = u * (float)a.plw - 0.5f, y = v * (float)a.plh - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x0f < 0.0f ? 0.0f : x - x0f;
  const float fy = y0f < 0.0f ? 0.0f : y - y0f;
  const int ix = min(max((int)x0f, 0), a.plw - 1), iy = min(max((int)y0f, 0), a.plh - 1);
  const int ix1 = min(ix + 1, a.plw - 1), iy1 = min(iy + 1, a.plh - 1);
  const int c0 = a.level_off + ix, c1 = a.level_off + ix1;
  bilerp(a, (iy * a.atlas_wa + c0) * 3, (iy * a.atlas_wa + c1) * 3, (iy1 * a.atlas_wa + c0) * 3,
         (iy1 * a.atlas_wa + c1) * 3, fx, fy, out);
}

// sampling.sample_screen_atlas_window of the whole pyramid's pack at level
// `level` (clamped), times ss_intensity
__device__ void prev_at_level(const ScreenArgs& a, const int* level_off, int level, float u,
                              float v, float out[3]) {
  const int lv = min(max(level, 0), a.prev_levels - 1);
  const int lsh = max(a.prev_h >> lv, 1), lsw = max(a.prev_w >> lv, 1);
  const float x = u * (float)lsw - 0.5f, y = v * (float)lsh - 0.5f;
  const int ix = min(max((int)floorf(x), 0), max(lsw - 2, 0));
  const int iy = min(max((int)floorf(y), 0), max(lsh - 2, 0));
  const float fx = fminf(fmaxf(x - (float)ix, 0.0f), 1.0f);
  const float fy = fminf(fmaxf(y - (float)iy, 0.0f), 1.0f);
  const int c0 = level_off[lv] + ix, c1 = min(c0 + 1, a.atlas_wa - 1);
  const int iy1 = min(iy + 1, a.atlas_h - 1);
  bilerp(a, (iy * a.atlas_wa + c0) * 3, (iy * a.atlas_wa + c1) * 3, (iy1 * a.atlas_wa + c0) * 3,
         (iy1 * a.atlas_wa + c1) * 3, fx, fy, out);
}

__device__ __forceinline__ float alpha_at(const ScreenArgs& a, const float p[3]) {
  Corners cs;
  cs.load(a, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
  return cs.alpha();
}

// gi.screen_probe_multi of [ro0, end] (the k-point probe): whether a point
// resolved (and the resolved rgb, times ss_intensity), and whether the
// search left the screen before any hit.  noise dithers the fractions
// (jitter) and places the solidity taps.
__device__ bool probe_multi(const ScreenArgs& a, const Shared& sm, const float ro0[3],
                            const float end[3], float noise, float out[3], bool& off) {
  const float* cfw = sm.mats;
  const float* wfc = sm.mats + 16;
  float seg[3];
  for (int c = 0; c < 3; ++c) seg[c] = end[c] - ro0[c];
  off = false;
  for (int k = 0; k < a.k_points; ++k) {
    float frac = a.fracs[k];
    if (a.jitter) frac = fminf(fmaxf(frac + (noise - 0.5f) * a.jitter_k, 0.0f), 1.0f);
    float p[3], ndc[3];
    for (int c = 0; c < 3; ++c) p[c] = ro0[c] + seg[c] * frac;
    const float w = project(cfw, p[0] * a.inv_scale, p[1] * a.inv_scale, p[2] * a.inv_scale, ndc);
    if (!(w > 0.0f && fabsf(ndc[0]) < 1.0f && fabsf(ndc[1]) < 1.0f)) {
      off = true;
      return false;
    }
    const float u = ndc[0] * 0.5f + 0.5f, v = ndc[1] * 0.5f + 0.5f;
    const float d = depth_nearest(a, u, v);
    if (!(ndc[2] > d + a.z_margin && d < 1.0f)) continue;
    float t_res = frac;
    if (a.solid_taps > 0) {
      float surf[3];
      project(wfc, ndc[0], ndc[1], d, surf);
      const float n0 = noise * 0.2f;
      float asum = 0.0f;
      for (int t = 0; t < a.solid_taps; ++t) {
        const float f = n0 + a.tap_fracs[t];
        float pos[3];
        for (int c = 0; c < 3; ++c) {
          const float sg = surf[c] * a.scale;
          pos[c] = sg + (p[c] - sg) * f;
        }
        asum = asum + alpha_at(a, pos);
      }
      if (!(asum >= a.taps_half)) continue;
      // the reference package's loop rebinds the fraction to the last tap's
      t_res = n0 + a.tap_fracs[a.solid_taps - 1];
    }
    if (a.dist_mip > 0.0f) {
      const float seg_world =
          sqrtf((seg[0] * seg[0] + seg[1] * seg[1]) + seg[2] * seg[2]) * a.inv_seg_scale;
      const int lv = (int)rintf((seg_world * t_res) * a.dist_mip);
      prev_at_level(a, sm.level_off, lv, u, v, out);
    } else {
      prev_level(a, u, v, out);
    }
    return true;
  }
  return false;
}

// gi.screen_probe of the point q (grid NDC): whether it resolved, and the
// resolved rgb times ss_intensity
__device__ bool probe_single(const ScreenArgs& a, const Shared& sm, const float q[3],
                             float out[3]) {
  float ndc[3];
  const float w = project(sm.mats, q[0] * a.inv_scale, q[1] * a.inv_scale, q[2] * a.inv_scale,
                          ndc);
  const float u = ndc[0] * 0.5f + 0.5f, v = ndc[1] * 0.5f + 0.5f;
  if (!(w > 0.0f && fabsf(ndc[0]) < 1.0f && fabsf(ndc[1]) < 1.0f)) return false;
  const float d = depth_nearest(a, u, v);
  if (!(ndc[2] > d + a.z_margin && d < 1.0f)) return false;
  prev_level(a, u, v, out);
  return true;
}

// hiz_trace's view-space z: (zf*zn) / max(zf - z*(zf - zn), 1e-6) as
// PyTorch computes a Python number over a tensor
__device__ __forceinline__ float zview(const ScreenArgs& a, float z) {
  return (1.0f / fmaxf(a.zv_far - z * a.zv_span, 1e-6f)) * a.zv_num;
}

__device__ __forceinline__ float exit_t(float o, float d) {
  const float t_hi = d > 1e-9f ? (1.0f - o) / d : 1e9f;
  const float t_lo = d < -1e-9f ? (0.0f - o) / d : 1e9f;
  return fminf(t_hi, t_lo);
}

// gi.screen_trace_hiz of [ro0, end] (grid NDC): whether it resolved, and
// the resolved rgb times ss_intensity
__device__ bool hiz_term(const ScreenArgs& a, const Shared& sm, const float ro0[3],
                         const float end[3], float out[3]) {
  const float* cfw = sm.mats;
  float c0[4], c1[4];
  for (int i = 0; i < 4; ++i) {
    c0[i] = xform(cfw, i, ro0[0] * a.inv_scale, ro0[1] * a.inv_scale, ro0[2] * a.inv_scale);
    c1[i] = xform(cfw, i, end[0] * a.inv_scale, end[1] * a.inv_scale, end[2] * a.inv_scale);
  }
  const float w_min = 1e-3f;
  const float w0 = c0[3];
  const float t_end =
      c1[3] < w_min ? fminf(fmaxf((w0 - w_min) / fmaxf(w0 - c1[3], 1e-6f), 0.0f), 1.0f) : 1.0f;
  for (int i = 0; i < 4; ++i) c1[i] = c0[i] + (c1[i] - c0[i]) * t_end;
  const float w1 = fmaxf(c1[3], w_min), w0s = fmaxf(w0, w_min);
  const float p0[3] = {(c0[0] / w0s) * 0.5f + 0.5f, (c0[1] / w0s) * 0.5f + 0.5f, c0[2] / w0s};
  const float p1[3] = {(c1[0] / w1) * 0.5f + 0.5f, (c1[1] / w1) * 0.5f + 0.5f, c1[2] / w1};
  const bool valid = w0 > w_min;

  // -- hiz_trace(p0, p1): start level 1, max level 5, t0 2 px
  const int hw = a.hiz_w, hh = a.hiz_h;
  const float du = p1[0] - p0[0], dv = p1[1] - p0[1], dz = p1[2] - p0[2];
  const float t_max = fminf(fminf(exit_t(p0[0], du), exit_t(p0[1], dv)), 1.0f);
  const float duw = du * (float)hw, dvh = dv * (float)hh;
  const float seg_px = fmaxf(sqrtf(duw * duw + dvh * dvh), 1e-6f);
  const float eps_t = (1.0f / seg_px) * 0.05f;
  float t = fminf((1.0f / seg_px) * 2.0f, t_max);
  int lvl = 1;
  bool hit = false, dead = t >= t_max;
  float t_hit = 0.0f;
  const float inv_du = fabsf(du) > 1e-9f ? 1.0f / (du == 0.0f ? 1.0f : du) : 1e9f;
  const float inv_dv = fabsf(dv) > 1e-9f ? 1.0f / (dv == 0.0f ? 1.0f : dv) : 1e9f;
  for (int it = 0; it < a.hiz_iters && !hit && !dead; ++it) {
    const float cs = exp2f((float)lvl);
    const float pu = (p0[0] + du * t) * (float)hw, pv = (p0[1] + dv * t) * (float)hh;
    const float cx = floorf(pu / cs), cy = floorf(pv / cs);
    const float bx = (cx + (du > 0.0f ? 1.0f : 0.0f)) * cs;
    const float by = (cy + (dv > 0.0f ? 1.0f : 0.0f)) * cs;
    const float tx = fabsf(du) > 1e-9f ? (bx * a.inv_hiz_w - p0[0]) * inv_du : 1e9f;
    const float ty = fabsf(dv) > 1e-9f ? (by * a.inv_hiz_h - p0[1]) * inv_dv : 1e9f;
    const float t_cross = fminf(fminf(tx, ty), t_max);
    const int ix = min(max((int)cx, 0), max(1, hw >> lvl) - 1);
    const int iy = min(max((int)cy, 0), max(1, hh >> lvl) - 1);
    const float zcell = __ldg(a.depth + (iy * a.tw + sm.hiz_off[lvl] + ix));
    const float z_enter = p0[2] + dz * t, z_exit = p0[2] + dz * t_cross;
    const float zmax = fmaxf(z_enter, z_exit);
    const bool cross = (zview(a, zmax) - a.hiz_bias >= zview(a, zcell)) && zcell < 1.0f;
    const bool at0 = lvl == 0;
    bool advance = !cross, refine = false;
    if (cross && at0) {
      if (zview(a, fminf(z_enter, z_exit)) - zview(a, zcell) < a.hiz_thickness) {
        hit = true;
        t_hit = t;
        break;
      }
      advance = true;      // passes farther behind the surface: skip the cell
    } else if (cross) {
      refine = true;
    }
    if (refine) {
      lvl = lvl - 1;
      const float dzi = z_exit - z_enter;
      const float t_z = t + ((zcell - z_enter) / (fabsf(dzi) < 1e-9f ? 1.0f : dzi)) * (t_cross - t);
      t = dzi > 1e-9f ? fminf(fmaxf(t_z, t), t_cross) : t;
    } else if (advance) {
      lvl = min(lvl + 1, kHizLevels - 1);
      t = t_cross + eps_t;
      dead = t >= t_max;
    }
  }
  hit = hit && valid;
  if (hit && a.hiz_solid > 0.0f) {
    const float iw0 = 1.0f / w0s, iw1 = 1.0f / w1;
    const float denom = (1.0f - t_hit) * iw0 + t_hit * iw1;
    float mid[3];
    for (int c = 0; c < 3; ++c)
      mid[c] = (((1.0f - t_hit) * ro0[c]) * iw0 + (t_hit * end[c]) * iw1) / denom;
    hit = alpha_at(a, mid) >= a.hiz_solid;
  }
  float t_res = t_hit;
  if (!hit) {
    // the end point projects behind the level-0 depth: resolve there
    const int e_ix = min(max((int)(p1[0] * (float)hw), 0), hw - 1);
    const int e_iy = min(max((int)(p1[1] * (float)hh), 0), hh - 1);
    const float d_end = __ldg(a.depth + (e_iy * a.tw + e_ix));
    const bool onscreen = valid && t_end >= 1.0f && p1[0] > 0.0f && p1[0] < 1.0f &&
                          p1[1] > 0.0f && p1[1] < 1.0f;
    if (!(onscreen && p1[2] > d_end && d_end < 1.0f)) return false;
    t_res = 1.0f;
  }
  prev_level(a, p0[0] + (p1[0] - p0[0]) * t_res, p0[1] + (p1[1] - p0[1]) * t_res, out);
  return true;
}

__device__ __forceinline__ void load_shared(const ScreenArgs& a, Shared& sm) {
  const int tid = threadIdx.x;
  if (tid < 16) {
    sm.mats[tid] = a.clip_from_world[tid];
    sm.mats[16 + tid] = a.world_from_clip != nullptr ? a.world_from_clip[tid] : 0.0f;
    sm.mats[32 + tid] = a.view_from_world != nullptr ? a.view_from_world[tid] : 0.0f;
  } else if (tid < 19) {
    sm.mats[48 + tid - 16] = a.camera_pos != nullptr ? a.camera_pos[tid - 16] : 0.0f;
  }
  if (tid < kMaxLevels) {
    int off = 0;
    for (int j = 0; j < tid; ++j) off += max(1, a.prev_w >> j);
    sm.level_off[tid] = off;
  } else if (tid < kMaxLevels + kHizLevels) {
    int off = 0;
    for (int j = 0; j < tid - kMaxLevels; ++j) off += max(1, a.hiz_w >> j);
    sm.hiz_off[tid - kMaxLevels] = off;
  }
  for (int q = tid; q < 256; q += kThreads) sm.decode[q] = decode_rgb(q);
  __syncthreads();
}

__device__ __forceinline__ int this_lane(const ScreenArgs& a) {
  const int tiles_x = (a.width + 32 / a.tile_h - 1) / (32 / a.tile_h);
  const int tiles = tiles_x * ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  return t < tiles ? tile_lane(a.n, a.width, a.tile_h, t, threadIdx.x & 31, tiles_x) : -1;
}

// The ray of one lane of gi_screen_ray: the fog march, then the probes or
// the hi-z term.
template <bool kNearest, int kTerm>
__device__ void screen_ray(const ScreenArgs& a, const Shared& sm, int lane) {
  const float pw[3] = {a.pw[3 * lane], a.pw[3 * lane + 1], a.pw[3 * lane + 2]};
  const float noise = a.noise[lane];
  const float fog = a.fog_lane != nullptr ? a.fog_lane[lane] : a.fog;
  float rd[3], ro[3], ro0[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = a.rd[3 * lane + c] * a.voxel;
    ro[c] = pw[c] * a.scale;
    ro0[c] = ro[c];
  }
  float ro_open[3], rgb[3];
  const bool found = fog_march<kNearest>(a, sm.decode, ro, rd, noise, fog, ro_open, rgb);
  float end[3];
  for (int c = 0; c < 3; ++c) end[c] = ro_open[c];
  if (a.to_stop) {
    if (found) {
      for (int c = 0; c < 3; ++c) end[c] = ro[c];
    } else {
      const float jit = a.jitter_scale * noise;
      for (int c = 0; c < 3; ++c) end[c] = ro_open[c] + (rd[c] * a.step_scale) * jit;
    }
  }
  int status = 2;
  float ss[3];
  if (kTerm == kTermHiz) {
    if (hiz_term(a, sm, ro0, end, ss)) status = 3;
  } else {
    if (a.overshoot > 0.0f) {
      const float* vfw = sm.mats + 32;
      float seg[3], dvs[3];
      for (int c = 0; c < 3; ++c) seg[c] = end[c] - ro0[c];
      for (int c = 0; c < 3; ++c)
        dvs[c] = (seg[0] * vfw[4 * c] + seg[1] * vfw[4 * c + 1]) + seg[2] * vfw[4 * c + 2];
      const float n2 = sqrtf(dvs[0] * dvs[0] + dvs[1] * dvs[1]);
      const float n3 = sqrtf((dvs[0] * dvs[0] + dvs[1] * dvs[1]) + dvs[2] * dvs[2]);
      const float ov = fminf(n3 / fmaxf(n2, 1e-6f), a.overshoot);
      for (int c = 0; c < 3; ++c) end[c] = ro0[c] + seg[c] * ov;
    }
    bool off;
    if (probe_multi(a, sm, ro0, end, noise, ss, off)) {
      status = 3;
    } else if (off && a.edge_fallback) {
      // the lightgrid 2.5 voxels camera-ward (m3.normalize: vector_norm sums
      // (x^2 + z^2) + y^2 on the card)
      const float* cam = sm.mats + 48;
      const float vc[3] = {cam[0] - pw[0], cam[1] - pw[1], cam[2] - pw[2]};
      const float nrm = fmaxf(sqrtf((vc[0] * vc[0] + vc[2] * vc[2]) + vc[1] * vc[1]), 1e-12f);
      Corners cs;
      float p[3];
      for (int c = 0; c < 3; ++c) p[c] = ro0[c] + (vc[c] / nrm) * a.fb_step;
      cs.load(a, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
      float fb[3];
      cs.rgb(sm.decode, fb);
      tone_compress(fb, rgb);
      status = 1;
    }
  }
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = status == 3 ? ss[c] : rgb[c];
  a.out_status[lane] = status;
}

// The ray of one lane of gi_probe_ray: the quadrature, march_to_hit and the
// probe from the surface.
__device__ void probe_ray(const ScreenArgs& a, const Shared& sm, int lane) {
  const float pw[3] = {a.pw[3 * lane], a.pw[3 * lane + 1], a.pw[3 * lane + 2]};
  const float rdu[3] = {a.rd[3 * lane], a.rd[3 * lane + 1], a.rd[3 * lane + 2]};
  float rd[3], ro[3], ro0[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = rdu[c] * a.voxel;
    ro[c] = pw[c] * a.scale;
    ro0[c] = ro[c];
  }
  // -- sample_radiance_fast: the blockage skip on the alpha levels
  Corners cs;
  bool found = false;
  for (int i = 0; i < a.skip_steps && !found; ++i) {
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rd[c];
    cs.load(a, ro[0] * 0.5f + 0.5f, ro[1] * 0.5f + 0.5f, ro[2] * 0.5f + 0.5f);
    found = cs.alpha() < a.open_thresh;
  }
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (found) {
    float acc[3];
    cs.rgb(sm.decode, acc);   // the open sample, at the skip's last fetch
    float acc_w = fminf(1.0f + 1e-4f, 1.0f), trans = 1.0f;
    for (int k = 0; k < a.samples; ++k) {
      Corners sk;
      sk.load(a, (ro[0] + rd[0] * a.sample_off[k]) * 0.5f + 0.5f,
              (ro[1] + rd[1] * a.sample_off[k]) * 0.5f + 0.5f,
              (ro[2] + rd[2] * a.sample_off[k]) * 0.5f + 0.5f);
      const float open_k = fminf(fmaxf((0.5f - sk.alpha()) * 4.0f, 0.0f), 1.0f);
      float s[3];
      sk.rgb(sm.decode, s);
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + (trans * open_k) * s[c];
      acc_w = acc_w + trans * open_k;
      trans = trans * open_k;
    }
    const float den = fmaxf(acc_w, 1e-4f);
    const float mean[3] = {acc[0] / den, acc[1] / den, acc[2] / den};
    tone_compress(mean, rgb);
    const float wgt = fminf(acc_w, 1.0f);
    for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * wgt;
  }
  int status = 2;
  if (a.term == kTermProbe) {
    // -- march_to_hit, then the probe
    bool hit_m = true;
    if (a.march_steps > 0) {
      hit_m = false;
      for (int i = 0; i < a.march_steps && !hit_m; ++i) {
        for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rdu[c] * a.hit_step;
        hit_m = alpha_at(a, ro) > kFogHitThresh;
      }
    }
    float ss[3];
    bool off;
    const bool hit = a.k_points > 1 ? probe_multi(a, sm, ro0, ro, 0.0f, ss, off)
                                    : probe_single(a, sm, ro, ss);
    if (hit && hit_m) {
      status = 3;
      for (int c = 0; c < 3; ++c) rgb[c] = ss[c];
    }
  }
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
}

template <bool kNearest, int kTerm>
__global__ void __launch_bounds__(kThreads) gi_screen_ray_kernel(const ScreenArgs a) {
  __shared__ Shared sm;
  load_shared(a, sm);
  const int lane = this_lane(a);
  if (lane >= 0) screen_ray<kNearest, kTerm>(a, sm, lane);
}

__global__ void __launch_bounds__(kThreads) gi_probe_ray_kernel(const ScreenArgs a) {
  __shared__ Shared sm;
  load_shared(a, sm);
  const int lane = this_lane(a);
  if (lane >= 0) probe_ray(a, sm, lane);
}

int grid_of(const ScreenArgs& a) {
  const int tw = 32 / a.tile_h;
  const long long tiles = (long long)((a.width + tw - 1) / tw) *
                          ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  return (int)((tiles + kWarps - 1) / kWarps);
}

template <bool kNearest>
void launch_screen(const ScreenArgs& a, cudaStream_t stream) {
  if (a.term == kTermHiz)
    gi_screen_ray_kernel<kNearest, kTermHiz><<<grid_of(a), kThreads, 0, stream>>>(a);
  else
    gi_screen_ray_kernel<kNearest, kTermProbes><<<grid_of(a), kThreads, 0, stream>>>(a);
}

int attributes(const void* fn, int* registers, int* local_bytes, int* blocks_per_sm,
               int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0);
}

}  // namespace

// One launch of gi_screen_ray (term probes or hiz; the nearest fog march
// where fgrid is set) on `stream` of `device`.
extern "C" int gi_screen_ray_launch(const ScreenArgs* args, int device, void* stream) {
  const ScreenArgs& a = *args;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0) return (int)cudaGetLastError();
  if (a.fgrid != nullptr)
    launch_screen<true>(a, (cudaStream_t)stream);
  else
    launch_screen<false>(a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One launch of gi_probe_ray (the economy mode's ray) on `stream` of `device`.
extern "C" int gi_probe_ray_launch(const ScreenArgs* args, int device, void* stream) {
  const ScreenArgs& a = *args;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0) return (int)cudaGetLastError();
  gi_probe_ray_kernel<<<grid_of(a), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers, local bytes, resident blocks an SM and threads a block of a
// kernel: which 0 gi_probe_ray, 1 gi_screen_ray's probes term, 2 its hiz
// term (the trilinear fog march's instances).
extern "C" int gi_screen_ray_occupancy(int which, int* registers, int* local_bytes,
                                       int* blocks_per_sm, int* threads) {
  const void* fn = which == 0   ? (const void*)gi_probe_ray_kernel
                   : which == 1 ? (const void*)gi_screen_ray_kernel<false, kTermProbes>
                                : (const void*)gi_screen_ray_kernel<false, kTermHiz>;
  return attributes(fn, registers, local_bytes, blocks_per_sm, threads);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
