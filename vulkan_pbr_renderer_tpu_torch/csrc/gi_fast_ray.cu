// One fast-GI ray per lane for Hopper (sm_90a): fog march, camera-ward
// fallback, bounded linear screen trace and previous-frame resolve.
//
// Replaces the two ray loops of the JAX package's fast GI, which XLA runs as
// device loops inside the jitted frame: the fog march
// vulkan_pbr_renderer_tpu/shade/gi.py:398 sample_radiance_fog and the linear
// screen trace gi.py:915 screen_trace_linear, composed per ray at
// vulkan_pbr_renderer_tpu/shade/gi_modes.py:229-291 (the "trace" branch).  It
// computes shade/gi.py::fast_ray_resolve_plain: per lane, from world position
// pw along rd, skip the initial blockage (skip_steps fetches, the first with
// alpha < open_thresh seeds the sum), fog-march (march_steps fetches, each
// open one folded into sum = sum*fog + (rgb, 1), alpha > 0.3 stops), tone the
// mean; with the screen term, trace from view position pv toward the open
// point in screen space (trace_steps steps, a nearest depth fetch each, the
// step growing 1.2x; a depth crossing is tested once for lightgrid solidity
// with solid_taps alpha taps: solid resolves, translucent re-arms with a
// (2+noise)x step for trace_steps2 more steps, trace_rounds rounds), then
// resolve: status 1 the lightgrid 2.5 voxels camera-ward, status 3 the bf16
// previous-frame pyramid at the crossing's uv and lod min(5*step, 5), else
// the march.  Output rgb [N,3] f32 and the status [N] i32.
//
// Tables.  The lightgrid is one u8 [D,H,W,4] table of quantize_grid_u8's
// levels (8 MB at 128^3): the trilinear march, the fallback and the solidity
// taps read its 8 corners with the window pack's edge clamp, so the values
// equal those of the plain version's packs (pack_grid_u8,
// pack_grid_alpha_u16) bit for bit.  The nearest march (fgrid) reads the f16
// [D,H,W,4] grid.  The trace table is [Ht,Wt] f32, the pyramid [H/2,Wa,3]
// bf16.  All of it fits in the H100's 50 MB L2.
//
// What bounds it on the card.  A frame's ray has 261,120 lanes at
// 1920x1088 (a 960x544 GI grid, half the lanes under the interleave).  Each
// input byte read once is about 25 MB (the 8 MB grid, the lanes, the trace
// table, the pyramid): ~8 us at 3.35 TB/s.  The arithmetic is a few thousand
// flops a lane (a trilinear fetch decodes 8 corners, 24 divides for rgb):
// ~1-2 GFLOP, ~20-30 us at the f32 peak.  Neither is what holds a lane: each
// step waits for its own dependent gather (the next position depends on the
// last fetch's alpha), so the kernel is bound by the latency of L2 gathers
// times the steps of the longest lane in a warp.
//
// Design (right and simple first).  One thread per lane, kThreads a block;
// the matrices and the camera position in shared memory; the lane's whole
// state in registers.  A lane stops where the plain version's masks freeze
// it: the skip at its first open sample, the march at its first hit, the
// trace at its first off-screen step, exhausted distance or crossing, the
// rounds once its status is final.  The result does not depend on that; it
// is only work saved.  The trilinear fetch loads the 8 corners as one 4-byte
// word each and decodes alpha first, rgb only where the sample is used.
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// version's operation order (sampling.sample_trilinear_window's clamps and
// lerp order, the per-corner decode before the lerp, m3.transform_points's
// pairwise sum, tone_compress_sqrt, the bf16-rounded texel differences of
// sampling.sample_mip_atlas, the camera-ward normalize's order).  PyTorch on
// the card divides a tensor by a Python number as a product with the
// number's f32 reciprocal; the two such divisions of the plain version
// (ro_open / scale, ... / 100.0) are products here too.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
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
};

namespace {

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
__device__ __forceinline__ float decode_rgb(unsigned char q) {
  const float s = (float)q * kInv255;
  const float c2 = s * s;
  return c2 / fmaxf(1.0f - c2, 1.0f / 256.0f);
}

// The 8 corners (layout dz*4+dy*2+dx) and fractionals of a trilinear fetch
// of the u8 table at uvw (sampling.sample_trilinear_table).
struct Corners {
  uchar4 c[8];
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
    const int xs[2] = {ix, min(ix + 1, a.gw - 1)};
    const int ys[2] = {iy, min(iy + 1, a.gh - 1)};
    const int zs[2] = {iz, min(iz + 1, a.gd - 1)};
    const uchar4* t = reinterpret_cast<const uchar4*>(a.table);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[k] = __ldg(t + ((zs[k >> 2] * a.gh + ys[(k >> 1) & 1]) * a.gw + xs[k & 1]));
    }
  }

  __device__ __forceinline__ float alpha() const {
    float k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = (float)c[i].w * kInv255;
    return lerp8(k, fx, fy, fz);
  }

  __device__ __forceinline__ void rgb(float out[3]) const {
    float k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = decode_rgb(c[i].x);
    out[0] = lerp8(k, fx, fy, fz);
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = decode_rgb(c[i].y);
    out[1] = lerp8(k, fx, fy, fz);
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = decode_rgb(c[i].z);
    out[2] = lerp8(k, fx, fy, fz);
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

  __device__ __forceinline__ void rgb(float out[3]) const {
    if (kNearest) {
      out[0] = v[0];
      out[1] = v[1];
      out[2] = v[2];
    } else {
      corners.rgb(out);
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
__device__ void atlas_level(const RayArgs& a, int lv, float u, float v, float out[3]) {
  int off = 0;
  for (int j = 0; j < lv; ++j) off += max(1, a.prev_w >> j);
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

template <bool kNearest>
__global__ void __launch_bounds__(kThreads) gi_fast_ray_kernel(const RayArgs a) {
  // view_from_world, clip_from_view, world_from_view, camera position
  __shared__ float mats[51];
  if (threadIdx.x < 16) {
    mats[threadIdx.x] = a.view_from_world[threadIdx.x];
    mats[16 + threadIdx.x] = a.clip_from_view[threadIdx.x];
    mats[32 + threadIdx.x] = a.world_from_view[threadIdx.x];
  } else if (threadIdx.x < 19) {
    mats[48 + threadIdx.x - 16] = a.camera_pos[threadIdx.x - 16];
  }
  __syncthreads();
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  const float* vfw = mats;
  const float* cfv = mats + 16;
  const float* wfv = mats + 32;
  const float* cam = mats + 48;

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
  for (int i = 0; i < a.skip_steps && !found; ++i) {
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rd[c];
    if (tap.alpha(a, ro[0], ro[1], ro[2]) < a.open_thresh) {
      tap.rgb(sum);
      found = true;
    }
  }
  const float ro_open[3] = {ro[0], ro[1], ro[2]};
  sum[3] = (found ? 1.0f : 0.0f) + 1e-4f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (found) {
    float rdm[3];
    const float jit = a.jitter_scale * noise;
    for (int c = 0; c < 3; ++c) {
      rdm[c] = rd[c] * a.step_scale;
      ro[c] = ro_open[c] + rdm[c] * jit;
    }
    for (int i = 0; i < a.march_steps; ++i) {
      for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rdm[c];
      if (tap.alpha(a, ro[0], ro[1], ro[2]) > kHitThresh) break;
      float s[3];
      tap.rgb(s);
      for (int c = 0; c < 3; ++c) sum[c] = sum[c] * fog + s[c];
      sum[3] = sum[3] * fog + 1.0f;
    }
    const float w = fmaxf(sum[3], 1e-4f);
    const float mean[3] = {sum[0] / w, sum[1] / w, sum[2] / w};
    tone_compress(mean, rgb);
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
    for (int r = 0; r < rounds && status == 0; ++r) {
      const int steps = r == 0 ? a.trace_steps : a.trace_steps2;
      for (int i = 0; i < steps && status == 0; ++i) {
        const float s = trav + slen;
        const float cx = c0x + s * cdx, cy = c0y + s * cdy, cw = c0w + s * cdw;
        const float iw = 1.0f / (fabsf(cw) < 1e-8f ? 1e-8f : cw);
        const float nx = cx * iw, ny = cy * iw;
        trav = s;
        slen = slen * 1.2f;
        if (fmaxf(fabsf(nx), fabsf(ny)) > 1.0f) {
          status = 1;
          break;
        }
        const float u = nx * 0.5f + 0.5f, v = ny * 0.5f + 0.5f;
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
      if (status != 4) continue;
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
      const float fr3[3] = {0.2f, 0.4f, 0.6f}, fr2[2] = {0.3f, 0.5f}, fr1[1] = {0.4f};
      const int taps = a.solid_taps >= 3 ? 3 : a.solid_taps == 1 ? 1 : 2;
      const float* fr = taps == 3 ? fr3 : taps == 1 ? fr1 : fr2;
      float asum = 0.0f;
      for (int k = 0; k < taps; ++k) {
        const float f = noff + fr[k];
        Corners cs;
        cs.load(a, t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                t0[2] + (t1[2] - t0[2]) * f);
        asum = asum + cs.alpha();
      }
      if (asum >= 0.5f * (float)taps) {
        status = 3;
      } else {
        status = 0;
        slen = slen * (2.0f + noise);
      }
    }
    if (status == 0) status = 2;   // still marching at the budget: the march result

    if (status == 1) {
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
      cs.rgb(fb);
      tone_compress(fb, rgb);
    } else if (status == 3) {
      // the previous frame's pyramid at the crossing, lod min(5*step, 5)
      const int levels = a.prev_levels;
      const float lod = fminf(fmaxf(fminf(slen * 5.0f, 5.0f), 0.0f), (float)(levels - 1));
      const int l0 = (int)floorf(lod);
      const int l1 = min(l0 + 1, levels - 1);
      const float fl = lod - (float)l0;
      float s0[3], s1[3];
      atlas_level(a, l0, res_u, res_v, s0);
      atlas_level(a, l1, res_u, res_v, s1);
      for (int c = 0; c < 3; ++c) rgb[c] = (s0[c] + (s1[c] - s0[c]) * fl) * a.ss_intensity;
    }
  }
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
}

}  // namespace

extern "C" int gi_fast_ray_launch(const RayArgs* args, void* stream) {
  const RayArgs a = *args;
  if (a.n > 0) {
    const int grid = (a.n + kThreads - 1) / kThreads;
    if (a.fgrid != nullptr) {
      gi_fast_ray_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    } else {
      gi_fast_ray_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
