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
// input byte read once is about 31 MB: ~9 us at 3.35 TB/s.  The arithmetic
// of the steps these lanes take is ~0.8 GFLOP: ~12 us at the f32 peak
// (chip_smoke.py's bound).  Neither is what holds a lane: each step waits
// for its own dependent gathers (the next position depends on the last
// fetch's alpha), a warp runs to its longest lane, and without FMA every
// lerp is two issued instructions.  On the H100 (gi_sweep.py) the parent's
// design spent most of its time issuing the 24 IEEE divides of each march
// step's per-corner rgb decode; divergence (every lane forced through its
// whole budget) and the corner gathers come next.
//
// Design.  The lanes are a [rows, width] grid (the GI grid's lanes, one row
// for a 1-D lane tensor).  A warp takes a tile of tile_h x (32 / tile_h)
// lanes of it (gi.lane_tiles mirrors the mapping; 8 x 4 on a full grid), so
// its rays start at neighbouring pixels, march through neighbouring voxels
// and stop at more alike steps.  The rgb decode of the 256 u8 levels (a
// divide each) is a table in shared memory, computed by the block with the
// same arithmetic, so a march step reads 24 decoded corners instead of
// dividing 24 times.  The grid covers every tile once, a warp each: the
// card's block scheduler starts a new block as soon as one retires, so no
// slot idles at the end (a persistent grid that took tiles from a counter
// measured 2.6-4.5% slower, gi_sweep.py).  The lane's whole state is in
// registers; a lane stops where the plain version's masks freeze it.
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// version's operation order (sampling.sample_trilinear_window's clamps and
// lerp order, the per-corner decode before the lerp, m3.transform_points's
// pairwise sum, tone_compress_sqrt, the bf16-rounded texel differences of
// sampling.sample_mip_atlas, the camera-ward normalize's order).  PyTorch on
// the card divides a tensor by a Python number as a product with the
// number's f32 reciprocal; the two such divisions of the plain version
// (ro_open / scale, ... / 100.0) are products here too.
//
// The sampling helpers (the table's, the trace table's and the pyramid's
// fetches, the tone compressor, the point transform, the lane tiles) and
// the fog march live in gi_common.cuh, shared with the reference GI's
// kernel gi_reference_ray.cu and the screen-term kernels gi_screen_ray.cu.
//
// Compile-time values (gi_sweep.py builds variants with -D): GI_THREADS,
// GI_MIN_BLOCKS (__launch_bounds__' blocks per SM, 0 none).  The designs
// the sweep measured and did not keep, and its probes, are in gi_sweep.cu.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gi_common.cuh"

#ifndef GI_THREADS
#define GI_THREADS 128
#endif
#ifndef GI_MIN_BLOCKS
#define GI_MIN_BLOCKS 0
#endif

namespace {

constexpr int kThreads = GI_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;                   // the pyramid's levels (checked by the wrapper)
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

// What a block keeps in shared memory: view_from_world, clip_from_view,
// world_from_view, the camera position, the pyramid's level offsets and the
// rgb decode of every u8 level.
struct Shared {
  float mats[51];
  int level_off[kMaxLevels];
  float decode[256];
};

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

  const float pw[3] = {a.pw[3 * lane], a.pw[3 * lane + 1], a.pw[3 * lane + 2]};
  const float noise = a.noise[lane];
  const float fog = a.fog_lane != nullptr ? a.fog_lane[lane] : a.fog;
  float rd[3], ro[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = a.rd[3 * lane + c] * a.voxel;
    ro[c] = pw[c] * a.scale;
  }

  // -- fog march (gi.sample_radiance_fog)
  float ro_open[3], rgb[3];
  fog_march<kNearest>(a, sm.decode, ro, rd, noise, fog, ro_open, rgb);

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
      const int taps = a.solid_taps >= 3 ? 3 : a.solid_taps == 1 ? 1 : 2;
      float asum = 0.0f;
      for (int k = 0; k < taps; ++k) {
        const float f = noff + tap_frac(taps, k);
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
      cs.rgb(sm.decode, fb);
      tone_compress(fb, rgb);
    } else if (status == 3) {
      // the previous frame's pyramid at the crossing, lod min(5*step, 5)
      pyramid_resolve(a, sm.level_off, slen, res_u, res_v, a.ss_intensity, rgb);
    }
  }
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
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

  // one tile per warp, a grid over all tiles
  const int tiles_x = (a.width + 32 / a.tile_h - 1) / (32 / a.tile_h);
  const int tiles = tiles_x * ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  const int t = blockIdx.x * kWarps + (tid >> 5);
  const int lane = t < tiles ? tile_lane(a.n, a.width, a.tile_h, t, tid & 31, tiles_x) : -1;
  if (lane >= 0) ray<kNearest>(a, sm, lane);
}

template <bool kNearest>
int launch(const RayArgs& a, cudaStream_t stream) {
  const int tw = 32 / a.tile_h;
  const long long tiles = (long long)((a.width + tw - 1) / tw) *
                          ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  const int grid = (int)((tiles + kWarps - 1) / kWarps);
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
