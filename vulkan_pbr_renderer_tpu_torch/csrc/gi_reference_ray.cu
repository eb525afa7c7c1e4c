// One reference-GI ray per lane for Hopper (sm_90a): the hybrid screen-space
// + voxel march of gi_mode="reference".
//
// Replaces the JAX package's XLA loop (no Pallas kernel)
// vulkan_pbr_renderer_tpu/shade/gi.py:1520 sample_radiance_with_screen_trace
// (the jax.lax.fori_loop over max_ss_steps at :1672), called twice a GI frame
// from gi_modes.py:458 reference_gi.  It computes
// shade/gi.py::reference_ray_resolve_plain, SampleRadianceWithScreenSpaceTrace
// (lighting_pass.glsl:273-424), per lane:
//   A. from ro = pw * scale, skip the initial blockage: up to 4 steps of
//      rd * voxel, the first with alpha < 0.3 opens (the position freezes);
//   B. trace screen space from view position pv toward the open point for
//      up to max_ss_steps steps, the step growing 1.2x: project (clip_from_view,
//      |w| < 1e-8 made 1e-8), off screen -> status 1; fetch the nearest trace
//      depth, unproject it (view_from_clip) and, where the surface is nearer
//      than the ray, take three alpha taps between them (world_from_view,
//      noise * 0.2 + 0.2 / 0.4 / 0.6): solid (sum >= 1.5) -> status 3 with the
//      uv and step recorded, else the step grows by 2 + noise; past the
//      distance to the open point -> status 2; still marching at the budget
//      -> status 2;
//   C. status 1: the lightgrid 2.5 voxels along the view direction vd,
//      tone-compressed; status 3: the bf16 previous-frame pyramid at the uv,
//      lod min(5 * step, 5), times ss_intensity; status 2: where a voxel
//      opened, fog-march from the open point + rd2 * noise in steps of
//      0.5 * rd2 (rd2 = rd * voxel * step_scale), up to num_steps fetches,
//      alpha > 0.3 stops, each open fetch folded into sum * fog + (rgb, 1)
//      from the open sample's (rgb, 1 + 1e-4), then the tone compressor; 0
//      where no voxel opened.
// Output rgb [N,3] f32 and the status [N] i32 (1, 2 or 3).
//
// The plain version masks every lane through every step; a lane here leaves
// each loop once the plain version's masks freeze it, and fetches only what
// its status reads (the open sample and the march only for status 2), which
// gives the same values.
//
// Tables: the lightgrid's u8 [D,H,W,4] table (gi.quantize_grid_u8, the one
// the sweep writes and gi_fast_ray reads; its trilinear fetches equal the
// window packs' bit for bit), the [th,tw] f32 trace depth and the
// [>=prev_h, Wa, 3] bf16 pyramid.  All of it fits in the H100's 50 MB L2.
//
// Layout (gi_fast_ray.cu's): a warp takes a tile of tile_h x
// (32 / tile_h) lanes of the [rows, width] lane grid (gi.lane_tiles), a grid
// of all tiles, 128 threads a block; the matrices, the pyramid's level
// offsets and the rgb decode of the 256 u8 levels in shared memory; each
// lane's state in registers.
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// version's operation order on the card (the helpers of gi_common.cuh;
// m3.transform_points's pairwise sum; _norm2 / _norm3's sum order;
// torch.where selects).  PyTorch on the card divides a tensor by a Python
// number as a product with the number's f32 reciprocal: ro / scale and
// (...) / 100.0 are products here too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gi_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;          // the pyramid's levels (checked by the wrapper)
constexpr int kSkipSteps = 4;           // phase A's steps
constexpr float kOpenThresh = 0.3f;     // phase A's open threshold
constexpr float kHitThresh = 0.3f;      // _voxel_march's stop
constexpr float kSolid = 1.5f;          // three taps' alpha sum of a solid crossing
constexpr float kInv100 = 1.0f / 100.0f;

}  // namespace

// shade/gi.py::_RefArgs mirrors this struct field for field.
struct RefArgs {
  const unsigned char* table;          // [D,H,W,4] u8 levels
  const float* depth;                  // [th,tw] trace depth
  const __nv_bfloat16* atlas;          // [>=prev_h, atlas_wa, 3] previous-frame pyramid
  const float* view_from_world;        // [4,4] row-major
  const float* clip_from_view;
  const float* view_from_clip;
  const float* world_from_view;
  const float* vd;                     // [n,3] unit vector toward the camera
  const float* pv;                     // [n,3] view position
  const float* pw;                     // [n,3] world position
  const float* rd;                     // [n,3] unit ray direction
  const float* noise;                  // [n]
  const float* fog_lane;               // [n] per-lane foggyness, or null: `fog`
  float* out_rgb;                      // [n,3]
  int* out_status;                     // [n]
  float fog, scale, inv_scale, voxel, half_scale, step_scale, ss_intensity;
  int n, gd, gh, gw, th, tw, atlas_wa, prev_h, prev_w, prev_levels, num_steps, max_ss_steps;
  int width;                           // lanes per row of the lane grid (n for 1-D lanes)
  int tile_h;                          // rows of a warp's lane tile: 1, 2, 4, 8, 16 or 32
};

namespace {

// What a block keeps in shared memory: view_from_world, clip_from_view,
// view_from_clip, world_from_view, the pyramid's level offsets and the rgb
// decode of every u8 level.
struct Shared {
  float mats[64];
  int level_off[kMaxLevels];
  float decode[256];
};

// alpha of the u8 table at grid-NDC p (uvw = p*0.5+0.5)
__device__ __forceinline__ float grid_alpha(const RefArgs& a, Corners& cs, const float p[3]) {
  cs.load(a, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
  return cs.alpha();
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}

// The ray of one lane: reference_ray_resolve_plain's rgb and status.
__device__ void ray(const RefArgs& a, const Shared& sm, int lane) {
  const float* vfw = sm.mats;
  const float* cfv = sm.mats + 16;
  const float* vfc = sm.mats + 32;
  const float* wfv = sm.mats + 48;

  const float noise = a.noise[lane];
  float rd[3], ro[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = a.rd[3 * lane + c] * a.voxel;
    ro[c] = a.pw[3 * lane + c] * a.scale;
  }

  // -- phase A: skip the initial blockage (the position freezes once open)
  Corners cs;
  bool found = false;
  for (int i = 0; i < kSkipSteps && !found; ++i) {
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rd[c];
    found = grid_alpha(a, cs, ro) < kOpenThresh;
  }

  // -- phase B: the screen-space trace toward the open point
  const float p0[3] = {a.pv[3 * lane], a.pv[3 * lane + 1], a.pv[3 * lane + 2]};
  float to[3];
  {
    const float q[3] = {ro[0] * a.inv_scale, ro[1] * a.inv_scale, ro[2] * a.inv_scale};
    for (int c = 0; c < 3; ++c) to[c] = xform(vfw, c, q[0], q[1], q[2]) - p0[c];
  }
  const float step_len0 = fmaxf(p0[2], 1.0f) * (1.0f + noise) * kInv100;
  const float xy_len = fmaxf(sqrtf(to[0] * to[0] + to[1] * to[1]), 1e-8f);
  const float dist = norm3(to[0], to[1], to[2]);
  float pos[3] = {p0[0], p0[1], p0[2]};
  float step[3];
  for (int c = 0; c < 3; ++c) step[c] = (to[c] / xy_len) * step_len0;
  float slen = step_len0, trav = 0.0f, res_u = 0.0f, res_v = 0.0f, res_slen = 0.0f;
  const float noff = noise * 0.2f;
  const float bf = 2.0f + noise;
  int status = 0;   // 0 marching, 1 off screen, 2 on to the voxel march, 3 resolved
  for (int i = 0; i < a.max_ss_steps; ++i) {
    for (int c = 0; c < 3; ++c) pos[c] = pos[c] + step[c];
    trav = trav + slen;
    const float cx = xform(cfv, 0, pos[0], pos[1], pos[2]);
    const float cy = xform(cfv, 1, pos[0], pos[1], pos[2]);
    const float cw = xform(cfv, 3, pos[0], pos[1], pos[2]);
    const float w = fabsf(cw) < 1e-8f ? 1e-8f : cw;
    const float nx = cx / w, ny = cy / w;
    if (fabsf(nx) > 1.0f || fabsf(ny) > 1.0f) {
      status = 1;
      break;
    }
    for (int c = 0; c < 3; ++c) step[c] = step[c] * 1.2f;
    slen = slen * 1.2f;
    const float u = nx * 0.5f + 0.5f, v = ny * 0.5f + 0.5f;
    const float d = depth_nearest(a, u, v);
    float s4[4];
    for (int r = 0; r < 4; ++r) s4[r] = xform(vfc, r, nx, ny, d);
    const float sw = fabsf(s4[3]) < 1e-8f ? 1e-8f : s4[3];
    const float surf[3] = {s4[0] / sw, s4[1] / sw, s4[2] / sw};
    if (norm3(surf[0], surf[1], surf[2]) < norm3(pos[0], pos[1], pos[2])) {
      // a crossing: its solidity from three alpha taps between surface and ray
      float t0[3], t1[3];
      for (int c = 0; c < 3; ++c) {
        t0[c] = xform(wfv, c, surf[0], surf[1], surf[2]) * a.half_scale + 0.5f;
        t1[c] = xform(wfv, c, pos[0], pos[1], pos[2]) * a.half_scale + 0.5f;
      }
      float asum = 0.0f;
      for (int k = 0; k < 3; ++k) {
        const float f = noff + (k == 0 ? 0.2f : k == 1 ? 0.4f : 0.6f);
        cs.load(a, t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                t0[2] + (t1[2] - t0[2]) * f);
        asum = asum + cs.alpha();
      }
      if (asum >= kSolid) {
        status = 3;
        res_u = u;
        res_v = v;
        res_slen = slen;
        break;
      }
      // translucent: boost the step and keep going
      for (int c = 0; c < 3; ++c) step[c] = step[c] * bf;
      slen = slen * bf;
    } else if (trav > dist) {
      status = 2;
      break;
    }
  }
  if (status == 0) status = 2;   // out of steps: on to the voxel march

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (status == 1) {
    // the lightgrid 2.5 voxels along the view direction
    float p[3], fb[3];
    for (int c = 0; c < 3; ++c)
      p[c] = a.pw[3 * lane + c] * a.scale + (2.5f * a.vd[3 * lane + c]) * a.voxel;
    cs.load(a, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
    cs.rgb(sm.decode, fb);
    tone_compress(fb, rgb);
  } else if (status == 3) {
    pyramid_resolve(a, sm.level_off, res_slen, res_u, res_v, a.ss_intensity, rgb);
  } else if (found) {
    // -- phase C: fog-march the grid from the open point
    float sum[4];
    cs.load(a, ro[0] * 0.5f + 0.5f, ro[1] * 0.5f + 0.5f, ro[2] * 0.5f + 0.5f);
    cs.rgb(sm.decode, sum);
    sum[3] = 1e-4f + 1.0f;
    const float fog = a.fog_lane != nullptr ? a.fog_lane[lane] : a.fog;
    float rdm[3];
    for (int c = 0; c < 3; ++c) {
      const float rd2 = rd[c] * a.step_scale;
      ro[c] = ro[c] + rd2 * noise;
      rdm[c] = 0.5f * rd2;
    }
    for (int i = 0; i < a.num_steps; ++i) {
      for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rdm[c];
      if (grid_alpha(a, cs, ro) > kHitThresh) break;
      float s[3];
      cs.rgb(sm.decode, s);
      for (int c = 0; c < 3; ++c) sum[c] = sum[c] * fog + s[c];
      sum[3] = sum[3] * fog + 1.0f;
    }
    const float w = fmaxf(sum[3], 1e-4f);
    const float mean[3] = {sum[0] / w, sum[1] / w, sum[2] / w};
    tone_compress(mean, rgb);
  }
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
}

__global__ void __launch_bounds__(kThreads) gi_reference_ray_kernel(const RefArgs a) {
  __shared__ Shared sm;
  const int tid = threadIdx.x;
  if (tid < 16) {
    sm.mats[tid] = a.view_from_world[tid];
    sm.mats[16 + tid] = a.clip_from_view[tid];
    sm.mats[32 + tid] = a.view_from_clip[tid];
    sm.mats[48 + tid] = a.world_from_view[tid];
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
  if (lane >= 0) ray(a, sm, lane);
}

}  // namespace

extern "C" int gi_reference_ray_launch(const RefArgs* args, int device, void* stream) {
  const RefArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.n > 0) {
    const int tw = 32 / a.tile_h;
    const long long tiles = (long long)((a.width + tw - 1) / tw) *
                            ((a.n / a.width + a.tile_h - 1) / a.tile_h);
    const int grid = (int)((tiles + kWarps - 1) / kWarps);
    gi_reference_ray_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// registers and local memory a thread, resident blocks an SM and threads a
// block of the compiled kernel, for chip_smoke.py
extern "C" int gi_reference_ray_occupancy(int* registers, int* local_bytes, int* blocks_per_sm,
                                          int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gi_reference_ray_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            gi_reference_ray_kernel, kThreads, 0);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
