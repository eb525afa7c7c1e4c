// The lighting pass for Hopper (sm_90a), everything but the GI rays
// (csrc/gi_fast_ray.cu runs those): three kernels.
//
// Replaces no Pallas kernel: the JAX package lights the frame as XLA code
// in the jitted frame, vulkan_pbr_renderer_tpu/shade/lighting.py:107
// lighting_pass (with :60 reconstruct_positions, :93 _up and :175
// sub_inputs), shade/gi_modes.py:52 bent_normal_cosine, :66 interleave_ops,
// :117 _specular_ray and :520 gi_pass's lane inputs, shade/shadow.py:84
// light_shafts_polar and shade/brdf.py:86 cook_torrance_direct.
//  - gi_inputs_kernel: a block per 2D tile of traced GI lanes, a thread a
//    lane (shade/gi_modes.py gi_lane_inputs_plain): at the subsampled
//    pixel's centre, its normal and roughness, the world and view positions
//    from its depth, the three frame noises, vd, the bent cosine normal and
//    the specular ray; the interleave's half ("columns" or "checker",
//    parity frame_idx % 2) is staged and written as 16-byte lines into
//    contiguous lane arrays (its note below).
//  - shafts_polar_kernel, launched once a frame by shafts_polar
//    (shade/shadow.py polar_profile_plain and shafts_polar_plain; its note
//    below): the per-frame polar profile of the sun map, n_theta x n_r
//    bilinear samples u16-quantized, in bands of theta rows, then a thread
//    per pixel of the shaft grid: its own inputs at the subsampled centre,
//    the row fetched by the dithered angle once its band is written, and
//    the n_r compares.
//  - shade_kernel: a block per 2D tile of full-resolution pixels, a thread
//    a pixel (shade/lighting.py shade_plain): positions, then the sky
//    classified first; for the rest noises, the 4-tap PCF read from the u16
//    sun map, Cook-Torrance direct, the split-sum weights from the f16 LUT,
//    the shafts and the GI (or the static IBL) with each low-resolution grid
//    upsampled by bloom._up2's exact 2x steps, and emissive; for the sky the
//    half-resolution sample from the tile's half texels, or the
//    full-resolution -v sample in a band; the clamp.
//
// Why kernels.  PyTorch runs these stages as ~1,600 eager operations a frame
// (the PCF's compare tree alone 466), and re-packs the 2048^2 sun map into
// a 134 MB u16 window table and the BRDF LUT into an f16 window table every
// frame.  The kernels read the quantized sun map (made once per sun change),
// the f16 LUT (made once), the G-buffer and the low-resolution grids where
// they lie.
//
// What bounds them on the card, counted: bytes.  shade_kernel reads 53 B of
// G-buffer a pixel and writes 12 B (~134 MB at 1920x1088: ~40 us at 3.35
// TB/s; its design note says what holds it in practice); the PCF's 16
// texels, the LUT and the low-resolution grids are read again from L1/L2.
// The GI lanes read ~20 B and write ~68 B each; the shafts read a 48-sample
// profile row per pixel from cache.
//
// The shade's design.  A thread per pixel in a linear order would make each
// block a 1x256 strip of one row, whose 4x4 sun-map windows, LUT texels and
// upsampled grids are shared with blocks on other SMs; a pixel would read
// 4^T texels of a grid T exact 2x steps below it (72 scalar loads a pixel
// on the fast-GI path), a sky pixel would run the whole BRDF before the sky
// replaces it and take 4 cube samples, and the G-buffer would come in 3
// scalar loads at a 12-byte stride.  So a block shades a 2D tile
// (SHADE_TILE_W x SHADE_TILE_H): it stages the tile's G-buffer rows in
// 16-byte lines, all in flight at once, and each grid's levels under the
// tile (level 0 from device memory, each level above from the one below,
// edge-clamped halo included) in shared memory, so a pixel takes one _up2
// step from shared memory; the staged texels are the values _up2
// computes, by the same arithmetic, so the bits do not change.  The sky is
// classified first (depth, unproject, world_bounds, coverage): sky pixels
// skip the PCF, the BRDF, the LUT and the IBL (their output is replaced),
// and where any pixel of the block is sky the half-resolution sky texels
// under the tile are computed once into shared memory.  The kernel is
// bound by its arithmetic's latency more than by bytes (IEEE divides,
// square roots and powf in long dependent chains), so SHADE_MIN_BLOCKS
// trades registers for resident warps.  The output leaves in 16-byte lines.
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// versions' operation order (shade_common.cuh lists what PyTorch does on
// the card).  Python numbers that PyTorch divides by (1/fw, 1/fh, 1/w,
// 1/(2 pi), 1/pi) come as their f32 reciprocals from the wrapper.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SHADE_CROSS_FMA
#define SHADE_CROSS_FMA 1
#endif

#include "shade_common.cuh"

using namespace shade;

namespace {

constexpr int kThreads = 256;

}  // namespace

// ---------------------------------------------------------------------------
// GI lane inputs

// shade/gi_modes.py::_GiArgs mirrors this struct field for field.
struct GiArgs {
  const float* normal;            // [h,w,3] G-buffer (the band's rows)
  const float* orm;               // [h,w,3]
  const float* depth;             // [h,w]
  const float* world_from_clip;   // [4,4]
  const float* view_from_clip;    // [4,4]
  const float* camera_pos;        // [3]
  float* pw;                      // [lanes,3]
  float* pv;                      // [lanes,3]
  float* vd;                      // [lanes,3] or null
  float* bent;                    // [lanes,3]
  float* spec;                    // [lanes,3] or null
  float* n3;                      // [lanes]
  float* rough;                   // [lanes] or null
  float inv_fw, inv_fh, noise_offset;
  int w, k, row_offset, rows, cols;   // the lane grid [rows, cols]
  int pattern, parity;                // 0 every lane, 1 columns, 2 checker
};

namespace {

// The traced column of lane (i, j): j itself, or under the interleave the
// parity's half ("checker": odd lane rows take the other parity).
__device__ __forceinline__ int lane_col(const GiArgs& a, int i, int j) {
  return a.pattern == 0 ? j
                        : 2 * j + (a.pattern == 1 || (i & 1) == 0 ? a.parity : 1 - a.parity);
}

// One lane's outputs.
struct LaneOut {
  float pw[3], pv[3], bent[3], vd[3], spec[3], n3, rough;
};

// One lane's arithmetic (gi_lane_inputs_plain) from its pixel's normal,
// roughness and depth: lane row i, traced column col.
__device__ __forceinline__ void gi_lane(const GiArgs& a, int i, int col, const float* n,
                                        float rough, float depth, LaneOut& o) {
  const float fk = (float)a.k;
  const float px = (float)col * fk + 0.5f;
  const float py = ((float)i * fk + (float)a.row_offset) + 0.5f;
  unproject(a.world_from_clip, ((float)col * fk + 0.5f) * a.inv_fw,
            (((float)i * fk + (float)a.row_offset) + 0.5f) * a.inv_fh, depth, o.pw);
  unproject(a.view_from_clip, ((float)col * fk + 0.5f) * a.inv_fw,
            (((float)i * fk + (float)a.row_offset) + 0.5f) * a.inv_fh, depth, o.pv);
  const float n1 = frame_noise(px, py, a.noise_offset, 0.0f, 0.0f);
  const float n2 = frame_noise(px, py, a.noise_offset, 90.0f, 20.0f);
  const float n3 = frame_noise(px, py, a.noise_offset, 522.0f, 55.0f);
  const float cam[3] = {a.camera_pos[0], a.camera_pos[1], a.camera_pos[2]};
  float vraw[3];
  for (int c = 0; c < 3; ++c) vraw[c] = cam[c] - o.pw[c];
  normalize3(vraw, o.vd);

  // bent_normal_cosine
  const float some[3] = {(float)0.7128864983, (float)0.8217892113, (float)0.948912748};
  float sv[3], tr[3], t[3], b[3];
  normalize3(some, sv);
  cross3(sv, n, tr);
  normalize3(tr, t);
  cross3(n, t, b);
  const float pitch = acosf(sqrtf(clampp(1.0f - n1, 0.0f, 1.0f)));
  const float yaw = (float)(2.0 * 3.14159265358979323846) * n3;
  const float sp = sinf(pitch);
  const float l0 = sp * cosf(yaw), l1 = sp * sinf(yaw), l2 = cosf(pitch);
  for (int c = 0; c < 3; ++c) o.bent[c] = (t[c] * l0 + b[c] * l1) + n[c] * l2;
  o.n3 = n3;
  o.rough = rough;
  if (a.spec != nullptr) {
    // _specular_ray: reflect(-vd, n), roughened by the noises, biased to n
    const float iv[3] = {-o.vd[0], -o.vd[1], -o.vd[2]};
    const float d2 = 2.0f * dot3(iv, n);
    const float nz[3] = {n1, n2, n3};
    const float rs = (float)0.6 * rough;
    float r[3], rn[3];
    for (int c = 0; c < 3; ++c) r[c] = (iv[c] - d2 * n[c]) + rs * (nz[c] - 0.5f);
    normalize3(r, rn);
    const float r2 = rough * rough;
    const float r4 = r2 * r2;
    for (int c = 0; c < 3; ++c) o.spec[c] = rn[c] + (n[c] - rn[c]) * r4;
  }
}

// The lane kernel's tile of lanes (a thread each) and the blocks an SM
// keeps resident (the register bound); -D values for a sweep
constexpr int kLaneW = 32, kLaneH = kThreads / kLaneW;
#ifndef LANE_MIN_BLOCKS
#define LANE_MIN_BLOCKS 6
#endif

// The GI lane inputs over 2D tiles of lanes.
//
// Why.  A thread per lane in a linear order wrote each of its seven output
// arrays as scalars at a 12-byte stride, 17 stores a lane, and a wrapper
// that rebuilt its struct, checks and outputs every call spent ~65 us of
// host time for 23 us of device time.  Now
// a block takes a kLaneW x kLaneH tile of the lane grid: each lane loads
// its own normal, roughness and depth (at k = 2 under the checker
// interleave a lane reads 20 of every 80 bytes of its pixel row: staging
// the rows in 16-byte lines read every byte and was slower on the H100,
// lanes_sweep.cu and PERF.md), runs gi_lane, and stages its outputs in
// shared memory; the block then writes each output array's tile rows as
// 16-byte lines where a row starts on one (the wrapper's plan puts every
// array on a 128-byte line), else as scalars.  The lane's arithmetic, a
// long dependent chain of IEEE divides, square roots and transcendentals,
// is what binds it: output lines and 6 resident blocks took ~12% off the
// device time.  The wrapper's struct and output layout live in a plan
// cached per shape (gi_modes._LanePlan).
__global__ void __launch_bounds__(kThreads, LANE_MIN_BLOCKS) gi_inputs_kernel(const GiArgs a) {
  __shared__ __align__(16) float out3[5][kLaneH][kLaneW * 3];   // pw pv bent vd spec
  __shared__ __align__(16) float out1[2][kLaneH][kLaneW];       // n3 rough
  const int tx = threadIdx.x % kLaneW, ty = threadIdx.x / kLaneW;
  const int j0 = blockIdx.x * kLaneW, i0 = blockIdx.y * kLaneH;
  const int i = i0 + ty, j = j0 + tx;
  if (i < a.rows && j < a.cols) {
    const int col = lane_col(a, i, j);
    const size_t p = (size_t)(i * a.k) * a.w + (size_t)(col * a.k);
    const float n[3] = {a.normal[3 * p], a.normal[3 * p + 1], a.normal[3 * p + 2]};
    LaneOut o;
    gi_lane(a, i, col, n, a.orm[3 * p + 1], a.depth[p], o);
    for (int c = 0; c < 3; ++c) {
      out3[0][ty][3 * tx + c] = o.pw[c];
      out3[1][ty][3 * tx + c] = o.pv[c];
      out3[2][ty][3 * tx + c] = o.bent[c];
      out3[3][ty][3 * tx + c] = o.vd[c];
      out3[4][ty][3 * tx + c] = o.spec[c];
    }
    out1[0][ty][tx] = o.n3;
    out1[1][ty][tx] = o.rough;
  }
  __syncthreads();
  const int nj = min(kLaneW, a.cols - j0);       // the tile's lanes a row
  float* const dsts[7] = {a.pw, a.pv, a.bent, a.vd, a.spec, a.n3, a.rough};
  for (int f = 0; f < 7; ++f) {
    float* dst = dsts[f];
    if (dst == nullptr) continue;
    const int wd = f < 5 ? 3 : 1;
    const int lines = kLaneW * wd / 4;           // 16-byte lines of a full tile row
    for (int e = threadIdx.x; e < kLaneH * lines; e += kThreads) {
      const int r = e / lines, q = e % lines;
      const int n_row = nj * wd;                 // floats of this tile row
      if (i0 + r >= a.rows || 4 * q >= n_row) continue;
      const long long at = ((long long)(i0 + r) * a.cols + j0) * wd + 4 * q;
      const float* s = f < 5 ? &out3[f][r][4 * q] : &out1[f - 5][r][4 * q];
      if ((at & 3) == 0 && 4 * q + 4 <= n_row) {
        *reinterpret_cast<float4*>(dst + at) = *reinterpret_cast<const float4*>(s);
      } else {
        for (int c = 0; c < 4 && 4 * q + c < n_row; ++c) dst[at + c] = s[c];
      }
    }
  }
}

}  // namespace

extern "C" int gi_inputs_launch(const GiArgs* args, int device, void* stream) {
  const GiArgs& a = *args;
  const long long n = (long long)a.rows * a.cols;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && n > 0)
    gi_inputs_kernel<<<dim3((a.cols + kLaneW - 1) / kLaneW, (a.rows + kLaneH - 1) / kLaneH),
                       kThreads, 0, (cudaStream_t)stream>>>(a);
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The lane kernel on the current card, for chip_smoke.py and
// tile_sweep.py: registers and local memory a thread, shared memory a
// block, resident blocks an SM.
extern "C" int gi_inputs_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                                   int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gi_inputs_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, gi_inputs_kernel,
                                                            kThreads, 0);
}

// ---------------------------------------------------------------------------
// polar light shafts

// shade/shadow.py::_ShaftArgs mirrors this struct field for field.
struct ShaftArgs {
  const float* sun_depth;         // [s,s]
  const float* sun_from_world;    // [4,4]
  const float* camera_pos;        // [3]
  short* profile;                 // [n_theta, n_r] u16 bit patterns (written, then read)
  const float* normal;            // [h,w,3] G-buffer (the band's rows)
  const float* depth;             // [h,w]
  const float* world_from_clip;   // [4,4]
  float* out;                     // [rows, cols, 3]
  unsigned* flags;                // a flag per band of SHAFT_BAND profile rows
  unsigned epoch;                 // this launch's mark, never 0, new every launch
  float theta_step, inv_two_pi, inv_fw, inv_fh, noise_offset, normal_offset, step_limit;
  float emission[3];              // intensity * sun emission
  int s, n_theta, n_r, max_steps, w, k, row_offset, rows, cols;
};

// The polar shafts in one launch.
//
// Why.  The profile (n_theta x n_r bilinear samples of the sun map) and the
// shaft pixels that read it were two launches of a thread per output, ~19
// us of device time for ~1.5 us of bytes: most of it the two launches and
// the wait between them, and each pixel read its profile row as n_r scalar
// loads.  Its wrapper spent ~65 us of host time a call.
//
// The design, the down chain's scheme (csrc/post.cu): a persistent grid of
// as many blocks as are resident at once walks its units in order, unit u
// on block u mod grid.  The profile's units come first, a band of
// SHAFT_BAND theta rows each; once a band is written its block releases
// the band's flag with the launch's epoch.  The pixel units follow, 256
// consecutive shaft pixels each: a pixel works out its inputs and its row
// kt first, then waits on the flag of kt's band alone, and reads the row
// from L2 (__ldcg) as 16-byte lines where n_r is a multiple of 8 (48: six
// lines; kt * n_r * 2 bytes from the profile's 256-byte aligned start),
// else as scalars.  No unit waits on a unit of higher index, and blocks
// already resident take their units in order, so with every block resident
// no wait can deadlock: the launch is cooperative, which refuses a grid
// that could not all be resident, at the occupancy query's size.  The
// wrapper's struct, profile buffer, flags and grid live in a plan cached
// per shape (shadow._ShaftPlan).
//
// Exactness: each profile sample and each pixel's arithmetic as the two
// launches had them; only the launch and the loads changed.

// the theta rows of a profile unit, the profile samples a thread loads at
// once and the blocks an SM keeps resident (the register bound); -D values
// for a sweep
#ifndef SHAFT_BAND
#define SHAFT_BAND 8
#endif
#ifndef SHAFT_BATCH
#define SHAFT_BATCH 2
#endif
#ifndef SHAFT_MIN_BLOCKS
#define SHAFT_MIN_BLOCKS 4
#endif

namespace {

constexpr int kBand = SHAFT_BAND;
constexpr int kProfileBatch = SHAFT_BATCH;

__device__ __forceinline__ void cam_sun(const ShaftArgs& a, float* cs) {
  const float* m = a.sun_from_world;
  for (int c = 0; c < 3; ++c)
    cs[c] = xform(m, c, a.camera_pos[0], a.camera_pos[1], a.camera_pos[2]);
}

// the profile's bin (kt, j) up to its texels: the sun map's four bilinear
// texels (read-only path) and the weights; cs the camera's sun-space
// position
struct ProfileTap {
  float v[4], fx, fy;
};

__device__ __forceinline__ void profile_tap(const ShaftArgs& a, const float* cs, int kt, int j,
                                            ProfileTap& p) {
  const float theta = ((float)kt + 0.5f) * a.theta_step;
  const float rho = ((float)j + 1.5f) * 0.0625f;
  const float x = ((cs[0] + cosf(theta) * rho) * 0.5f + 0.5f) * (float)a.s - 0.5f;
  const float y = ((cs[1] + sinf(theta) * rho) * 0.5f + 0.5f) * (float)a.s - 0.5f;
  // sampling.sample_bilinear, clamp addressing
  const float x0f = floorf(x), y0f = floorf(y);
  p.fx = x - x0f;
  p.fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int xa = clampi(x0, 0, a.s - 1), xb = clampi(x0 + 1, 0, a.s - 1);
  const int ya = clampi(y0, 0, a.s - 1), yb = clampi(y0 + 1, 0, a.s - 1);
  const float* d = a.sun_depth;
  p.v[0] = __ldg(d + (size_t)ya * a.s + xa);
  p.v[1] = __ldg(d + (size_t)ya * a.s + xb);
  p.v[2] = __ldg(d + (size_t)yb * a.s + xa);
  p.v[3] = __ldg(d + (size_t)yb * a.s + xb);
}

// the bin's value: the bilinear sample, u16-quantized
__device__ __forceinline__ short profile_finish(const ProfileTap& p) {
  return quantize_u16(bilerp(p.v[0], p.v[1], p.v[2], p.v[3], p.fx, p.fy));
}

__device__ __forceinline__ short profile_value(const ShaftArgs& a, const float* cs, int kt,
                                               int j) {
  ProfileTap p;
  profile_tap(a, cs, kt, j, p);
  return profile_finish(p);
}

// a shaft pixel's own part: its profile row kt and what its compares take
struct ShaftPixel {
  int kt;
  float r_xy, s, zr;
};

// the shaft pixel t of the [rows, cols] grid: its inputs at the subsampled
// centre, the dithered angle's row
__device__ ShaftPixel shaft_setup(const ShaftArgs& a, const float* cs, long long t) {
  const int i = (int)(t / a.cols), j = (int)(t % a.cols);
  const size_t p = (size_t)(i * a.k) * a.w + (size_t)(j * a.k);
  const float fk = (float)a.k;
  const float px = (float)j * fk + 0.5f;
  const float py = ((float)i * fk + (float)a.row_offset) + 0.5f;
  float pw[3];
  unproject(a.world_from_clip, px * a.inv_fw, py * a.inv_fh, a.depth[p], pw);
  const float noise = frame_noise(px, py, a.noise_offset, 0.0f, 0.0f);
  float q[3], delta[3];
  for (int c = 0; c < 3; ++c) q[c] = pw[c] + a.normal[3 * p + c] * a.normal_offset;
  for (int c = 0; c < 3; ++c) delta[c] = xform(a.sun_from_world, c, q[0], q[1], q[2]) - cs[c];
  const float dist = norm3(delta);
  ShaftPixel sp;
  sp.r_xy = sqrtf(delta[0] * delta[0] + delta[1] * delta[1]);
  const float ang = atan2f(delta[1], delta[0]);
  const float kf = (ang * a.inv_two_pi) * (float)a.n_theta + (noise - 0.5f);
  sp.kt = remainder_i((int)rintf(kf), a.n_theta);
  const float rc = maxp(sp.r_xy, (float)1e-6);
  sp.s = dist / rc;
  sp.zr = delta[2] / rc;
  return sp;
}

// bin jj's compare: a hit where the march sample is lit and active
__device__ __forceinline__ float shaft_hit(const ShaftArgs& a, const float* cs,
                                           const ShaftPixel& sp, int jj, short bin) {
  const float rho = ((float)jj + 1.5f) * 0.0625f;
  const float z = cs[2] + rho * sp.zr;
  const bool vis = z < dequant_u16(bin);
  const bool active = (rho <= sp.r_xy) && (rho * sp.s <= a.step_limit);
  return (active && vis) ? 1.0f : 0.0f;
}

__device__ __forceinline__ void shaft_store(const ShaftArgs& a, const ShaftPixel& sp, float hits,
                                            long long t) {
  const float acc = minp(hits * sp.s, (float)a.max_steps);
  for (int c = 0; c < 3; ++c) a.out[3 * t + c] = acc * a.emission[c];
}

// the n_r compares of pixel t on its profile row, written in this launch:
// read at L2, in 16-byte lines where n_r is a multiple of 8
__device__ void shaft_finish(const ShaftArgs& a, const float* cs, const ShaftPixel& sp,
                             long long t) {
  const size_t base = (size_t)sp.kt * a.n_r;
  float hits = 0.0f;
  if ((a.n_r & 7) == 0) {
    const uint4* row = reinterpret_cast<const uint4*>(a.profile + base);
    for (int q = 0; q < a.n_r / 8; ++q) {
      const uint4 v = __ldcg(row + q);
      const unsigned wds[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        hits += shaft_hit(a, cs, sp, 8 * q + e, (short)(wds[e >> 1] >> (16 * (e & 1))));
    }
  } else {
    const unsigned short* row = reinterpret_cast<const unsigned short*>(a.profile + base);
    for (int jj = 0; jj < a.n_r; ++jj) hits += shaft_hit(a, cs, sp, jj, (short)__ldcg(row + jj));
  }
  shaft_store(a, sp, hits, t);
}

__host__ __device__ __forceinline__ int shaft_bands(const ShaftArgs& a) {
  return (a.n_theta + kBand - 1) / kBand;
}

__host__ __device__ __forceinline__ int shaft_units(const ShaftArgs& a) {
  return shaft_bands(a) + (int)(((long long)a.rows * a.cols + kThreads - 1) / kThreads);
}

__global__ void __launch_bounds__(kThreads, SHAFT_MIN_BLOCKS) shafts_polar_kernel(
    const __grid_constant__ ShaftArgs a) {
  float cs[3];
  cam_sun(a, cs);
  const int bands = shaft_bands(a), units = shaft_units(a);
  const long long px = (long long)a.rows * a.cols;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    if (u < bands) {   // a band of profile rows, then its flag
      // kProfileBatch samples a thread at a time, all their texel loads in
      // flight before the first is used
      const int t1 = min((u + 1) * kBand, a.n_theta) * a.n_r;
      for (int tb = u * kBand * a.n_r + threadIdx.x; tb < t1; tb += kProfileBatch * kThreads) {
        ProfileTap tap[kProfileBatch];
#pragma unroll
        for (int q = 0; q < kProfileBatch; ++q) {
          const int t = tb + q * kThreads;
          if (t < t1) profile_tap(a, cs, t / a.n_r, t % a.n_r, tap[q]);
        }
#pragma unroll
        for (int q = 0; q < kProfileBatch; ++q) {
          const int t = tb + q * kThreads;
          if (t < t1) a.profile[t] = profile_finish(tap[q]);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) st_release(a.flags + u, a.epoch);
    } else {           // 256 shaft pixels, each waiting on its row's band
      const long long t = (long long)(u - bands) * kThreads + threadIdx.x;
      if (t < px) {
        const ShaftPixel sp = shaft_setup(a, cs, t);
        wait_flag(a.flags + sp.kt / kBand, a.epoch);
        shaft_finish(a, cs, sp, t);
      }
    }
  }
}

}  // namespace

// The shafts in one cooperative launch on `device` (made current for the
// call): as many blocks as are resident at once on the card, at most one
// per unit.
extern "C" int shafts_polar_launch(const ShaftArgs* args, int device, void* stream) {
  static int resident[64];   // blocks of the kernel resident at once, per device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shafts_polar_kernel, kThreads,
                                                          0);
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err == cudaSuccess && (long long)args->rows * args->cols > 0) {
    const int grid = min(shaft_units(*args), resident[device]);
    void* params[] = {const_cast<ShaftArgs*>(args)};
    err = cudaLaunchCooperativeKernel((const void*)shafts_polar_kernel, dim3(grid),
                                      dim3(kThreads), params, 0, (cudaStream_t)stream);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The flags a launch of these args needs: one per band of profile rows
// (shadow._ShaftPlan sizes its flag buffer by it).
extern "C" int shafts_polar_flags(const ShaftArgs* args) { return shaft_bands(*args); }

// The shafts kernel on the current card, for chip_smoke.py and
// tile_sweep.py: registers and local memory a thread, shared memory a
// block, resident blocks an SM.
extern "C" int shafts_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                                int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shafts_polar_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, shafts_polar_kernel,
                                                            kThreads, 0);
}

// ---------------------------------------------------------------------------
// full-resolution shading

// shade/lighting.py::_ShadeArgs mirrors this struct field for field.
struct ShadeArgs {
  const float* base_color;        // [h,w,3] G-buffer (the band's rows)
  const float* normal;
  const float* orm;
  const float* emissive;
  const float* depth;             // [h,w]
  const bool* coverage;           // [h,w]
  const short* sun_map;           // [s,s] u16 bit patterns, or null (shadows off)
  const __half* lut;              // [lh,lw,2] f16, or null
  const __half* env;              // [6,es,ewa,12] f16 window-packed cube mip atlas
  const float* shafts;            // [sh_h,sh_w,3] or null
  const float* ambient;           // [gh,gw,3] or null (GI off)
  const float* spec;              // [gh,gw,3]
  const float* world_from_clip;   // [4,4]
  const float* sun_from_world;    // [4,4]
  const float* camera_pos;        // [3]
  const float* sun_dir;           // [3]
  float* out;                     // [h,w,3]
  float emission[3];              // sun emission
  float inv_fw, inv_fh, inv_w, inv_s, inv_pi, noise_offset, normal_offset, f0_dielectric,
      emissive_scale, world_bounds;
  int h, w, row_offset, fh, s, lh, lw, es, ewa, env_levels;
  int sh_h, sh_w, sh_steps, gh, gw, g_steps;
  int ibl, sky_half;
};

namespace {

// The tile a block shades (SHADE_TILE_W x SHADE_TILE_H pixels, a thread
// each) and the blocks it asks to keep resident on an SM; -D values for a
// sweep.
#ifndef SHADE_TILE_W
#define SHADE_TILE_W 16
#endif
#ifndef SHADE_TILE_H
#define SHADE_TILE_H 16
#endif
#ifndef SHADE_MIN_BLOCKS
#define SHADE_MIN_BLOCKS 6
#endif

constexpr int kTileW = SHADE_TILE_W, kTileH = SHADE_TILE_H;
static_assert(kTileW * kTileH == kThreads, "a thread per pixel of the tile");
static_assert(kTileW % 4 == 0 && kTileH % 2 == 0, "even tiles of 16-byte rows");
constexpr int kRowFloats = kTileW * 3;
// A staged level's region: the texels under the tile and one each side.
// The level under the tile spans at most half the tile plus 2; each deeper
// level half the one above plus 3, which never grows past 6.
constexpr int kRegRows = kTileH / 2 + 2 > 6 ? kTileH / 2 + 2 : 6;
constexpr int kRegCols = kTileW / 2 + 2 > 6 ? kTileW / 2 + 2 : 6;
constexpr int kRegTexels = kRegRows * kRegCols;
constexpr int kMaxSteps = 3;   // lighting._up_steps
constexpr int kSky = 3;        // the region slot of the half-resolution sky

// texels [r0, r0 + rows) x [c0, c0 + cols) of one level, stored densely
struct Region {
  int r0, c0, rows, cols;
};

struct ShadeSmem {
  // the tile's base_color, normal, orm and emissive rows; then [0] holds
  // the shaded rows on their way out
  float gb[4][kTileH * kRowFloats];
  // levels 0 .. steps-1 of the shafts, the GI ambient and the GI spec under
  // the tile (level steps-1 the one each pixel's _up2 step reads)
  float grid[3][kMaxSteps][kRegTexels * 3];
  float sky[kRegTexels * 3];   // the half-resolution sky under the tile
  Region reg[4][kMaxSteps];    // [shafts, ambient, spec, sky][level]
};

// shadow.sun_visibility + sampling.sample_pcf4_window_split, read from the
// [s,s] u16 map through the read-only path: 4 bilinear compare taps on the
// 4x4 window at the base texel
__device__ float sun_visibility(const ShadeArgs& a, const float* pw, const float* n, float n1,
                                float n2) {
  float q[3], sp[3];
  for (int c = 0; c < 3; ++c) q[c] = pw[c] + n[c] * a.normal_offset;
  for (int c = 0; c < 3; ++c) sp[c] = xform(a.sun_from_world, c, q[0], q[1], q[2]);
  const float u = (sp[0] * 0.5f + 0.5f) + (2.0f * (n2 - 0.5f)) * a.inv_s;
  const float v = (sp[1] * 0.5f + 0.5f) + (2.0f * (n1 - 0.5f)) * a.inv_s;
  const float ref = sp[2];
  const int s = a.s;
  const float p0 = u * (float)s - 0.5f, p1 = v * (float)s - 0.5f;
  const int bx = clampi((int)floorf(p0) - 1, 0, s - 4);
  const int by = clampi((int)floorf(p1) - 1, 0, s - 4);
  // the 16 compares as bits (bit 4 i + j), so that no array lives in local
  // memory
  unsigned cmp = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      cmp |= (ref < dequant_u16(__ldg(a.sun_map + (size_t)(by + i) * s + bx + j)) ? 1u : 0u)
             << (4 * i + j);
  const float offs[4][2] = {{0.75f, 0.25f}, {-0.25f, 0.75f}, {0.25f, -0.75f}, {-0.75f, -0.25f}};
  float vis = 0.0f;
  for (int o = 0; o < 4; ++o) {
    const float tx = p0 + offs[o][0], ty = p1 + offs[o][1];
    const int x0 = (int)floorf(tx), y0 = (int)floorf(ty);
    const float fx = tx - (float)x0, fy = ty - (float)y0;
    const int ux = clampi(x0 - bx, 0, 2), uy = clampi(y0 - by, 0, 2);
    const unsigned row = cmp >> (4 * uy + ux);
    const float c00 = (row & 1u) ? 1.0f : 0.0f, c10 = (row & 2u) ? 1.0f : 0.0f;
    const float c01 = (row & 16u) ? 1.0f : 0.0f, c11 = (row & 32u) ? 1.0f : 0.0f;
    const float top = c00 + (c10 - c00) * fx;
    const float bot = c01 + (c11 - c01) * fx;
    vis = (vis + top) + (bot - top) * fy;
  }
  return vis * 0.25f;
}

// sampling.sample_bilinear_window of the 2x2-packed LUT, read from the f16
// [lh,lw,2] table (a texel's two channels as one half2) with the pack's
// edge clamp
__device__ void lut_sample(const ShadeArgs& a, float u, float v, float* out) {
  const float x = u * (float)a.lw - 0.5f, y = v * (float)a.lh - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x0f < 0.0f ? 0.0f : x - x0f;
  const float fy = y0f < 0.0f ? 0.0f : y - y0f;
  const int ix = clampi((int)x0f, 0, a.lw - 1), iy = clampi((int)y0f, 0, a.lh - 1);
  const int ix1 = min(ix + 1, a.lw - 1), iy1 = min(iy + 1, a.lh - 1);
  const __half2* t = reinterpret_cast<const __half2*>(a.lut);
  const float2 t00 = __half22float2(__ldg(t + (size_t)iy * a.lw + ix));
  const float2 t10 = __half22float2(__ldg(t + (size_t)iy * a.lw + ix1));
  const float2 t01 = __half22float2(__ldg(t + (size_t)iy1 * a.lw + ix));
  const float2 t11 = __half22float2(__ldg(t + (size_t)iy1 * a.lw + ix1));
  out[0] = bilerp(t00.x, t10.x, t01.x, t11.x, fx, fy);
  out[1] = bilerp(t00.y, t10.y, t01.y, t11.y, fx, fy);
}

// brdf.fresnel_schlick(cos, f0) = f0 + (1 - f0) * pow(1 - clamp(cos), 5):
// the power, the same for the three channels, taken once
__device__ __forceinline__ float schlick_pow(float cos_theta) {
  return powf(1.0f - clampp(cos_theta, 0.0f, 1.0f), 5.0f);
}
__device__ __forceinline__ float fresnel(float pw5, float f0) { return f0 + (1.0f - f0) * pw5; }

// the half-resolution sky at half texel (ia, ib): level 0 along the ray
// through the texel's far point
__device__ void sky_half_texel(const ShadeArgs& a, int ia, int ib, float* out) {
  const float hu = ((float)ib * 2.0f + 1.0f) * a.inv_w;
  const float hv = (((float)ia * 2.0f + (float)a.row_offset) + 1.0f) * a.inv_fh;
  const float nx = hu * 2.0f - 1.0f, ny = hv * 2.0f - 1.0f;
  const float* m = a.world_from_clip;
  const float w4 = xform(m, 3, nx, ny, 0.5f);
  float ray[3];
  for (int c = 0; c < 3; ++c) ray[c] = xform(m, c, nx, ny, 0.5f) / w4 - a.camera_pos[c];
  cube_sample_level(a.env, a.es, a.ewa, ray, 0, out);
}

// grid g (0 shafts, 1 ambient, 2 spec, kSky the half-resolution sky): its
// texels in device memory (null for the sky), size and exact 2x steps
// (0: none, or the grid is off)
__device__ __forceinline__ const float* grid_of(const ShadeArgs& a, int g, int* gh, int* gw,
                                               int* steps) {
  if (g == 0) {
    *gh = a.sh_h, *gw = a.sh_w, *steps = a.shafts ? a.sh_steps : 0;
    return a.shafts;
  }
  if (g == kSky) {
    *gh = a.h >> 1, *gw = a.w >> 1, *steps = a.sky_half;
    return nullptr;
  }
  *gh = a.gh, *gw = a.gw, *steps = a.ambient ? a.g_steps : 0;
  return g == 1 ? a.ambient : a.spec;
}

// The regions of levels 0 .. steps-1 of a [gh, gw] grid that the tile's
// pixels [y0, y1] x [x0, x1] reach through `steps` exact 2x steps: each
// level the texels under the one above and their edge-clamped neighbours
__device__ void grid_regions(int gh, int gw, int steps, int y0, int y1, int x0, int x1,
                             Region* reg) {
  for (int k = steps - 1; k >= 0; --k) {
    const int lh = gh << k, lw = gw << k;
    y0 = max((y0 >> 1) - 1, 0);
    y1 = min((y1 >> 1) + 1, lh - 1);
    x0 = max((x0 >> 1) - 1, 0);
    x1 = min((x1 >> 1) + 1, lw - 1);
    reg[k] = Region{y0, x0, y1 - y0 + 1, x1 - x0 + 1};
  }
}

// bloom._up2 at texel (i, j) of the level above a staged level p of size
// [lh, lw]: rows first, then columns, each 0.75 the texel and 0.25 its
// edge-clamped neighbour on (i, j)'s side (the arithmetic of up2_row and
// up_texel in csrc/post.cu)
__device__ __forceinline__ void up2_from(const float* s, const Region& p, int lh, int lw, int i,
                                         int j, float* out) {
  const int pi = i >> 1, pj = j >> 1;
  const int ni = (i & 1) ? min(pi + 1, lh - 1) : max(pi - 1, 0);
  const int nj = (j & 1) ? min(pj + 1, lw - 1) : max(pj - 1, 0);
  const float* ta = s + ((pi - p.r0) * p.cols + (pj - p.c0)) * 3;
  const float* tb = s + ((ni - p.r0) * p.cols + (pj - p.c0)) * 3;
  const float* tc = s + ((pi - p.r0) * p.cols + (nj - p.c0)) * 3;
  const float* td = s + ((ni - p.r0) * p.cols + (nj - p.c0)) * 3;
  for (int k = 0; k < 3; ++k) {
    const float r0 = 0.75f * ta[k] + 0.25f * tb[k];
    const float r1 = 0.75f * tc[k] + 0.25f * td[k];
    out[k] = 0.75f * r0 + 0.25f * r1;
  }
}

// lighting._up of grid g at full-resolution pixel (y, x): the pixel's one
// _up2 step from the staged level below it, or the grid's own texel
__device__ __forceinline__ void grid_at(const ShadeArgs& a, const ShadeSmem& sm, int g, int y,
                                        int x, float* out) {
  int gh, gw, steps;
  const float* src = grid_of(a, g, &gh, &gw, &steps);
  if (steps == 0) {
    const float* p = src + ((size_t)y * gw + x) * 3;
    for (int k = 0; k < 3; ++k) out[k] = __ldg(p + k);
  } else {
    up2_from(sm.grid[g][steps - 1], sm.reg[g][steps - 1], gh << (steps - 1), gw << (steps - 1),
             y, x, out);
  }
}

// The tile's rows move as 16-byte lines: line q is row q / kLines, floats
// [4 (q % kLines), +4) of the row's kRowFloats; each thread moves at most
// kLineIters lines of a field.
constexpr int kLines = kRowFloats / 4;
constexpr int kLineIters = (kTileH * kLines + kThreads - 1) / kThreads;

// m (1-4) floats at p: one 16-byte load where the line is whole and aligned
__device__ __forceinline__ float4 load_line(const float* p, int m) {
  if (m == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(__ldg(p), 0.0f, 0.0f, 0.0f);
  if (m > 1) v.y = __ldg(p + 1);
  if (m > 2) v.z = __ldg(p + 2);
  if (m > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ void store_line(float* p, float4 v, int m) {
  if (m == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (m > 1) p[1] = v.y;
  if (m > 2) p[2] = v.z;
  if (m > 3) p[3] = v.w;
}

// The frame's floats in line it of this thread: the line's offset in an
// [h, w, 3] field (*g) and in the tile's rows (*t), and how many of its 4
// floats lie in the frame (0: none)
__device__ __forceinline__ int tile_line(const ShadeArgs& a, int it, int y0, int x0, size_t* g,
                                         int* t) {
  const int q = threadIdx.x + it * kThreads, r = q / kLines, c = 4 * (q - r * kLines);
  const int n = min(kTileW, a.w - x0) * 3;
  if (q >= kTileH * kLines || y0 + r >= a.h || c >= n) return 0;
  *g = ((size_t)(y0 + r) * a.w + x0) * 3 + c;
  *t = r * kRowFloats + c;
  return min(4, n - c);
}

// The tile's rows of the four G-buffer fields into shared memory, every
// line of them in flight before the first is stored
__device__ void stage_gbuffer(const ShadeArgs& a, ShadeSmem& sm, int y0, int x0) {
  const float* fields[4] = {a.base_color, a.normal, a.orm, a.emissive};
  float4 v[kLineIters][4];
#pragma unroll
  for (int it = 0; it < kLineIters; ++it) {
    size_t g;
    int t;
    const int m = tile_line(a, it, y0, x0, &g, &t);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (m > 0) v[it][k] = load_line(fields[k] + g, m);
  }
#pragma unroll
  for (int it = 0; it < kLineIters; ++it) {
    size_t g;
    int t;
    const int m = tile_line(a, it, y0, x0, &g, &t);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (m > 0) store_line(sm.gb[k] + t, v[it][k], m);
  }
}

// The tile's shaded rows (gb[0]) out to the frame
__device__ void store_tile(const ShadeArgs& a, const ShadeSmem& sm, int y0, int x0) {
#pragma unroll
  for (int it = 0; it < kLineIters; ++it) {
    size_t g;
    int t;
    const int m = tile_line(a, it, y0, x0, &g, &t);
    if (m > 0) store_line(a.out + g, *reinterpret_cast<const float4*>(sm.gb[0] + t), m);
  }
}

// Everything but the sky at a covered, in-bounds pixel: PCF x
// Cook-Torrance, the shafts, the split-sum GI or IBL and emissive
// (shade_plain's order); the G-buffer from the tile's rows (slot t)
__device__ void shade_lit(const ShadeArgs& a, const ShadeSmem& sm, int t, int y, int x,
                          const float* pw, float px, float py, float* out) {
  const float* gbc = sm.gb[0] + t;
  const float* gn = sm.gb[1] + t;
  const float* gorm = sm.gb[2] + t;
  const float bc[3] = {gbc[0], gbc[1], gbc[2]};
  const float n[3] = {gn[0], gn[1], gn[2]};
  const float rough = gorm[1], metal = gorm[2];
  const float n1 = frame_noise(px, py, a.noise_offset, 0.0f, 0.0f);
  const float n2 = frame_noise(px, py, a.noise_offset, 90.0f, 20.0f);
  float vraw[3], v[3];
  for (int c = 0; c < 3; ++c) vraw[c] = a.camera_pos[c] - pw[c];
  normalize3(vraw, v);
  const float vdn = maxp(dot3(v, n), 0.0f);

  // sun: PCF visibility x Cook-Torrance direct (brdf.cook_torrance_direct)
  const float vis = a.sun_map != nullptr ? sun_visibility(a, pw, n, n1, n2) : 1.0f;
  const float l[3] = {-a.sun_dir[0], -a.sun_dir[1], -a.sun_dir[2]};
  float hun[3], hv[3];
  for (int c = 0; c < 3; ++c) hun[c] = l[c] + v[c];
  const float hn = maxp(norm3(hun), (float)1e-8);
  for (int c = 0; c < 3; ++c) hv[c] = hun[c] / hn;
  const float ndl = maxp(dot3(n, l), 0.0f);
  const float ndv = maxp(dot3(n, v), 0.0f);
  const float vdh = maxp(dot3(v, hv), 0.0f);
  const float ndh = maxp(dot3(n, hv), 0.0f);
  float f0[3];
  for (int c = 0; c < 3; ++c) f0[c] = a.f0_dielectric * (1.0f - metal) + bc[c] * metal;
  const float al = rough * rough;
  const float a2 = al * al;
  const float dd = ndh * ndh * (a2 - 1.0f) + 1.0f;
  const float d = a2 / ((float)3.14159265358979323846 * dd * dd);
  const float vh = maxp(vdh, (float)1e-6);
  const float g = minp(minp(2.0f * ndh * ndv / vh, 2.0f * ndh * ndl / vh), 1.0f);
  const float gd = g * d / maxp(4.0f * ndl * ndv, (float)1e-4);
  const float p_vdh = schlick_pow(vdh), p_ndv = schlick_pow(ndv);
  for (int c = 0; c < 3; ++c) {
    const float spec = fresnel(p_vdh, f0[c]) * gd;
    const float kd = (1.0f - fresnel(p_ndv, f0[c])) * (1.0f - metal);
    const float o = (kd * bc[c]) * a.inv_pi + spec;
    const float direct = ndl > 0.0f ? o * ndl : 0.0f;
    out[c] = 0.0f + (vis * direct) * a.emission[c];
  }

  if (a.shafts != nullptr) {
    float sh[3];
    grid_at(a, sm, 0, y, x, sh);
    for (int c = 0; c < 3; ++c) out[c] = out[c] + sh[c];
  }

  if (a.lut != nullptr) {
    float sb[2];
    lut_sample(a, vdn, maxp(rough, (float)0.05), sb);
    float kd[3];
    const float p_vdn = schlick_pow(vdn);
    for (int c = 0; c < 3; ++c) kd[c] = (1.0f - fresnel(p_vdn, f0[c])) * (1.0f - metal);
    if (a.ambient != nullptr) {
      float amb[3], spc[3];
      grid_at(a, sm, 1, y, x, amb);
      grid_at(a, sm, 2, y, x, spc);
      for (int c = 0; c < 3; ++c) out[c] = out[c] + (kd[c] * amb[c]) * bc[c];
      for (int c = 0; c < 3; ++c) out[c] = out[c] + spc[c] * (f0[c] * sb[0] + sb[1]);
    } else if (a.ibl) {
      float irr[3];
      cube_sample_level(a.env, a.es, a.ewa, n, min(4, a.env_levels - 1), irr);
      for (int c = 0; c < 3; ++c) out[c] = out[c] + (kd[c] * irr[c]) * bc[c];
      const float iv[3] = {-v[0], -v[1], -v[2]};
      const float d2 = 2.0f * dot3(iv, n);
      const float r2 = rough * rough;
      const float r4 = r2 * r2;
      float r[3];
      for (int c = 0; c < 3; ++c) {
        const float rr = iv[c] - d2 * n[c];
        r[c] = rr + (n[c] - rr) * r4;
      }
      float spc[3];
      cube_sample_lod(a.env, a.es, a.ewa, a.env_levels, r, rough * 4.0f, spc);
      for (int c = 0; c < 3; ++c) out[c] = out[c] + spc[c] * (f0[c] * sb[0] + sb[1]);
    }
  }
  const float* gem = sm.gb[3] + t;
  for (int c = 0; c < 3; ++c) out[c] = out[c] + gem[c] * a.emissive_scale;
}

// A block shades a kTileW x kTileH tile of the frame (or band), a thread a
// pixel.  It stages the tile's G-buffer rows and the low-resolution grids
// under the tile in shared memory, classifies the sky first, shades the
// rest, computes the half-resolution sky under the tile once where any
// pixel of it is sky, and writes its rows back in 16-byte lines.
__global__ void __launch_bounds__(kThreads, SHADE_MIN_BLOCKS)
    shade_kernel(const __grid_constant__ ShadeArgs a) {
  __shared__ __align__(16) ShadeSmem sm;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x1 = min(x0 + kTileW, a.w) - 1, y1 = min(y0 + kTileH, a.h) - 1;
  const int lx = threadIdx.x % kTileW, ly = threadIdx.x / kTileW;
  const int x = x0 + lx, y = y0 + ly;
  const bool valid = x < a.w && y < a.h;
  const int t = ly * kRowFloats + lx * 3;

  if (threadIdx.x <= kSky) {
    int gh, gw, steps;
    grid_of(a, threadIdx.x, &gh, &gw, &steps);
    grid_regions(gh, gw, steps, y0, y1, x0, x1, sm.reg[threadIdx.x]);
  }
  __syncthreads();
  stage_gbuffer(a, sm, y0, x0);
  // level 0 of each upsampled grid from device memory, then each level
  // above it from the one below, up to the level under the pixels
  int max_steps = 0;
  for (int g = 0; g < 3; ++g) {
    int gh, gw, steps;
    const float* src = grid_of(a, g, &gh, &gw, &steps);
    max_steps = max(max_steps, steps);
    if (steps == 0) continue;
    const Region r = sm.reg[g][0];
    for (int q = threadIdx.x; q < r.rows * r.cols; q += kThreads) {
      const int i = q / r.cols, j = q - i * r.cols;
      const float* p = src + ((size_t)(r.r0 + i) * gw + r.c0 + j) * 3;
      for (int k = 0; k < 3; ++k) sm.grid[g][0][q * 3 + k] = __ldg(p + k);
    }
  }
  __syncthreads();
  for (int lv = 1; lv < max_steps; ++lv) {
    for (int g = 0; g < 3; ++g) {
      int gh, gw, steps;
      grid_of(a, g, &gh, &gw, &steps);
      if (steps <= lv) continue;
      const Region r = sm.reg[g][lv], p = sm.reg[g][lv - 1];
      for (int q = threadIdx.x; q < r.rows * r.cols; q += kThreads) {
        const int i = q / r.cols, j = q - i * r.cols;
        up2_from(sm.grid[g][lv - 1], p, gh << (lv - 1), gw << (lv - 1), r.r0 + i, r.c0 + j,
                 sm.grid[g][lv] + q * 3);
      }
    }
    __syncthreads();
  }

  // the sky first: out of bounds or uncovered
  float pw[3];
  float px = 0.0f, py = 0.0f;
  bool sky = false;
  if (valid) {
    const size_t p = (size_t)y * a.w + x;
    px = (float)x + 0.5f;
    py = ((float)y + (float)a.row_offset) + 0.5f;
    unproject(a.world_from_clip, px * a.inv_fw, py * a.inv_fh, __ldg(a.depth + p), pw);
    sky = fabsf(pw[0]) > a.world_bounds || fabsf(pw[1]) > a.world_bounds ||
          fabsf(pw[2]) > a.world_bounds || !a.coverage[p];
  }
  if (__syncthreads_or(sky && a.sky_half)) {
    // the half-resolution sky texels under the tile, once each
    const Region r = sm.reg[kSky][0];
    for (int q = threadIdx.x; q < r.rows * r.cols; q += kThreads) {
      const int i = q / r.cols;
      sky_half_texel(a, r.r0 + i, r.c0 + q - i * r.cols, sm.sky + q * 3);
    }
    __syncthreads();
  }
  if (valid) {
    float out[3];
    if (!sky) {
      shade_lit(a, sm, t, y, x, pw, px, py, out);
    } else if (a.sky_half) {
      // _up of the half-resolution sky: four half texels, rows then columns
      up2_from(sm.sky, sm.reg[kSky][0], a.h >> 1, a.w >> 1, y, x, out);
    } else {
      float vraw[3], v[3];
      for (int c = 0; c < 3; ++c) vraw[c] = a.camera_pos[c] - pw[c];
      normalize3(vraw, v);
      const float mv[3] = {-v[0], -v[1], -v[2]};
      cube_sample_level(a.env, a.es, a.ewa, mv, 0, out);
    }
    // the pixel's own base_color slot, read above, takes its output
    for (int c = 0; c < 3; ++c) sm.gb[0][t + c] = maxp(out[c], 0.0f);
  }
  __syncthreads();
  store_tile(a, sm, y0, x0);
}

}  // namespace

extern "C" int shade_launch(const ShadeArgs* args, void* stream) {
  const ShadeArgs& a = *args;
  if (a.h <= 0 || a.w <= 0) return (int)cudaGetLastError();
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
  shade_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The shade kernel's registers and local memory a thread (spills land
// there), shared memory a block, resident blocks an SM and its tile, for
// chip_smoke.py.
extern "C" int shade_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                               int* blocks_per_sm, int* tile_w, int* tile_h) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shade_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *tile_w = kTileW;
  *tile_h = kTileH;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, shade_kernel,
                                                            kThreads, 0);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
