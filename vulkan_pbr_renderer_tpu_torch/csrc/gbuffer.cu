// The G-buffer for Hopper (sm_90a): a block per 2D tile of pixels.
//
// Replaces no Pallas kernel: the JAX package builds its G-buffer as XLA
// code in the jitted frame, vulkan_pbr_renderer_tpu/shade/gbuffer.py:123
// gbuffer_pass (with :43 pack_gbuffer_static, :64 pack_gbuffer_row, :85
// _lambda_and_derivs, :108 _interp).  It computes shade/gbuffer.py's
// gbuffer_pass_plain: per pixel, its triangle's perspective-correct
// barycentrics and their exact screen derivatives; the world position
// unprojected from the raster's depth and its pixel derivatives by the
// quotient rule on the raster's z; the uv footprint's lod; the material
// fetch from the u8 layered window atlas (nearest mip, trilinear, or the
// nearest mip dithered by the frame noise at offset (71, 13)); the alpha
// test; pow(base, 2.2); the derivative TBN with the mirrored-uv rule; the
// jitter-free velocity.  It writes the seven GBuffer fields, with normal
// (0, 0, 1), depth 1.0 and zeros where the pixel is not covered.
//
// Why a kernel.  PyTorch runs the plain version as ~440 eager operations a
// frame, among them a [T,29] row table concatenated every frame (74 MB at
// 638,700 triangles) and gathered to [H,W,29] (242 MB at 1920x1088).  Here
// a thread reads its triangle's rows where they lie: the raster's adj (36 B)
// and z_vert (12 B), and the per-scene attribute row of gbuffer_static (64
// B: uv, the f16-rounded normals, 2 * material + alpha flag), then its
// texels of the material atlas (48 B each).  Nothing is packed and no
// intermediate goes to device memory.
//
// What bounds it on the card: bytes.  A pixel reads its depth and id (8 B)
// and writes 57 B; the triangle rows and the atlas texels are read once per
// distinct triangle or texel (~72 MB of triangle rows at most, the atlas
// whole at most).  ~0.6 GFLOP a frame is ~10 us at the f32 peak.  The
// design serves the bytes:
//  - a block is a kTileW x kTileH tile of pixels, a thread a pixel:
//    neighbouring pixels share triangles and atlas rows, which a tile
//    serves from L1; a pixel no triangle covers writes its constants and
//    does nothing else (16% of path A's frame is sky), and one the alpha
//    test cuts stops there;
//  - a thread issues its triangle's loads (9 + 3 scalars of adj and z_vert,
//    whose rows are not 16-byte aligned, and the 64-byte attribute row as
//    four float4) on the read-only path before it uses any of them, and
//    reads each 48-byte atlas texel as three 16-byte loads;
//  - the matrices and the dequantization scales sit in shared memory;
//  - the seven outputs are staged in shared memory per tile and leave as
//    16-byte lines of their [H, W, c] rows, not 20 scalar stores a pixel at
//    12- and 8-byte strides.
// On the H100 the kernel is bound by its arithmetic more than its bytes
// (~30 IEEE divides, three accurate powf, log2f and square roots a
// covered pixel, in dependent chains): skipping the sky moved it most; the
// tile's shape (32x8, 16x16, 64x4) is within 1%, 3 blocks an SM (80
// registers) lost, 5 (48) spilled (tile_sweep.py, PERF.md).
//
// Exactness: compiled with -fmad=false and without fast math, in the plain
// version's operation order (shade_common.cuh lists what PyTorch does on
// the card); the material dequantization scale is tex_scale * (1/255) in
// f32 as PyTorch takes scale / 255.0 on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef SHADE_CROSS_FMA
#define SHADE_CROSS_FMA 1
#endif

#include "shade_common.cuh"

using namespace shade;

// the tile (pixels) and the blocks an SM keeps resident (the register
// bound); -D values for a sweep
#ifndef GB_TILE_W
#define GB_TILE_W 32
#endif
#ifndef GB_TILE_H
#define GB_TILE_H 8
#endif
#ifndef GB_MIN_BLOCKS
#define GB_MIN_BLOCKS 4
#endif

namespace {

constexpr int kTileW = GB_TILE_W, kTileH = GB_TILE_H, kThreads = kTileW * kTileH;
static_assert(kThreads == 256, "a block is 256 threads, a pixel each");
static_assert(kTileW % 16 == 0, "a tile row of each output is whole 16-byte lines");

}  // namespace

// shade/gbuffer.py::_GBufArgs mirrors this struct field for field.
struct GBufArgs {
  const float* adj;                 // [T,3,3] edge coefficients (setup.adj)
  const float* z_vert;              // [T,3]
  const float* attr;                // [T,16] gbuffer_static
  const unsigned char* atlas;       // [L, base, wa, 48] u8 window mip atlas
  const float* tex_scale;           // [12]
  const float* depth;               // [h,w] raster depth (inf or 1.0 where empty)
  const int* tri_id;                // [h,w], -1 where empty
  const float* clip_from_world;     // [4,4]
  const float* old_clip_from_world;
  const float* world_from_clip;
  const float* jitter;              // [2] or null
  float* base_color;                // [h,w,3]
  float* normal;                    // [h,w,3]
  float* orm;                       // [h,w,3]
  float* emissive;                  // [h,w,3]
  float* depth_out;                 // [h,w]
  float* velocity;                  // [h,w,2]
  bool* coverage;                   // [h,w]
  float alpha_threshold, ndc_sx, ndc_sy, noise_offset, ts;
  int h, w, row_offset, n_tris, base, wa, levels, filter;   // filter 0 nearest, 1 tri, 2 stoch
};

namespace {

// The tile's shared memory: the staged outputs (tile row r of a c-channel
// output at [r * kTileW * c, ...), each on a 16-byte line), the matrices and
// the scales
struct GbSmem {
  float base_color[kThreads * 3], normal[kThreads * 3], orm[kThreads * 3],
      emissive[kThreads * 3], depth[kThreads], velocity[kThreads * 2];
  unsigned char coverage[kThreads];
  float mats[48];   // world_from_clip, clip_from_world, old_clip_from_world
  float scale[12];  // tex_scale * (1/255)
  float jitter[2];
};

// byte k of a 48-byte atlas texel held as 12 words, as a float
__device__ __forceinline__ float texel_byte(const unsigned* wd, int k) {
  return (float)((wd[k >> 2] >> (8 * (k & 3))) & 0xFFu);
}

// sampling.sample_mip_atlas_array_window_nearest at one pixel, wrap
// addressing: 12 channels of the bilinear sample of the level round(lod)
__device__ void atlas_nearest(const GBufArgs& a, const float* scale, int layer, float u, float v,
                              float lod, float* out) {
  lod = clampp(lod, 0.0f, (float)(a.levels - 1));
  const int lv = (int)rintf(lod);
  const int ls = max(1, a.base >> lv);
  const int off = mip_offset(a.base, lv);
  const float x = u * (float)ls - 0.5f, y = v * (float)ls - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int ix = remainder_i((int)x0f, ls), iy = remainder_i((int)y0f, ls);
  // the texel's 2x2 window of 12 channels: three 16-byte loads (the atlas
  // starts on a 16-byte line, its texels are 48 bytes)
  const uint4* row = reinterpret_cast<const uint4*>(
      a.atlas + (((size_t)layer * a.base + iy) * a.wa + off + ix) * 48);
  const uint4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2);
  const unsigned wd[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                           q2.x, q2.y, q2.z, q2.w};
#pragma unroll
  for (int c = 0; c < 12; ++c)
    out[c] = bilerp(texel_byte(wd, c) * scale[c], texel_byte(wd, 12 + c) * scale[c],
                    texel_byte(wd, 24 + c) * scale[c], texel_byte(wd, 36 + c) * scale[c], fx, fy);
}

// The outputs of a pixel that is not covered (no triangle, or cut by the
// alpha test): they depend on nothing else
__device__ __forceinline__ void uncovered(GbSmem& sm, int slot) {
  sm.coverage[slot] = false;
  sm.depth[slot] = 1.0f;
  for (int c = 0; c < 3; ++c) {
    sm.base_color[3 * slot + c] = 0.0f;
    sm.normal[3 * slot + c] = c == 2 ? 1.0f : 0.0f;
    sm.orm[3 * slot + c] = 0.0f;
    sm.emissive[3 * slot + c] = 0.0f;
  }
  for (int c = 0; c < 2; ++c) sm.velocity[2 * slot + c] = 0.0f;
}

// Pixel (y, x), slot `slot` of its tile: its outputs into the tile's staging
__device__ void pixel(const GBufArgs& a, GbSmem& sm, int y, int x, int slot) {
  const size_t p = (size_t)y * a.w + x;
  const int tri = __ldg(a.tri_id + p);
  if (tri < 0) {
    uncovered(sm, slot);
    return;
  }
  float depth = __ldg(a.depth + p);
  if (isinf(depth)) depth = 1.0f;
  const int tid = tri;
  const float px = (float)x, py = (float)y + (float)a.row_offset;

  // every load of the triangle's rows in flight before the first use
  float adj[9], zv[3], at[16];
#pragma unroll
  for (int k = 0; k < 9; ++k) adj[k] = __ldg(a.adj + (size_t)tid * 9 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) zv[k] = __ldg(a.z_vert + (size_t)tid * 3 + k);
  const float4* arow = reinterpret_cast<const float4*>(a.attr) + (size_t)tid * 4;
  float4 aq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) aq[k] = __ldg(arow + k);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 q = aq[k];
    at[4 * k] = q.x;
    at[4 * k + 1] = q.y;
    at[4 * k + 2] = q.z;
    at[4 * k + 3] = q.w;
  }
  const int code = (int)at[15];
  const int mat = code >> 1;
  const bool do_test = (code & 1) != 0;
  float cw[3];
  for (int i = 0; i < 3; ++i) cw[i] = (adj[3 * i] + adj[3 * i + 1]) + adj[3 * i + 2];

  // barycentrics and their derivatives (_edge_eval, _lambda_and_derivs)
  const float ex = px + 0.5f, ey = py + 0.5f;
  float e[3];
  for (int j = 0; j < 3; ++j) e[j] = (adj[j] * ex + adj[3 + j] * ey) + adj[6 + j];
  const float w_raw = (cw[0] * ex + cw[1] * ey) + cw[2];
  const float w = fabsf(w_raw) < (float)1e-20 ? (float)1e-20 : w_raw;
  float lam[3], dlx[3], dly[3];
  for (int j = 0; j < 3; ++j) {
    lam[j] = e[j] / w;
    dlx[j] = (adj[j] - lam[j] * cw[0]) / w;
    dly[j] = (adj[3 + j] - lam[j] * cw[1]) / w;
  }
  // _interp: (a0*l0 + a1*l1) + a2*l2
  float ng_raw[3], uv[2], duvx[2], duvy[2];
  for (int c = 0; c < 3; ++c)
    ng_raw[c] = (at[6 + c] * lam[0] + at[9 + c] * lam[1]) + at[12 + c] * lam[2];
  for (int c = 0; c < 2; ++c) {
    uv[c] = (at[c] * lam[0] + at[2 + c] * lam[1]) + at[4 + c] * lam[2];
    duvx[c] = (at[c] * dlx[0] + at[2 + c] * dlx[1]) + at[4 + c] * dlx[2];
    duvy[c] = (at[c] * dly[0] + at[2 + c] * dly[1]) + at[4 + c] * dly[2];
  }
  float n_geo[3];
  normalize3(ng_raw, n_geo);

  // world position by unprojecting the depth
  const float jx = sm.jitter[0];
  const float jy = sm.jitter[1];
  const float ndc_x = ((px + 0.5f) * a.ndc_sx - 1.0f) - jx;
  const float ndc_y = ((py + 0.5f) * a.ndc_sy - 1.0f) - jy;
  const float* m = sm.mats;
  float q[4];
  for (int r = 0; r < 4; ++r)
    q[r] = ((m[4 * r] * ndc_x + m[4 * r + 1] * ndc_y) + m[4 * r + 2] * depth) + m[4 * r + 3];
  const float qw = fabsf(q[3]) < (float)1e-20 ? (float)1e-20 : q[3];
  float wp[3];
  for (int c = 0; c < 3; ++c) wp[c] = q[c] / qw;

  // d(z_ndc)/d(pixel) by the quotient rule
  const float num = e[1] * zv[1] + e[2] * zv[2];
  const float dnx = adj[1] * zv[1] + adj[2] * zv[2];
  const float dny = adj[4] * zv[1] + adj[5] * zv[2];
  const float dzx = (dnx - (num / w) * cw[0]) / w;
  const float dzy = (dny - (num / w) * cw[1]) / w;
  float dpx[3], dpy[3];
  {
    float dq[4], dr[4];
    for (int r = 0; r < 4; ++r) {
      dq[r] = (m[4 * r] * a.ndc_sx + m[4 * r + 1] * 0.0f) + m[4 * r + 2] * dzx;
      dr[r] = (m[4 * r] * 0.0f + m[4 * r + 1] * a.ndc_sy) + m[4 * r + 2] * dzy;
    }
    for (int c = 0; c < 3; ++c) {
      dpx[c] = (dq[c] - wp[c] * dq[3]) / qw;
      dpy[c] = (dr[c] - wp[c] * dr[3]) / qw;
    }
  }

  // lod from the uv footprint
  const float ux = duvx[0] * a.ts, vx = duvx[1] * a.ts;
  const float uy = duvy[0] * a.ts, vy = duvy[1] * a.ts;
  const float du = maxp(ux * ux + vx * vx, uy * uy + vy * vy);
  const float lod = clampp(0.5f * log2f(maxp(du, (float)1e-12)), 0.0f, 16.0f);

  // the material texel (trilinear: two levels)
  const float* scale = sm.scale;
  float tex[12];
  if (a.filter == 2) {
    const float u = frame_noise(px + 0.5f, py + 0.5f, a.noise_offset, 71.0f, 13.0f);
    atlas_nearest(a, scale, mat, uv[0], uv[1], lod + (u - 0.5f), tex);
  } else if (a.filter == 1) {
    const float lc = clampp(lod, 0.0f, (float)(a.levels - 1));
    const float l0 = floorf(lc);
    const float fl = lc - l0;
    float t1[12];
    atlas_nearest(a, scale, mat, uv[0], uv[1], l0, tex);
    atlas_nearest(a, scale, mat, uv[0], uv[1], minp(l0 + 1.0f, (float)(a.levels - 1)), t1);
    for (int c = 0; c < 12; ++c) tex[c] = tex[c] + (t1[c] - tex[c]) * fl;
  } else {
    atlas_nearest(a, scale, mat, uv[0], uv[1], lod, tex);
  }

  if (do_test && !(tex[3] >= a.alpha_threshold)) {   // the alpha test cut it
    uncovered(sm, slot);
    return;
  }

  // derivative TBN + normal mapping
  const float tsx = tex[4] * 2.0f - 1.0f, tsy = tex[5] * 2.0f - 1.0f;
  const float tsz = sqrtf(maxp(1.0f - (tsx * tsx + tsy * tsy), 0.0f));
  const float handed = duvx[0] * duvy[1] - duvx[1] * duvy[0];
  float nrm[3];
  if (fabsf(handed) < (float)1e-20) {
    for (int c = 0; c < 3; ++c) nrm[c] = n_geo[c];
  } else {
    float t[3], b[3];
    const bool mirrored = handed < 0.0f;
    float den[3], o[3];
    // mirrored: b1 = ortho(dpx * duvy.u - dpy * duvx.u), t1 = b1 x n
    // else:     t2 = ortho(dpx * duvy.v - dpy * duvx.v), b2 = t2 x n
    const float ky = mirrored ? duvy[0] : duvy[1], kx = mirrored ? duvx[0] : duvx[1];
    for (int c = 0; c < 3; ++c) den[c] = dpx[c] * ky - dpy[c] * kx;
    const float d = dot3(den, n_geo);
    for (int c = 0; c < 3; ++c) o[c] = den[c] - n_geo[c] * d;
    if (mirrored) {
      normalize3(o, b);
      cross3(b, n_geo, t);
    } else {
      normalize3(o, t);
      cross3(t, n_geo, b);
    }
    float v[3];
    for (int c = 0; c < 3; ++c) v[c] = (t[c] * tsx + b[c] * tsy) + n_geo[c] * tsz;
    normalize3(v, nrm);
  }

  // velocity: jitter-free ndc motion (m3.project_points)
  const float* mc = sm.mats + 16;
  const float* mo = sm.mats + 32;
  const float cw4 = xform(mc, 3, wp[0], wp[1], wp[2]);
  const float ow4 = xform(mo, 3, wp[0], wp[1], wp[2]);
  float vel[2];
  for (int c = 0; c < 2; ++c)
    vel[c] = xform(mc, c, wp[0], wp[1], wp[2]) / cw4 - xform(mo, c, wp[0], wp[1], wp[2]) / ow4;

  sm.coverage[slot] = true;
  sm.depth[slot] = depth;
  for (int c = 0; c < 3; ++c) {
    sm.base_color[3 * slot + c] = powf(maxp(tex[c], 0.0f), 2.2f);
    sm.normal[3 * slot + c] = nrm[c];
    sm.orm[3 * slot + c] = tex[6 + c];
    sm.emissive[3 * slot + c] = tex[9 + c];
  }
  for (int c = 0; c < 2; ++c) sm.velocity[2 * slot + c] = vel[c];
}

// The tile's rows of one staged output (C values a pixel, of type T) into
// their [H, W, C] rows: each row's 16-byte lines whole where they lie
// inside it (and the output starts on a line), the ends value by value
__device__ __forceinline__ unsigned pack4(const unsigned char* b) {
  return (unsigned)b[0] | ((unsigned)b[1] << 8) | ((unsigned)b[2] << 16) |
         ((unsigned)b[3] << 24);
}

template <typename T, int C>
__device__ void store_tile(T* g, const T* s, int w, int y0, int x0, int rows, int cols) {
  constexpr int kPer = 16 / sizeof(T);                 // values in a 16-byte line
  constexpr int kLines = kTileW * C / kPer + 1;        // lines a row touches, at most
  for (int q = threadIdx.x; q < kTileH * kLines; q += kThreads) {
    const int r = q / kLines, m = q - r * kLines;
    if (r >= rows) continue;
    const long long g0 = ((long long)(y0 + r) * w + x0) * C, g1 = g0 + (long long)cols * C;
    const long long gl = (g0 & ~(long long)(kPer - 1)) + (long long)kPer * m;
    if (gl >= g1) continue;
    const T* sl = s + r * kTileW * C + (int)(gl - g0);   // the line's first value
    if (gl >= g0 && gl + kPer <= g1 && (reinterpret_cast<uintptr_t>(g + gl) & 15) == 0) {
      uint4 v;
      if constexpr (sizeof(T) == 4) {
        // the staged line is a 16-byte line of shared memory when g0 is
        if ((g0 & (kPer - 1)) == 0) {
          v = *reinterpret_cast<const uint4*>(sl);
        } else {
          v = make_uint4(__float_as_uint(sl[0]), __float_as_uint(sl[1]),
                         __float_as_uint(sl[2]), __float_as_uint(sl[3]));
        }
      } else {
        v = make_uint4(pack4(sl), pack4(sl + 4), pack4(sl + 8), pack4(sl + 12));
      }
      *reinterpret_cast<uint4*>(g + gl) = v;
    } else {
      for (int k = 0; k < kPer; ++k)
        if (gl + k >= g0 && gl + k < g1) g[gl + k] = sl[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads, GB_MIN_BLOCKS) gbuffer_kernel(
    const __grid_constant__ GBufArgs a) {
  __shared__ __align__(16) GbSmem sm;
  const int t = threadIdx.x;
  if (t < 16) {
    sm.mats[t] = a.world_from_clip[t];
    sm.mats[16 + t] = a.clip_from_world[t];
    sm.mats[32 + t] = a.old_clip_from_world[t];
  }
  if (t < 12) sm.scale[t] = a.tex_scale[t] * (1.0f / 255.0f);
  if (t < 2) sm.jitter[t] = a.jitter != nullptr ? a.jitter[t] : 0.0f;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int y = y0 + t / kTileW, x = x0 + t % kTileW;
  __syncthreads();
  if (y < a.h && x < a.w) pixel(a, sm, y, x, t);
  __syncthreads();
  const int rows = min(kTileH, a.h - y0), cols = min(kTileW, a.w - x0);
  store_tile<float, 3>(a.base_color, sm.base_color, a.w, y0, x0, rows, cols);
  store_tile<float, 3>(a.normal, sm.normal, a.w, y0, x0, rows, cols);
  store_tile<float, 3>(a.orm, sm.orm, a.w, y0, x0, rows, cols);
  store_tile<float, 3>(a.emissive, sm.emissive, a.w, y0, x0, rows, cols);
  store_tile<float, 1>(a.depth_out, sm.depth, a.w, y0, x0, rows, cols);
  store_tile<float, 2>(a.velocity, sm.velocity, a.w, y0, x0, rows, cols);
  store_tile<unsigned char, 1>(reinterpret_cast<unsigned char*>(a.coverage), sm.coverage, a.w,
                               y0, x0, rows, cols);
}

}  // namespace

extern "C" int gbuffer_launch(const GBufArgs* args, void* stream) {
  const GBufArgs& a = *args;
  if ((long long)a.h * a.w <= 0) return (int)cudaGetLastError();
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
  gbuffer_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The G-buffer kernel on the current card, for chip_smoke.py: registers and
// local memory a thread, shared memory a block, resident blocks an SM, and
// its tile.
extern "C" int gbuffer_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                                 int* blocks_per_sm, int* tile_w, int* tile_h) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gbuffer_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *tile_w = kTileW;
  *tile_h = kTileH;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, gbuffer_kernel,
                                                            kThreads, 0);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
