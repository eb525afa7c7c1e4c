// The G-buffer for Hopper (sm_90a): a thread per pixel.
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
// four texels of the material atlas (48 B each).  Nothing is packed and no
// intermediate goes to device memory.
//
// What bounds it on the card: bytes.  A pixel reads its depth and id (8 B)
// and writes 57 B; the triangle rows and the atlas texels are read once per
// distinct triangle or texel (~72 MB of triangle rows at most, the atlas
// whole at most).  ~0.6 GFLOP a frame is ~10 us at the f32 peak.  This
// first version keeps a plain thread-per-pixel shape: no tiling.
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

namespace {

constexpr int kThreads = 256;

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
  const unsigned char* row =
      a.atlas + (((size_t)layer * a.base + iy) * a.wa + off + ix) * 48;
  for (int c = 0; c < 12; ++c)
    out[c] = bilerp((float)row[c] * scale[c], (float)row[12 + c] * scale[c],
                    (float)row[24 + c] * scale[c], (float)row[36 + c] * scale[c], fx, fy);
}

__device__ void pixel(const GBufArgs& a, int y, int x) {
  const size_t p = (size_t)y * a.w + x;
  const int tri = a.tri_id[p];
  float depth = a.depth[p];
  if (isinf(depth)) depth = 1.0f;
  const int tid = max(tri, 0);
  const float px = (float)x, py = (float)y + (float)a.row_offset;

  float adj[9], zv[3], at[16];
  for (int k = 0; k < 9; ++k) adj[k] = a.adj[(size_t)tid * 9 + k];
  for (int k = 0; k < 3; ++k) zv[k] = a.z_vert[(size_t)tid * 3 + k];
  const float4* arow = reinterpret_cast<const float4*>(a.attr) + (size_t)tid * 4;
  for (int k = 0; k < 4; ++k) {
    const float4 q = arow[k];
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
  const float jx = a.jitter != nullptr ? a.jitter[0] : 0.0f;
  const float jy = a.jitter != nullptr ? a.jitter[1] : 0.0f;
  const float ndc_x = ((px + 0.5f) * a.ndc_sx - 1.0f) - jx;
  const float ndc_y = ((py + 0.5f) * a.ndc_sy - 1.0f) - jy;
  const float* m = a.world_from_clip;
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

  float scale[12];
  const float inv255 = 1.0f / 255.0f;
  for (int c = 0; c < 12; ++c) scale[c] = a.tex_scale[c] * inv255;
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

  bool covered = tri >= 0;
  if (do_test) covered = covered && (tex[3] >= a.alpha_threshold);

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
    const int k = mirrored ? 0 : 1;
    for (int c = 0; c < 3; ++c) den[c] = dpx[c] * duvy[k] - dpy[c] * duvx[k];
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
  const float* mc = a.clip_from_world;
  const float* mo = a.old_clip_from_world;
  const float cw4 = xform(mc, 3, wp[0], wp[1], wp[2]);
  const float ow4 = xform(mo, 3, wp[0], wp[1], wp[2]);
  float vel[2];
  for (int c = 0; c < 2; ++c)
    vel[c] = xform(mc, c, wp[0], wp[1], wp[2]) / cw4 - xform(mo, c, wp[0], wp[1], wp[2]) / ow4;

  a.coverage[p] = covered;
  a.depth_out[p] = covered ? depth : 1.0f;
  for (int c = 0; c < 3; ++c) {
    a.base_color[3 * p + c] = covered ? powf(maxp(tex[c], 0.0f), 2.2f) : 0.0f;
    a.normal[3 * p + c] = covered ? nrm[c] : (c == 2 ? 1.0f : 0.0f);
    a.orm[3 * p + c] = covered ? tex[6 + c] : 0.0f;
    a.emissive[3 * p + c] = covered ? tex[9 + c] : 0.0f;
  }
  for (int c = 0; c < 2; ++c) a.velocity[2 * p + c] = covered ? vel[c] : 0.0f;
}

__global__ void __launch_bounds__(kThreads) gbuffer_kernel(const GBufArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)a.h * a.w) return;
  pixel(a, (int)(i / a.w), (int)(i % a.w));
}

}  // namespace

extern "C" int gbuffer_launch(const GBufArgs* args, void* stream) {
  const GBufArgs& a = *args;
  const long long n = (long long)a.h * a.w;
  if (n <= 0) return (int)cudaGetLastError();
  const int grid = (int)((n + kThreads - 1) / kThreads);
  gbuffer_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
