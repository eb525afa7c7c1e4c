// Device functions shared by csrc/gbuffer.cu, csrc/lighting.cu and
// csrc/post.cu: the port's sampling (gpu/sampling.py), noise
// (utils/noise.py) and vector math (utils/math3d.py) as PyTorch computes
// them on the card, one operation at a time, and the acquire / release
// flags of the one-launch kernels (post.cu's chains, lighting.cu's shafts).
// The sources are compiled with -fmad=false and without fast math, so every
// product and sum rounds where the PyTorch op does.  What PyTorch
// does on the card, and these functions mirror:
//  - a reduction over a last dim of 3 (torch.sum, vector_norm) adds
//    (x0 + x2) + x1: the warp's shuffle tree over three lanes (the norm's
//    order was measured on the H100 for csrc/gi_fast_ray.cu; a sum shares
//    the reduction code); over 2, x0 + x1;
//  - a tensor divided by a Python number is a product with the number's f32
//    reciprocal (the reciprocal taken in f32);
//  - torch.remainder on floats is fmod, plus the divisor where the signs
//    differ; torch.round is round-half-even (rintf);
//  - pow(x, 2.0) is x * x; any other exponent powf; arccos, sin, cos, atan2,
//    log2 and sqrt are the CUDA math library's (no fast math);
//  - torch.clamp / maximum / minimum propagate NaN.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace shade {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a) ? a : (a > b ? a : b);
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a) ? a : (a < b ? a : b);
}
__device__ __forceinline__ float clampp(float v, float lo, float hi) {
  return minp(maxp(v, lo), hi);
}

// torch.remainder(x, 1.0): fmod(x, 1), plus 1 where the signs differ.
// fmod(x, 1) is x - trunc(x) with x's sign: the difference is exact (the
// fraction is x's own low bits), and copysign gives a zero fmodf's sign.
// CUDA's fmodf takes a step per bit of the exponent difference (17 here:
// the noise offset reaches ~95,000).
__device__ __forceinline__ float fract1(float x) {
  float m = copysignf(x - truncf(x), x);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// torch.remainder on int32 by a positive n
__device__ __forceinline__ int remainder_i(int a, int n) {
  int r = a % n;
  return (r != 0 && r < 0) ? r + n : r;
}

// utils/noise.py frame_noise(px, py, f59, offset): noise_offset is the
// host's f32(1000 phi) * f32(f59).  Python's constants reach PyTorch as
// doubles rounded to f32, hence (float) of a double literal here.
__device__ __forceinline__ float frame_noise(float px, float py, float noise_offset, float ox,
                                             float oy) {
  const float x = px + ox, y = py + oy;
  const float ign = fract1((float)52.9829189 *
                           fract1((float)0.06711056 * x + (float)0.00583715 * y));
  return fract1(ign + noise_offset);
}

// m3.transform_points, row r of [4,4] m: (x*m0 + y*m1) + (z*m2 + m3)
__device__ __forceinline__ float xform(const float* m, int r, float x, float y, float z) {
  return (x * m[4 * r] + y * m[4 * r + 1]) + (z * m[4 * r + 2] + m[4 * r + 3]);
}

// torch.sum(a * b, -1) over 3 on the card
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
}

// torch.linalg.vector_norm over 3 on the card
__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
}

// m3.normalize: v / max(|v|, eps)
__device__ __forceinline__ void normalize3(const float* v, float* out, float eps = (float)1e-12) {
  const float n = maxp(norm3(v), eps);
  out[0] = v[0] / n;
  out[1] = v[1] / n;
  out[2] = v[2] / n;
}

// torch.linalg.cross's a1*b2 - a2*b1 (SHADE_CROSS_FMA: as PyTorch's cross
// kernel is compiled, with the first product fused into the subtraction)
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
#if SHADE_CROSS_FMA
  return __fmaf_rn(a, b, -(c * d));
#else
  return a * b - c * d;
#endif
}
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = cross_term(a[1], b[2], a[2], b[1]);
  out[1] = cross_term(a[2], b[0], a[0], b[2]);
  out[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// sampling.dequant_u16 of an int16 bit pattern
__device__ __forceinline__ float dequant_u16(short q) {
  return (float)((int)q & 0xFFFF) * (float)(1.0 / 65535.0);
}

// sampling.quantize_u16 -> the int16 bit pattern
__device__ __forceinline__ short quantize_u16(float d) {
  const float q = clampp(rintf(d * 65535.0f), 0.0f, 65535.0f);
  const int qi = (int)q;
  return (short)(qi > 32767 ? qi - 65536 : qi);
}

// lighting.reconstruct_positions at one pixel: u, v already (i*stride +
// 0.5) / fw and ((j*stride + row_offset) + 0.5) / fh; out the world (or view)
// position of the [4,4] m
__device__ __forceinline__ void unproject(const float* m, float u, float v, float depth,
                                          float* out) {
  const float nx = u * 2.0f - 1.0f, ny = v * 2.0f - 1.0f;
  const float w = xform(m, 3, nx, ny, depth);
  for (int c = 0; c < 3; ++c) out[c] = xform(m, c, nx, ny, depth) / w;
}

// sampling.cubemap_face_uv_from_dir
__device__ __forceinline__ void cube_face_uv(const float* r, int* face, float* u, float* v) {
  const float x = r[0], y = r[1], z = r[2];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  *face = is_x ? (x >= 0.0f ? 0 : 1) : is_y ? (y >= 0.0f ? 2 : 3) : (z >= 0.0f ? 4 : 5);
  const float ma = maxp(is_x ? ax : is_y ? ay : az, (float)1e-20);
  const float sc = is_x ? (x >= 0.0f ? -z : z) : is_y ? x : (z >= 0.0f ? x : -x);
  const float tc = is_x ? -y : is_y ? (y >= 0.0f ? z : -z) : -y;
  *u = 0.5f * sc / ma + 0.5f;
  *v = 0.5f * tc / ma + 0.5f;
}

// the bilinear combine of sampling._bilerp_row for one channel
__device__ __forceinline__ float bilerp(float t00, float t10, float t01, float t11, float fx,
                                        float fy) {
  const float top = t00 + (t10 - t00) * fx;
  const float bot = t01 + (t11 - t01) * fx;
  return top + (bot - top) * fy;
}

// sampling._cube_window_level_sample: one bilinear sample of level (ls, off)
// of a window-packed f16 cube atlas [6, s, wa, 12]
__device__ __forceinline__ void cube_level(const __half* env, int s, int wa, int face, float u,
                                           float v, int ls, int off, float* out) {
  const float x = u * (float)ls - 0.5f, y = v * (float)ls - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x0f < 0.0f ? 0.0f : x - x0f;
  const float fy = y0f < 0.0f ? 0.0f : y - y0f;
  const int ix = min(max((int)x0f, 0), ls - 1);
  const int iy = min(max((int)y0f, 0), ls - 1);
  const __half* row = env + (((size_t)face * s + iy) * wa + off + ix) * 12;
  for (int c = 0; c < 3; ++c)
    out[c] = bilerp(__half2float(row[c]), __half2float(row[3 + c]), __half2float(row[6 + c]),
                    __half2float(row[9 + c]), fx, fy);
}

// the mip level offsets of a square base (sampling.mip_offsets)
__device__ __forceinline__ int mip_offset(int base, int level) {
  int off = 0;
  for (int k = 0; k < level; ++k) off += max(1, base >> k);
  return off;
}

// sampling.sample_cubemap_level_window (level already clamped)
__device__ __forceinline__ void cube_sample_level(const __half* env, int s, int wa,
                                                  const float* r, int level, float* out) {
  int face;
  float u, v;
  cube_face_uv(r, &face, &u, &v);
  cube_level(env, s, wa, face, u, v, max(1, s >> level), mip_offset(s, level), out);
}

// sampling.sample_cubemap_lod_window
__device__ __forceinline__ void cube_sample_lod(const __half* env, int s, int wa, int levels,
                                                const float* r, float lod, float* out) {
  int face;
  float u, v;
  cube_face_uv(r, &face, &u, &v);
  lod = clampp(lod, 0.0f, (float)(levels - 1));
  const int l0 = (int)floorf(lod);
  const int l1 = min(l0 + 1, levels - 1);
  const float fl = lod - (float)l0;
  float s0[3], s1[3];
  cube_level(env, s, wa, face, u, v, max(1, s >> l0), mip_offset(s, l0), s0);
  cube_level(env, s, wa, face, u, v, max(1, s >> l1), mip_offset(s, l1), s1);
  for (int c = 0; c < 3; ++c) out[c] = s0[c] + (s1[c] - s0[c]) * fl;
}

// A unit's flag in a launch whose units wait on earlier units: stored with
// release semantics by one thread once the block is past the barrier after
// its writes, loaded with acquire semantics by the waiters before theirs
// (the block barrier then passes the order on to the block: CUTLASS's
// GenericBarrier pattern), with no full fences.  Each launch marks its
// flags with its own epoch (never 0, new every launch), so no flag is ever
// reset.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spin until the flag holds this launch's epoch.  The waits end where every
// unit waits only on units earlier in the order and the grid is all
// resident; a fault that broke that would hang the card, so after ~2^26
// polls (seconds) the kernel traps and the launch fails instead.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch) {
  for (unsigned spins = 0; ld_acquire(flag) != epoch; ++spins) {
    if (spins == (1u << 26)) __trap();
    __nanosleep(20);
  }
}

}  // namespace shade
