// Voxelize for Hopper (sm_90a): pass 2 of the frame, run when the sun
// moved: the sun-lit surface samples of every triangle scatter-maxed into
// the packed [D,D,D] word grid, then the grid decoded to [D,D,D,4] f32.
//
// Two routes share the per-sample arithmetic (voxel_sample), so their bits
// cannot drift:
//  * voxelize_pass_kernel, the frame's (shade/gi.py voxelize_lightgrid):
//    one cooperative launch of a persistent grid runs the samples'
//    atomicMax into a u32 word grid (the JAX package's own dtype,
//    gi.py:282-284; 8.4 MB at 128^3, held by the scene's plan and zeroed
//    once when the plan makes it), then decodes each word and zeroes it
//    again for the next pass, the two phases split by a grid-wide barrier
//    (cooperative_groups' grid sync: no memset, no host epoch, and the
//    words stay in the 50 MB L2 between the phases).  On the H100
//    (tile_sweep.py, PERF.md) zeroing the words in a first phase of the
//    launch instead, as the sweep-only voxelize_sweep.cu's fork does, took
//    a barrier and ~3% more;
//  * voxelize_kernel after a memset of an int64 word grid in one C call,
//    then decode_voxel_kernel (shade/gi.py voxelize_scene and
//    decode_voxel_grid): the row-sharded frame's route, whose ranks' words
//    meet in an all-reduce max before the decode.
// A word is below 2^32 (an 8-bit key and three 8-bit levels), so the u32
// max is the int64 max.
//
// Replaces no Pallas kernel: the JAX package voxelizes in XLA
// (vulkan_pbr_renderer_tpu/shade/gi.py:120 voxelize_scene: a scatter +
// cummax expansion of the sample stream, one f16 row gather, a nearest-mip
// texel fetch, a u16 window pack of the sun map and a 1-tap compare, the
// word pack :288 and a scatter-max; :309 decode_voxel_grid).  The plain
// versions are shade/gi.py's voxelize_scene_plain and
// decode_voxel_grid_plain, some twenty PyTorch launches over the stream.
//
// What both compute, a thread per sample pid of the shard's slice [start,
// start + s_len) below the stream's total:
//   * its triangle t, the last with offsets[t] <= pid (the offsets are
//     exclusive sums of counts >= 1, so strictly increasing), and local =
//     pid - offsets[t]: what the plain version's scatter-max fills and
//     cummax give, the slice's carry-in run included, by a binary search
//     over the offsets (neighbouring samples walk the same path, so its
//     upper levels come from L1 and L2).  Where every triangle has one
//     sample and the stream holds them all (the plan's one_sample flag:
//     the frame's SunTemple stream, 638,700 samples), offsets[t] = t, so
//     t = pid and local = 0 with no search and no offset read;
//   * the R2 point (local * a + b mod 1, folded into the triangle), the
//     position and uv from the triangle's f16 row (the per-scene plan's
//     [T,20] halves, 40 bytes, read as five 8-byte loads);
//   * the base colour and emissive of the wrap-mode 2x2 window at the
//     nearest mip level, from the u8 atlas's 48-byte window row (three
//     16-byte loads), dequantized by tex_scale / 255;
//   * the 1-tap shadow: the 2x2 edge-clamped window of the f32 sun map,
//     each texel rounded to its u16 level as quantize_u16 does (no 32 MB
//     window pack is built), compared with the sample's sun depth less
//     1e-3 and blended bilinearly;
//   * the radiance, its luminance-keyed word and the voxel under it, and an
//     atomicMax of the word into the word grid (the order of the atomics
//     cannot change a max: the grid is the plain version's bit for bit).
// The decode turns each word into rgb = c^2 / max(1 - c^2, 1/256) of its
// three 8-bit levels and alpha = word != 0, a 16-byte store a voxel.
//
// Exactness.  Every step is the plain version's arithmetic on the card in
// its order: each product and sum a rounded _rn intrinsic (and -fmad=false),
// transform_points' (x*m0 + y*m1) + (z*m2 + m3), torch.remainder(x, 1.0) as
// x - trunc(x) with x's sign plus 1 where negative, round as rintf (half to
// even), the two ratios x / (1 + x) IEEE divides, sqrt correctly rounded,
// clamps that pass NaN through as PyTorch's do, and float -> int
// conversions by truncation.  Python numbers of the plain version are f32 on
// the card: the literals below are double constants made f32 (as PyTorch
// makes a Python float), and the wrapper passes the ones PyTorch computes
// otherwise (1 / 255 for the dequant, 1 / S, 1 / 65535).
//
// What bounds it.  Bytes: per triangle a 4-byte offset and its 38-byte row
// (read as the plan's padded 40), per sample a 48-byte atlas row and four
// 4-byte sun texels (many shared by neighbouring samples), and 16 bytes a
// voxel of the decoded grid written; in the one-launch pass the u32 words
// need not leave L2.
// Some 200 flops a sample are far below the f32 peak.  What it has to hide
// is latency: the search's ~20 dependent loads (none on a one-sample
// stream), then the row, then the atlas and sun texels.  On the H100
// (tile_sweep.py --groups voxelize, PERF.md) a search a sample beat a
// block's search for its window of offsets staged in shared memory, and
// reading the voxel's word before the atomic (the atomics are
// fire-and-forget reductions) or a warp's max per voxel before one atomic
// gained nothing; those designs live in the
// sweep-only voxelize_sweep.cu, which builds its kernel from this file's
// voxel_sample.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// samples a block; a -D value for a sweep
#ifndef VOXEL_THREADS
#define VOXEL_THREADS 256
#endif


namespace {

constexpr int kThreads = VOXEL_THREADS;
constexpr int kRow = 20;         // halves a plan row (shade/gi.py VOXEL_ROW)
constexpr int kDecodeThreads = 256;

#define F32(x) ((float)(x))      // a Python float as PyTorch makes it f32

}  // namespace

// shade/gi.py::_VoxelArgs mirrors this struct field for field.
struct VoxelArgs {
  const int* offsets;            // [T] exclusive sample offsets, clamped to the stream
  const unsigned short* rows;    // [T, 20] f16 bits: p0 e1 e2 uv0 duv1 duv2 normal mat, pad
  const uint8_t* atlas;          // [L, H, Wa, 48] u8 window-packed mip atlas, 16-byte aligned
  const float* tex_scale;        // [12]
  const float* sun_depth;        // [S, S]
  const float* sun_from_world;   // [4, 4] row-major
  const float* sun_dir;          // [3]
  const float* emission_ptr;     // [3] on the card, or null: `emission` below
  long long* grid;               // [D, D, D] packed words, zeroed by the launch
  unsigned* words;               // [D, D, D] u32 words of the one-launch pass, zeroed by it
  float* out;                    // [D, D, D, 4] f32, the one-launch pass's decoded grid
  float emission[3];
  float scale;                   // lightgrid_scale
  float deq;                     // f32(1) / f32(255): tex_scale / 255.0 on the card
  float uv_bias;                 // f32(1.0 / S)
  float inv65535;                // f32(1.0 / 65535.0)
  float inv255;                  // f32(1.0 / 255.0), the decode's
  int n_tris, total, start, s_len, grid_size, sun_size, base_h, atlas_wa, level_size,
      level_off;
  int one_sample;                // 1: offsets[t] = t for every t, total = n_tris
};

namespace {

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.remainder(a, 1.0) on the card: fmod(a, 1) (= a - trunc(a), exactly,
// with a's sign), plus the divisor where the signs differ
__device__ __forceinline__ float rem1(float a) {
  float m = copysignf(__fsub_rn(a, truncf(a)), a);
  if (m != 0.0f && m < 0.0f) m = __fadd_rn(m, 1.0f);
  return m;
}

// torch.remainder on int32 (Python's sign rule)
__device__ __forceinline__ int imod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// sampling._clamp_index: clamp the floored coordinate as a float, truncate,
// clamp the int
__device__ __forceinline__ int clamp_index(float x0f, int n) {
  const int i = (int)clampf(x0f, 0.0f, (float)(n - 1));
  return min(max(i, 0), n - 1);
}

// dequant_u16(quantize_u16(d)): the u16 level round(d * 65535) in
// [0, 65535] (NaN truncates to 0), times f32(1 / 65535)
__device__ __forceinline__ float depth_u16(float d, float inv65535) {
  const int level = (int)clampf(rintf(__fmul_rn(d, 65535.0f)), 0.0f, 65535.0f) & 0xFFFF;
  return __fmul_rn((float)level, inv65535);
}

// _bilerp_row's combine of one channel
__device__ __forceinline__ float bilerp(float t00, float t10, float t01, float t11, float fx,
                                        float fy) {
  const float top = __fadd_rn(t00, __fmul_rn(__fsub_rn(t10, t00), fx));
  const float bot = __fadd_rn(t01, __fmul_rn(__fsub_rn(t11, t01), fx));
  return __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
}

// _pack_voxel_sample: one rgb channel's level, round(sqrt(x / (1 + x)) * 255)
// clipped to 0..254, of x = max(c, 0)
__device__ __forceinline__ long long level8(float c) {
  const float p = clamp_min(c, 0.0f);
  const float q = __fsqrt_rn(__fdiv_rn(p, __fadd_rn(p, 1.0f)));
  return (long long)clampf(rintf(__fmul_rn(q, 255.0f)), 0.0f, 254.0f);
}

// the last index k < n of the increasing offs with offs[k] <= p (offs[0] <= p)
template <typename Load>
__device__ __forceinline__ int last_at_or_below(int n, int p, Load load) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (load(mid) <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Sample `local` of triangle t: its word and the index of its voxel in the
// grid; false where the sample lies outside the grid.
__device__ __forceinline__ bool voxel_sample(const VoxelArgs& a, int t, float local,
                                             long long& cell, long long& word) {
  // the R2 point, folded into the triangle
  float r0 = rem1(__fadd_rn(__fmul_rn(local, F32(0.7548776662466927)), F32(0.13)));
  float r1 = rem1(__fadd_rn(__fmul_rn(local, F32(0.5698402909980532)), F32(0.29)));
  if (__fadd_rn(r0, r1) > 1.0f) {
    r0 = __fsub_rn(1.0f, r0);
    r1 = __fsub_rn(1.0f, r1);
  }

  // the triangle's f16 row
  union {
    uint2 v[kRow / 4];
    unsigned short h[kRow];
  } row;
  const uint2* rp = reinterpret_cast<const uint2*>(a.rows + (size_t)t * kRow);
#pragma unroll
  for (int j = 0; j < kRow / 4; ++j) row.v[j] = __ldg(rp + j);
  float f[19];
#pragma unroll
  for (int j = 0; j < 19; ++j) f[j] = __half2float(__ushort_as_half(row.h[j]));
  float pos[3], uv[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    pos[c] = __fadd_rn(__fadd_rn(f[c], __fmul_rn(r0, f[3 + c])), __fmul_rn(r1, f[6 + c]));
#pragma unroll
  for (int c = 0; c < 2; ++c)
    uv[c] = __fadd_rn(__fadd_rn(f[9 + c], __fmul_rn(r0, f[11 + c])), __fmul_rn(r1, f[13 + c]));
  const long long layer = (long long)f[18];

  // the texel: the wrap-mode 2x2 window at the nearest level, base (0-2)
  // and emissive (9-11) of its 12 channels
  const float ls = (float)a.level_size;
  const float x = __fsub_rn(__fmul_rn(uv[0], ls), 0.5f);
  const float y = __fsub_rn(__fmul_rn(uv[1], ls), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
  const int ix = imod((int)x0f, a.level_size), iy = imod((int)y0f, a.level_size);
  const long long idx = (layer * a.base_h + iy) * a.atlas_wa + a.level_off + ix;
  union {
    uint4 v[3];
    uint8_t b[48];
  } tex;
  const uint4* tp = reinterpret_cast<const uint4*>(a.atlas + idx * 48);
#pragma unroll
  for (int j = 0; j < 3; ++j) tex.v[j] = __ldg(tp + j);
  float texel[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int ch = j < 3 ? j : j + 6;
    const float dq = __fmul_rn(__ldg(a.tex_scale + ch), a.deq);
    texel[j] = bilerp(__fmul_rn((float)tex.b[ch], dq), __fmul_rn((float)tex.b[12 + ch], dq),
                      __fmul_rn((float)tex.b[24 + ch], dq), __fmul_rn((float)tex.b[36 + ch], dq),
                      fx, fy);
  }

  // the 1-tap shadow: (+1, +1) texel offset, z bias 1e-3
  const float* m = a.sun_from_world;
  float ps[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    ps[c] = __fadd_rn(__fadd_rn(__fmul_rn(pos[0], __ldg(m + 4 * c)),
                                __fmul_rn(pos[1], __ldg(m + 4 * c + 1))),
                      __fadd_rn(__fmul_rn(pos[2], __ldg(m + 4 * c + 2)), __ldg(m + 4 * c + 3)));
  const int s = a.sun_size;
  const float us = __fadd_rn(__fadd_rn(__fmul_rn(ps[0], 0.5f), 0.5f), a.uv_bias);
  const float vs = __fadd_rn(__fadd_rn(__fmul_rn(ps[1], 0.5f), 0.5f), a.uv_bias);
  const float ref = __fsub_rn(ps[2], F32(0.001));
  const float sx = __fsub_rn(__fmul_rn(us, (float)s), 0.5f);
  const float sy = __fsub_rn(__fmul_rn(vs, (float)s), 0.5f);
  const float sx0 = floorf(sx), sy0 = floorf(sy);
  const float sfx = sx0 < 0.0f ? 0.0f : __fsub_rn(sx, sx0);
  const float sfy = sy0 < 0.0f ? 0.0f : __fsub_rn(sy, sy0);
  const int cx = clamp_index(sx0, s), cy = clamp_index(sy0, s);
  const int cx1 = min(cx + 1, s - 1), cy1 = min(cy + 1, s - 1);
  const float* sd = a.sun_depth;
  const float c00 = ref < depth_u16(__ldg(sd + (size_t)cy * s + cx), a.inv65535) ? 1.0f : 0.0f;
  const float c10 = ref < depth_u16(__ldg(sd + (size_t)cy * s + cx1), a.inv65535) ? 1.0f : 0.0f;
  const float c01 = ref < depth_u16(__ldg(sd + (size_t)cy1 * s + cx), a.inv65535) ? 1.0f : 0.0f;
  const float c11 = ref < depth_u16(__ldg(sd + (size_t)cy1 * s + cx1), a.inv65535) ? 1.0f : 0.0f;
  const float shadow = bilerp(c00, c10, c01, c11, sfx, sfy);

  // the voxel under the sample, and the word
  const int d = a.grid_size;
  long long coord[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float uvw = __fadd_rn(__fmul_rn(__fmul_rn(pos[c], a.scale), 0.5f), 0.5f);
    coord[c] = (long long)floorf(__fmul_rn(uvw, (float)d));
    if (coord[c] < 0 || coord[c] >= d) return false;
  }
  const float ldotn = clamp_min(
      __fadd_rn(__fadd_rn(__fmul_rn(f[15], -__ldg(a.sun_dir)), __fmul_rn(f[16], -__ldg(a.sun_dir + 1))),
                __fmul_rn(f[17], -__ldg(a.sun_dir + 2))),
      0.0f);
  const float lit = __fmul_rn(shadow, ldotn);
  float rad[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float em = a.emission_ptr ? __ldg(a.emission_ptr + c) : a.emission[c];
    rad[c] = __fadd_rn(texel[3 + c], __fmul_rn(__fmul_rn(lit, texel[c]), em));
  }
  const float lum = __fadd_rn(__fadd_rn(__fmul_rn(rad[0], F32(0.299)), __fmul_rn(rad[1], F32(0.587))),
                              __fmul_rn(rad[2], F32(0.114)));
  const long long key = (long long)clampf(
      rintf(__fmul_rn(__fdiv_rn(lum, __fadd_rn(lum, 1.0f)), 255.0f)), 0.0f, 255.0f);
  word = (key << 24) + (level8(rad[0]) << 16) + (level8(rad[1]) << 8) + level8(rad[2]);
  word = word < 1 ? 1 : word;
  cell = (coord[2] * d + coord[1]) * d + coord[0];
  return true;
}

// sample pid's triangle, and its index in the triangle's run as local
__device__ __forceinline__ int sample_triangle(const VoxelArgs& a, int pid, float& local) {
  if (a.one_sample) {
    local = 0.0f;
    return pid;
  }
  const int t = last_at_or_below(a.n_tris, pid, [&](int j) { return __ldg(a.offsets + j); });
  local = (float)(pid - __ldg(a.offsets + t));
  return t;
}

// a word's rgb = c^2 / max(1 - c^2, 1/256) of its three levels, alpha = word != 0
__device__ __forceinline__ float4 decode_word(long long w, float inv255) {
  const float alpha = w != 0 ? 1.0f : 0.0f;
  float rgb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q = __fmul_rn((float)((w >> (16 - 8 * c)) & 0xFF), inv255);
    const float c2 = __fmul_rn(q, q);
    rgb[c] = __fmul_rn(__fdiv_rn(c2, clamp_min(__fsub_rn(1.0f, c2), F32(1.0 / 256.0))), alpha);
  }
  return make_float4(rgb[0], rgb[1], rgb[2], alpha);
}

__global__ void __launch_bounds__(kThreads) voxelize_kernel(const VoxelArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int pid = a.start + i;
  if (i >= a.s_len || pid >= a.total) return;
  float local;
  const int t = sample_triangle(a, pid, local);
  long long cell, word;
  if (voxel_sample(a, t, local, cell, word))
    atomicMax(reinterpret_cast<unsigned long long*>(a.grid) + cell, (unsigned long long)word);
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_voxel_kernel(const long long* __restrict__ packed, float4* __restrict__ out, long long n,
                    float inv255) {
  const long long i = (long long)blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = decode_word(__ldg(packed + i), inv255);
}

// The whole pass in one cooperative launch: a persistent grid runs the
// samples (their words' atomicMax in L2) on the plan's u32 words, which it
// finds zero, meets, and decodes each word (read from L2) into a 16-byte
// store and zeroes it for the plan's next pass.
__global__ void __launch_bounds__(kThreads) voxelize_pass_kernel(const VoxelArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long cells = (long long)a.grid_size * a.grid_size * a.grid_size;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;

  const int live = min(a.s_len, a.total - a.start);
  for (long long i = first; i < live; i += step) {
    float local;
    const int t = sample_triangle(a, a.start + (int)i, local);
    long long cell, word;
    if (voxel_sample(a, t, local, cell, word)) atomicMax(a.words + cell, (unsigned)word);
  }
  grid.sync();
  float4* const out = reinterpret_cast<float4*>(a.out);
  for (long long i = first; i < cells; i += step) {
    out[i] = decode_word((long long)__ldcg(a.words + i), a.inv255);
    a.words[i] = 0u;   // zero again for the plan's next pass
  }
}

}  // namespace

// Zero the grid and launch voxelize_kernel over the shard's samples below
// the total, on `stream`.  Returns the first CUDA error (0 = launched).
extern "C" int voxelize_launch(const VoxelArgs* args, int device, void* stream) {
  const VoxelArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  const size_t cells = (size_t)a.grid_size * a.grid_size * a.grid_size;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.grid, 0, cells * sizeof(long long), (cudaStream_t)stream);
  const int live = min(a.s_len, a.total - a.start);
  if (err == cudaSuccess && live > 0 && a.n_tris > 0)
    voxelize_kernel<<<(live + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a);
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Decode n packed words into n float4 (16-byte aligned), on `stream`.
extern "C" int decode_voxel_launch(const long long* packed, float* out, long long n,
                                   float inv255, int device, void* stream) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && n > 0)
    decode_voxel_kernel<<<(unsigned)((n + kDecodeThreads - 1) / kDecodeThreads), kDecodeThreads,
                          0, (cudaStream_t)stream>>>(packed, reinterpret_cast<float4*>(out), n,
                                                     inv255);
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The one-launch pass on `stream`: a cooperative grid of as many blocks as
// are resident at once on the card, at most one per kThreads of the larger
// of the samples and the voxels.  Returns the first CUDA error (0 =
// launched).
extern "C" int voxelize_pass_launch(const VoxelArgs* args, int device, void* stream) {
  static int resident[64];   // blocks of the kernel resident at once, per device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const VoxelArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, voxelize_pass_kernel,
                                                          kThreads, 0);
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err == cudaSuccess) {
    const long long cells = (long long)a.grid_size * a.grid_size * a.grid_size;
    const long long live = a.total - a.start < a.s_len ? a.total - a.start : a.s_len;
    const long long work = cells > live ? cells : live;
    const long long blocks = (work + kThreads - 1) / kThreads;
    const int grid = blocks < resident[device] ? (int)blocks : resident[device];
    void* params[] = {const_cast<VoxelArgs*>(args)};
    err = cudaLaunchCooperativeKernel((const void*)voxelize_pass_kernel, dim3(grid > 0 ? grid : 1),
                                      dim3(kThreads), params, 0, (cudaStream_t)stream);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the one-launch pass's kernel: registers and local memory a thread, and
// the blocks an SM keeps resident
extern "C" int voxelize_pass_occupancy(int* registers, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, voxelize_pass_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, voxelize_pass_kernel,
                                                            kThreads, 0);
}

// registers and local memory a thread, and the blocks an SM keeps resident
extern "C" int voxelize_occupancy(int* registers, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, voxelize_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, voxelize_kernel,
                                                            kThreads, 0);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
