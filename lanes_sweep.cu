// Sweep-only source (tile_sweep.py's "lanes" group), never built by the
// package: the GI lane inputs over 2D tiles of lanes with the tile's
// G-buffer spans staged in shared memory or not, and its outputs staged or
// not, each variant bit for bit with gi_lane_inputs_plain.  The package's
// gi_inputs_kernel (csrc/lighting.cu) is this kernel's LANE_STAGE_IN=0,
// LANE_STAGE_OUT=1 variant at 6 resident blocks, the fastest on the H100
// (PERF.md); the rest were measured and not kept.
//
// The forks.  A block takes a LANE_TILE_W x LANE_TILE_H tile of the lane
// grid, a thread a lane, and runs the package's arithmetic (lighting.cu
// gi_lane):
//  - LANE_STAGE_IN=1: the pixel span each lane row of the tile reads (its
//    G-buffer row i*k, the columns of its traced lanes: under the
//    interleave 2 * LANE_TILE_W columns of k pixels) is staged in shared
//    memory, normal, orm and depth, as 16-byte loads all issued before any
//    is used (where k is at most kMaxK and the rows start on 16-byte
//    lines; else each lane loads its own three values).  Slower: under the
//    checker interleave at k = 2 a span holds four pixels a lane, so
//    staging reads every byte of it where a lane needs 20 of its 80
//    (normal 12 of 48, orm 4 of 48, depth 4 of 16);
//  - LANE_STAGE_OUT=1: the lanes' outputs staged in shared memory and each
//    output array's tile rows written as 16-byte lines where they start on
//    one; 0: each lane stores its own (scalars, the thread-per-lane
//    kernel's stores over 2D tiles).
//
// It compiles the package's lighting.cu into the same library, renaming
// that file's lane launcher and occupancy query, so that its own take
// their place behind shade/gi_modes.py's plan.

#define gi_inputs_launch gi_inputs_launch_package
#define gi_inputs_occupancy gi_inputs_occupancy_package
#include "vulkan_pbr_renderer_tpu_torch/csrc/lighting.cu"
#undef gi_inputs_launch
#undef gi_inputs_occupancy

// Defaults and sweep values (-D, tile_sweep.py's "lanes" group).
#ifndef LANE_TILE_W
#define LANE_TILE_W 32
#endif
#ifndef LANE_TILE_H
#define LANE_TILE_H 8
#endif
#ifndef LANE_STAGE_IN
#define LANE_STAGE_IN 1
#endif
#ifndef LANE_STAGE_OUT
#define LANE_STAGE_OUT 1
#endif
#ifndef LANE_MIN_BLOCKS
#define LANE_MIN_BLOCKS 4
#endif

namespace {

constexpr int kLW = LANE_TILE_W, kLH = LANE_TILE_H, kLT = kLW * kLH;
constexpr int kMaxK = 2;                        // staged divisors
constexpr int kSpan = 2 * kLW * kMaxK;           // pixels of a lane row's span
constexpr int kQ3 = (kSpan * 3 + 3) / 4 + 1;     // float4 lines of a normal / orm span
constexpr int kQ1 = (kSpan + 3) / 4 + 1;         // of a depth span

struct __align__(16) LaneSmem {
#if LANE_STAGE_IN
  float4 normal[kLH][kQ3];
  float4 orm[kLH][kQ3];
  float4 depth[kLH][kQ1];
#endif
#if LANE_STAGE_OUT
  float out3[5][kLH][kLW * 3];                   // pw pv bent vd spec
  float out1[2][kLH][kLW];                       // n3 rough
#endif
  int unused;
};

// copies src[lo .. hi) (float indices, lo rounded down to a 16-byte line)
// into dst as 16-byte lines; the last line only where it lies in src's
// `total` floats, else by scalars
__device__ __forceinline__ void stage_line(float4* dst, const float* src, long long lo,
                                           long long hi, long long total, int q) {
  const long long a = (lo & ~3LL) + 4LL * q;
  if (a >= hi) return;
  if (a + 4 <= total) {
    dst[q] = __ldg(reinterpret_cast<const float4*>(src + a));
  } else {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 4; ++c)
      if (a + c < total) v[c] = __ldg(src + a + c);
    dst[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kLT, LANE_MIN_BLOCKS) gi_inputs_tiled_kernel(const GiArgs a) {
  __shared__ LaneSmem sm;
  const int tx = threadIdx.x % kLW, ty = threadIdx.x / kLW;
  const int j0 = blockIdx.x * kLW, i0 = blockIdx.y * kLH;
  const int i = i0 + ty, j = j0 + tx;
  const bool live = i < a.rows && j < a.cols;
  const int nj = min(kLW, a.cols - j0);          // the tile's lanes a row
  const int col = lane_col(a, i, j);
  const size_t p = (size_t)(i * a.k) * a.w + (size_t)(col * a.k);
  float n[3], rough = 0.0f, depth = 0.0f;

#if LANE_STAGE_IN
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.normal) | reinterpret_cast<uintptr_t>(a.orm)
                         | reinterpret_cast<uintptr_t>(a.depth)) & 15) == 0;
  const bool staged = aligned && a.k <= kMaxK;
#else
  const bool staged = false;
#endif
#if LANE_STAGE_IN
  if (staged) {
    // each lane row's span: the pixels from its first traced column to its
    // last; no line reaches past the last pixel row the lanes read
    const long long px_total = ((long long)(a.rows - 1) * a.k + 1) * a.w;
    const int c_lo = a.pattern == 0 ? j0 : 2 * j0;
    const int c_hi = a.pattern == 0 ? j0 + nj - 1 : 2 * (j0 + nj - 1) + 1;
    for (int e = threadIdx.x; e < kLH * (2 * kQ3 + kQ1); e += kLT) {
      const int r = e / (2 * kQ3 + kQ1), q = e % (2 * kQ3 + kQ1);
      const int ir = i0 + r;
      if (ir >= a.rows) continue;
      const long long row = (long long)(ir * a.k) * a.w;
      const long long x_lo = row + (long long)c_lo * a.k;
      const long long x_hi = row + min((long long)c_hi * a.k, (long long)a.w - 1) + 1;
      if (q < kQ3)
        stage_line(sm.normal[r], a.normal, 3 * x_lo, 3 * x_hi, 3 * px_total, q);
      else if (q < 2 * kQ3)
        stage_line(sm.orm[r], a.orm, 3 * x_lo, 3 * x_hi, 3 * px_total, q - kQ3);
      else
        stage_line(sm.depth[r], a.depth, x_lo, x_hi, px_total, q - 2 * kQ3);
    }
    __syncthreads();
  }
#endif
  if (live) {
    if (staged) {
#if LANE_STAGE_IN
      const int c_lo = a.pattern == 0 ? j0 : 2 * j0;
      const long long x_lo = (long long)(i * a.k) * a.w + (long long)c_lo * a.k;
      const int o3 = (int)(3 * (long long)p - (3 * x_lo & ~3LL));
      const int o1 = (int)((long long)p - (x_lo & ~3LL));
      const float* sn = reinterpret_cast<const float*>(sm.normal[ty]);
      const float* so = reinterpret_cast<const float*>(sm.orm[ty]);
      const float* sd = reinterpret_cast<const float*>(sm.depth[ty]);
      n[0] = sn[o3], n[1] = sn[o3 + 1], n[2] = sn[o3 + 2];
      rough = so[o3 + 1];
      depth = sd[o1];
#endif
    } else {
      n[0] = a.normal[3 * p], n[1] = a.normal[3 * p + 1], n[2] = a.normal[3 * p + 2];
      rough = a.orm[3 * p + 1];
      depth = a.depth[p];
    }
  }
  LaneOut o;
  if (live) gi_lane(a, i, col, n, rough, depth, o);

#if LANE_STAGE_OUT
  if (live) {
    for (int c = 0; c < 3; ++c) {
      sm.out3[0][ty][3 * tx + c] = o.pw[c];
      sm.out3[1][ty][3 * tx + c] = o.pv[c];
      sm.out3[2][ty][3 * tx + c] = o.bent[c];
      sm.out3[3][ty][3 * tx + c] = o.vd[c];
      sm.out3[4][ty][3 * tx + c] = o.spec[c];
    }
    sm.out1[0][ty][tx] = o.n3;
    sm.out1[1][ty][tx] = o.rough;
  }
  __syncthreads();
  float* const dsts[7] = {a.pw, a.pv, a.bent, a.vd, a.spec, a.n3, a.rough};
  for (int f = 0; f < 7; ++f) {
    float* dst = dsts[f];
    if (dst == nullptr) continue;
    const int wd = f < 5 ? 3 : 1;
    const int q_row = (kLW * wd) / 4;              // 16-byte lines of a full tile row
    for (int e = threadIdx.x; e < kLH * q_row; e += kLT) {
      const int r = e / q_row, q = e % q_row;
      const int ir = i0 + r;
      if (ir >= a.rows) continue;
      const long long base = ((long long)ir * a.cols + j0) * wd;
      const int n_row = nj * wd;                   // floats of this tile row
      const float* s = f < 5 ? &sm.out3[f][r][4 * q] : &sm.out1[f - 5][r][4 * q];
      if (4 * q >= n_row) continue;
      if (((base + 4 * q) & 3) == 0 && 4 * q + 4 <= n_row) {
        *reinterpret_cast<float4*>(dst + base + 4 * q) = *reinterpret_cast<const float4*>(s);
      } else {
        for (int c = 0; c < 4 && 4 * q + c < n_row; ++c) dst[base + 4 * q + c] = s[c];
      }
    }
  }
#else
  if (!live) return;
  const long long lane = (long long)i * a.cols + j;
  for (int c = 0; c < 3; ++c) {
    a.pw[3 * lane + c] = o.pw[c];
    a.pv[3 * lane + c] = o.pv[c];
    a.bent[3 * lane + c] = o.bent[c];
  }
  a.n3[lane] = o.n3;
  if (a.vd != nullptr)
    for (int c = 0; c < 3; ++c) a.vd[3 * lane + c] = o.vd[c];
  if (a.rough != nullptr) a.rough[lane] = o.rough;
  if (a.spec != nullptr)
    for (int c = 0; c < 3; ++c) a.spec[3 * lane + c] = o.spec[c];
#endif
}

}  // namespace

extern "C" int gi_inputs_launch(const GiArgs* args, int device, void* stream) {
  const GiArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.rows > 0 && a.cols > 0) {
    const dim3 grid((a.cols + kLW - 1) / kLW, (a.rows + kLH - 1) / kLH);
    gi_inputs_tiled_kernel<<<grid, kLT, 0, (cudaStream_t)stream>>>(a);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int gi_inputs_occupancy(int* registers, int* local_bytes, int* shared_bytes,
                                   int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gi_inputs_tiled_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            gi_inputs_tiled_kernel, kLT, 0);
}
