// Sweep-only source (tile_sweep.py's "sweep" group), never built by the
// package: csrc/sweep.cu's lightgrid_sweep_kernel, copied, with a fork
// that the package does not keep and probes that say where its time goes.
//  - SWEEP_RELOAD_OLD=1: the old voxels are not staged; the forward fold
//    and the final phase read them again from device memory (L2), which
//    cuts the shared memory a block takes (more blocks resident);
//  - SWEEP_UNPADDED=1: the lines' slots unpadded and their pitches n (the
//    scan's pairs at strides of 8 or more slots in one bank group);
//  - SWEEP_PROBE (not the plain version's bits; timed only): 1 skips both
//    scans, 2 writes zero table words (no quantize), 3 both.
// SWEEP_LINES (lines a block) is the package's own -D value.  The fork is
// bit for bit with the plain chain; tile_sweep.py checks it.

#ifndef SWEEP_RELOAD_OLD
#define SWEEP_RELOAD_OLD 0
#endif
#ifndef SWEEP_UNPADDED
#define SWEEP_UNPADDED 0
#endif
#ifndef SWEEP_PROBE
#define SWEEP_PROBE 0
#endif

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the lines a block sweeps, a warp each, and the blocks an SM keeps
// resident (a register bound; 0: the compiler's choice, 48 registers at 8
// lines); -D values for a sweep
#ifndef SWEEP_LINES
#define SWEEP_LINES 8
#endif
#ifndef SWEEP_MIN_BLOCKS
#define SWEEP_MIN_BLOCKS 0
#endif

namespace {

constexpr int kLines = SWEEP_LINES;
constexpr int kThreads = 32 * kLines;

}  // namespace

// shade/gi.py::_SweepArgs mirrors this struct field for field.
struct SweepArgs {
  const float4* grid;         // [D,H,W,4] f32, the grid before this frame's sweep
  float4* out;                // [D,H,W,4] f32, the swept grid
  unsigned* table;            // [D,H,W] u8 x 4 (quantize_grid_u8's levels)
  const unsigned* pairs;      // the scan's combines, src | dst << 16, level after level
  const int* level_start;     // [levels + 1] offsets into pairs
  float sky[3];               // the skylight
  float mr, keep, blend;      // move_ratio, (1 - move_ratio) / move_ratio, blend (f32)
  int n;                      // voxels a line (the swept axis' length)
  int lines;                  // lines of the grid
  int inner, outer, stride;   // line l starts at (l / inner) * outer + l % inner voxels;
                              // its voxels are stride apart
  int along;                  // 1: a line's voxels are adjacent (the x axis)
  int levels, n_pairs;        // the schedule's levels and combines
  int vec_table;              // 1: 4 table words of a block's chunk in one 16-byte store
  int smem;                   // dynamic shared bytes of a launch
};

namespace {

__device__ __forceinline__ float4 combine(const float4 x, const float4 y) {
  // (a1, b1) . (a2, b2) = (a1 * a2, a2 * b1 + b2); (b, a) live in (xyz, w)
  return make_float4(__fadd_rn(__fmul_rn(y.w, x.x), y.x), __fadd_rn(__fmul_rn(y.w, x.y), y.y),
                     __fadd_rn(__fmul_rn(y.w, x.z), y.z), __fmul_rn(x.w, y.w));
}

// Shared memory layout.  A line's (B, A) slots are padded by one slot every
// 8, so the scan's pairs at strides of 2, 4 and 8 slots fall in distinct
// 16-byte bank groups, and the lines' pitches are odd, so a step's voxels
// of adjacent lines do too.
#if SWEEP_UNPADDED
__device__ __forceinline__ int slot(int i) { return i; }
__host__ __device__ __forceinline__ int ab_pitch(int n) { return n; }
__host__ __device__ __forceinline__ int old_pitch(int n) { return n; }
#else
__device__ __forceinline__ int slot(int i) { return i + (i >> 3); }
__host__ __device__ __forceinline__ int ab_pitch(int n) { return (n + (n >> 3)) | 1; }
__host__ __device__ __forceinline__ int old_pitch(int n) { return n | 1; }
#endif

// one recurrence along a warp's line in shared memory: the schedule's
// levels, the indices mirrored for the backward sweep
__device__ __forceinline__ void scan_line(float4* ab, const unsigned* pairs,
                                          const int* level_start, int levels, int n,
                                          bool reverse, int lane) {
  for (int l = 0; l < levels; ++l) {
    for (int p = level_start[l] + lane; p < level_start[l + 1]; p += 32) {
      const unsigned pr = pairs[p];
      int src = (int)(pr & 0xFFFFu), dst = (int)(pr >> 16);
      if (reverse) src = n - 1 - src, dst = n - 1 - dst;
      ab[slot(dst)] = combine(ab[slot(src)], ab[slot(dst)]);
    }
    __syncwarp();
  }
}

// L = A * sky + B, a channel
__device__ __forceinline__ float3 light(const float4 ab, const float* sky) {
  return make_float3(__fadd_rn(__fmul_rn(ab.w, sky[0]), ab.x),
                     __fadd_rn(__fmul_rn(ab.w, sky[1]), ab.y),
                     __fadd_rn(__fmul_rn(ab.w, sky[2]), ab.z));
}

// quantize_grid_u8's level of one channel
__device__ __forceinline__ unsigned level(float v, bool rgb) {
  if (rgb) {
    const float x = v < 0.0f ? 0.0f : v;
    v = __fsqrt_rn(__fdiv_rn(x, __fadd_rn(1.0f, x)));
  }
  const float r = rintf(__fmul_rn(v, 255.0f));
  return (unsigned)fminf(fmaxf(r, 0.0f), 254.0f);
}

// the table word the final phase left in a voxel's (B, A) slot
__device__ __forceinline__ unsigned word_at(const float4* at) {
  return reinterpret_cast<const unsigned*>(at)[0];
}

// the voxel offset of line l of the grid, at step 0
__device__ __forceinline__ size_t line_base(const SweepArgs& a, int l) {
  return (size_t)(l / a.inner) * a.outer + (size_t)(l % a.inner);
}

#if SWEEP_MIN_BLOCKS
#define SWEEP_BOUNDS __launch_bounds__(kThreads, SWEEP_MIN_BLOCKS)
#else
#define SWEEP_BOUNDS __launch_bounds__(kThreads)
#endif

__global__ void SWEEP_BOUNDS lightgrid_sweep_kernel(const SweepArgs a) {
  extern __shared__ float4 smem[];
  const int n = a.n;
  const int po = SWEEP_RELOAD_OLD ? 0 : old_pitch(n), pab = ab_pitch(n);
  float4* old = smem;                                   // [kLines][po] rgba before the sweep
  float4* ab = smem + kLines * po;                      // [kLines][pab] the scan's (B, A)
  unsigned* pairs = reinterpret_cast<unsigned*>(ab + kLines * pab);
  int* level_start = reinterpret_cast<int*>(pairs + a.n_pairs);

  const int line0 = blockIdx.x * kLines;
  const int nl = min(kLines, a.lines - line0);
  for (int j = threadIdx.x; j < a.n_pairs; j += kThreads) pairs[j] = a.pairs[j];
  for (int j = threadIdx.x; j <= a.levels; j += kThreads) level_start[j] = a.level_start[j];

  // A thread's voxels: one line q, steps i0, i0 + di, ...  Along x a warp
  // takes a line, its lanes on adjacent voxels; across z and y the block's
  // lines lie side by side, a step's voxels of adjacent lines on adjacent
  // lanes (kLines of them one 128-byte line of device memory at kLines 8).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = a.along ? warp : threadIdx.x % kLines;
  const int i0 = a.along ? lane : threadIdx.x / kLines;
  constexpr int di = 32;                                // kThreads / kLines
  const size_t base = line_base(a, line0 + q), stride = (size_t)a.stride;
  float4* const qab = ab + q * pab;
#if SWEEP_RELOAD_OLD
  auto old_at = [&](int qq, int i) {
    return __ldg(a.grid + line_base(a, line0 + qq) + (size_t)i * stride);
  };
#else
  auto old_at = [&](int qq, int i) { return old[qq * po + i]; };
#endif

  // load: the old voxels, and the forward scan's (b, a)
  if (q < nl) {
#pragma unroll 4
    for (int i = i0; i < n; i += di) {
      const float4 v = __ldg(a.grid + base + (size_t)i * stride);
#if !SWEEP_RELOAD_OLD
      old[q * po + i] = v;
#endif
      qab[slot(i)] = v.w > 0.5f ? make_float4(v.x, v.y, v.z, 0.0f)
                          : make_float4(__fmul_rn(a.mr, v.x), __fmul_rn(a.mr, v.y),
                                        __fmul_rn(a.mr, v.z), a.mr);
    }
  }
  __syncthreads();

  // each warp sweeps one line
  if (warp < nl) {
    float4* lab = ab + warp * pab;
#if !(SWEEP_PROBE & 1)
    scan_line(lab, pairs, level_start, a.levels, n, false, lane);
#endif
    // the forward result, and from it the backward scan's (b, a)
    for (int i = lane; i < n; i += 32) {
      const float4 v = old_at(warp, i);
      const float3 L = light(lab[slot(i)], a.sky);
      if (v.w > 0.5f) {
        lab[slot(i)] = make_float4(v.x, v.y, v.z, 0.0f);
      } else {
        float3 f = make_float3(__fmul_rn(a.keep, L.x), __fmul_rn(a.keep, L.y),
                               __fmul_rn(a.keep, L.z));
        if (i == n - 1) f = make_float3(__fadd_rn(f.x, L.x), __fadd_rn(f.y, L.y),
                                        __fadd_rn(f.z, L.z));
        lab[slot(i)] = make_float4(__fmul_rn(a.mr, f.x), __fmul_rn(a.mr, f.y),
                                   __fmul_rn(a.mr, f.z), a.mr);
      }
    }
    __syncwarp();
#if !(SWEEP_PROBE & 1)
    scan_line(lab, pairs, level_start, a.levels, n, true, lane);
#endif
  }
  __syncthreads();

  // the new grid (16-byte stores) and the table's words
  if (q < nl) {
#pragma unroll 2
    for (int i = i0; i < n; i += di) {
      const float4 v = old_at(q, i);
      float4 o = v;
      if (v.w <= 0.5f) {
        const float3 L = light(qab[slot(i)], a.sky);
        float3 b = make_float3(__fmul_rn(a.keep, L.x), __fmul_rn(a.keep, L.y),
                               __fmul_rn(a.keep, L.z));
        if (i == 0)
          b = make_float3(__fadd_rn(b.x, L.x), __fadd_rn(b.y, L.y), __fadd_rn(b.z, L.z));
        o.x = __fadd_rn(v.x, __fmul_rn(__fsub_rn(b.x, v.x), a.blend));
        o.y = __fadd_rn(v.y, __fmul_rn(__fsub_rn(b.y, v.y), a.blend));
        o.z = __fadd_rn(v.z, __fmul_rn(__fsub_rn(b.z, v.z), a.blend));
      }
      const size_t g = base + (size_t)i * stride;
      a.out[g] = o;
#if SWEEP_PROBE & 2
      const unsigned word = 0u;
#else
      const unsigned word = level(o.x, true) | level(o.y, true) << 8 |
                            level(o.z, true) << 16 | level(o.w, false) << 24;
#endif
      if (a.vec_table)
        reinterpret_cast<unsigned*>(qab + slot(i))[0] = word;   // this voxel's own slot
      else
        a.table[g] = word;
    }
  }
  if (!a.vec_table) return;
  __syncthreads();
  // the table in 16-byte lines of 4 voxels adjacent in it: along a line (x),
  // or across 4 lines of one step (z, y; the host sets vec_table only where
  // the lines come in fours)
  if (a.along) {
    if (warp < nl) {
      const float4* lab = ab + warp * pab;
      for (int i = 4 * lane; i < n; i += 4 * 32) {
        const uint4 w = make_uint4(word_at(lab + slot(i)), word_at(lab + slot(i + 1)),
                                   word_at(lab + slot(i + 2)), word_at(lab + slot(i + 3)));
        *reinterpret_cast<uint4*>(a.table + line_base(a, line0 + warp) + i) = w;
      }
    }
  } else {
    const int qc = 4 * (threadIdx.x % (kLines / 4));
    if (qc < nl) {
      const size_t cbase = line_base(a, line0 + qc);
      for (int i = threadIdx.x / (kLines / 4); i < n; i += 4 * kThreads / kLines) {
        const float4* c = ab + qc * pab + slot(i);
        const uint4 w = make_uint4(word_at(c), word_at(c + pab), word_at(c + 2 * pab),
                                   word_at(c + 3 * pab));
        *reinterpret_cast<uint4*>(a.table + cbase + (size_t)i * stride) = w;
      }
    }
  }
}

}  // namespace

extern "C" int sweep_shared_bytes(int n, int n_pairs, int levels) {
  return (int)(kLines * (size_t)((SWEEP_RELOAD_OLD ? 0 : old_pitch(n)) + ab_pitch(n)) *
                   sizeof(float4) +
               (size_t)n_pairs * 4 + (size_t)(levels + 1) * 4);
}

extern "C" int sweep_launch(const SweepArgs* args, int device, void* stream) {
  const SweepArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.smem > 48 * 1024)
    err = cudaFuncSetAttribute(lightgrid_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err == cudaSuccess && a.lines > 0 && a.n > 0)
    lightgrid_sweep_kernel<<<(a.lines + kLines - 1) / kLines, kThreads, a.smem,
                             (cudaStream_t)stream>>>(a);
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// registers and local memory a thread, and the blocks an SM keeps resident
// at `smem` dynamic shared bytes a block
extern "C" int sweep_occupancy(int smem, int* registers, int* local_bytes, int* blocks_per_sm,
                               int* lines_per_block) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lightgrid_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *lines_per_block = kLines;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lightgrid_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, lightgrid_sweep_kernel,
                                                            kThreads, smem);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
