// Sweep-only source (tile_sweep.py's "sweep" group), never built by the
// package: csrc/sweep.cu, included, behind a launcher that runs a design
// the package does not.  Its -D values:
//  - SWEEP_REPLAY_ALL=1: the replay design, lightgrid_sweep_kernel (a block
//    of 8 lines loads, replays the schedule's pairs in shared memory,
//    stores), for every length: the baseline the ring kernel is timed
//    against.  Bit for bit with the plain chain (tile_sweep.py checks it).
//  - Otherwise sweep_ring_variant_kernel, the package's ring kernel built
//    from the package's own pieces (ring_load, scan_regs, ring_line's
//    three steps) but for these values, each the package's where it is
//    not set:
//      SWEEP_LANES        lanes a line: 16 (two lines a warp) or 32 (one);
//      SWEEP_STAGES       the ring's stages, 2 to 4;
//      SWEEP_RING_MIN_BLOCKS  the register bound's blocks an SM (0: none);
//      SWEEP_RING_PER_SM  the most blocks the launch puts on an SM (0: as
//                         many as fit);
//      SWEEP_STORE_BATCH  chunks a thread quantizes side by side before it
//                         stores them;
//      SWEEP_FAST_LEVEL=1 the table's rgb levels first from approximate
//                         reciprocal and square root (relative error <
//                         2^-20 together, < 3e-4 in t = 255 * sqrt(x / (1 +
//                         x)) < 255); where t lies more than 1e-3 from a
//                         half-integer, rint gives the exact chain's
//                         integer, else (and for NaN) the exact chain runs;
//      SWEEP_PROBE        a sum of (not the plain version's bits; timed
//                         only): 1 both scans skipped, 2 zero table words
//                         (no quantize), 4 no stores, 8 no loads.
//    Bit for bit but for the probes (tile_sweep.py checks it, and the fast
//    level through sweep_rgb_levels over every third f32 bit pattern).
//
// It compiles the package's sweep.cu into the same library, renaming that
// file's launcher, shared-bytes and occupancy queries, so that its own
// take their place behind shade/gi.py's wrapper.

#ifndef SWEEP_REPLAY_ALL
#define SWEEP_REPLAY_ALL 0
#endif
#ifndef SWEEP_LANES
#define SWEEP_LANES 16
#endif
#ifndef SWEEP_STAGES
#define SWEEP_STAGES 2
#endif
#ifndef SWEEP_RING_MIN_BLOCKS
#define SWEEP_RING_MIN_BLOCKS 0
#endif
#ifndef SWEEP_RING_PER_SM
#define SWEEP_RING_PER_SM 0
#endif
#ifndef SWEEP_STORE_BATCH
#define SWEEP_STORE_BATCH 1
#endif
#ifndef SWEEP_FAST_LEVEL
#define SWEEP_FAST_LEVEL 0
#endif
#ifndef SWEEP_PROBE
#define SWEEP_PROBE 0
#endif

#define sweep_launch sweep_launch_package
#define sweep_shared_bytes sweep_shared_bytes_package
#define sweep_occupancy sweep_occupancy_package
#include "vulkan_pbr_renderer_tpu_torch/csrc/sweep.cu"
#undef sweep_launch
#undef sweep_shared_bytes
#undef sweep_occupancy

namespace {

constexpr int vLanes = SWEEP_LANES;
constexpr int vStages = SWEEP_STAGES;
constexpr int vThreads = vLanes * kRingLines;
constexpr int vProbe = SWEEP_PROBE;
static_assert(vLanes == 16 || vLanes == 32, "a line takes 16 or 32 lanes");
static_assert(vStages >= 2, "the ring needs two stages at least");

// the table's rgb level of one channel as this build computes it
__device__ __forceinline__ unsigned rgb_level(float v) {
  if (!SWEEP_FAST_LEVEL) return level(v, true);
  const float x = v < 0.0f ? 0.0f : v;
  float r, q;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(1.0f, x)));
  asm("sqrt.approx.f32 %0, %1;" : "=f"(q) : "f"(__fmul_rn(x, r)));
  const float t = __fmul_rn(q, 255.0f);
  if (fabsf(__fsub_rn(__fsub_rn(t, floorf(t)), 0.5f)) > 1e-3f)
    return (unsigned)fminf(fmaxf(rintf(t), 0.0f), 254.0f);
  return level(v, true);
}

// ring_line with probe 1 (no scans)
template <int K>
__device__ __forceinline__ void variant_line(const SweepArgs& a, float4* st, int q, int lk) {
  float4 x[K];
  ring_forward_inputs<vLanes, K>(a, st, q, lk, x);
  if (!(vProbe & 1)) scan_regs<vLanes, K, false>(x, lk);
  ring_backward_inputs<vLanes, K>(a, st, q, lk, x);
  if (!(vProbe & 1)) scan_regs<vLanes, K, true>(x, lk);
  ring_blend<vLanes, K>(a, st, q, lk, x);
}

// ring_store with a thread's K chunks kBatch at a time (their quantize
// chains side by side), this build's rgb level, and probes 2 (zero
// words) and 4 (no stores: a store that never happens keeps the work)
template <int K>
__device__ __forceinline__ void variant_store(const SweepArgs& a, const float4* st, int line0,
                                              int nl) {
  constexpr int N = vLanes * K;
  constexpr int kBatch = SWEEP_STORE_BATCH < K ? SWEEP_STORE_BATCH : K;
  static_assert(K % kBatch == 0, "a thread's chunks come in whole batches");
  const int lane = threadIdx.x & 31;
  const size_t own = a.along ? 0 : line_base(a, line0 + threadIdx.x % kRingLines);
#pragma unroll 1
  for (int c0 = threadIdx.x; c0 < kRingLines * N; c0 += kBatch * vThreads) {
    int q[kBatch], i[kBatch];
    float4 o[kBatch];
    unsigned word[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ring_chunk(c0 + u * vThreads, N, a.along, q[u], i[u]);
      o[u] = q[u] < nl ? st[ring_slot<vLanes, K>(q[u], i[u], a.along)]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      word[u] = (vProbe & 2) ? 0u
                             : rgb_level(o[u].x) | rgb_level(o[u].y) << 8 |
                                   rgb_level(o[u].z) << 16 | level(o[u].w, false) << 24;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = q[u] < nl;
      const size_t g = ring_base(a, line0, q[u], own) + (size_t)i[u] * a.stride;
      if (live && (!(vProbe & 4) || o[u].x == -1.0e30f)) a.out[g] = o[u];
      const unsigned w1 = __shfl_down_sync(0xFFFFFFFFu, word[u], 1);
      const unsigned w2 = __shfl_down_sync(0xFFFFFFFFu, word[u], 2);
      const unsigned w3 = __shfl_down_sync(0xFFFFFFFFu, word[u], 3);
      if ((vProbe & 4) && word[u] != 0xDEADBEEFu) continue;
      if (a.vec_table && (a.along ? live : (q[u] | 3) < nl)) {
        if ((lane & 3) == 0)
          *reinterpret_cast<uint4*>(a.table + g) = make_uint4(word[u], w1, w2, w3);
      } else if (live) {
        a.table[g] = word[u];
      }
    }
  }
}

#if SWEEP_RING_MIN_BLOCKS
#define VARIANT_BOUNDS __launch_bounds__(vThreads, SWEEP_RING_MIN_BLOCKS)
#else
#define VARIANT_BOUNDS __launch_bounds__(vThreads)
#endif

// sweep_ring_kernel's walk over vStages stages, and probe 8 (no loads)
template <int K>
__global__ void VARIANT_BOUNDS sweep_ring_variant_kernel(const SweepArgs a) {
  constexpr int kStage = kRingLines * vLanes * K;
  extern __shared__ float4 ring[];
  const int q = threadIdx.x / vLanes, lk = threadIdx.x % vLanes;
  const int warp_first = (threadIdx.x & ~31) / vLanes;
  const int groups = (a.lines + kRingLines - 1) / kRingLines;
#pragma unroll
  for (int s = 0; s < vStages - 1; ++s) {
    const int g = blockIdx.x + s * gridDim.x;
    if (g < groups && !(vProbe & 8))
      ring_load<vLanes, K>(a, ring + s * kStage, g * kRingLines,
                           min(kRingLines, a.lines - g * kRingLines));
    cp_async_commit();
  }
  int k = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, ++k) {
    float4* const cur = ring + (k % vStages) * kStage;
    const int line0 = g * kRingLines, nl = min(kRingLines, a.lines - line0);
    cp_async_wait<vStages - 2>();
    __syncthreads();
    const int gn = g + (vStages - 1) * gridDim.x;
    if (gn < groups && !(vProbe & 8))
      ring_load<vLanes, K>(a, ring + ((k + vStages - 1) % vStages) * kStage, gn * kRingLines,
                           min(kRingLines, a.lines - gn * kRingLines));
    cp_async_commit();
    if (warp_first < nl) variant_line<K>(a, cur, q, lk);
    __syncthreads();
    variant_store<K>(a, cur, line0, nl);
  }
  cp_async_wait<0>();
}

// the variant's voxels a lane for a length (0: the replay kernel's)
constexpr int variant_k(int n) {
  return SWEEP_REPLAY_ALL || n % vLanes || n / vLanes > 16 || (n / vLanes & (n / vLanes - 1))
             ? 0
             : n / vLanes;
}

constexpr int variant_shared_bytes(int k) { return vStages * kRingLines * vLanes * k * 16; }

int replay_shared_bytes(int n, int n_pairs, int levels) {
  return (int)(kLines * (size_t)(old_pitch(n) + ab_pitch(n)) * sizeof(float4) +
               (size_t)n_pairs * 4 + (size_t)(levels + 1) * 4);
}

// the variant kernel over a persistent grid (SWEEP_RING_PER_SM an SM at most)
template <int K>
cudaError_t variant_launch(const SweepArgs& a, int device, cudaStream_t stream) {
  static int resident[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = variant_shared_bytes(K);
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0, regs = 0, local = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = occupancy(sweep_ring_variant_kernel<K>, vThreads, smem, &regs, &local, &per_sm);
    if (err != cudaSuccess) return err;
    if (SWEEP_RING_PER_SM > 0 && per_sm > SWEEP_RING_PER_SM) per_sm = SWEEP_RING_PER_SM;
    resident[device] = sms * max(per_sm, 1);
  }
  const int groups = (a.lines + kRingLines - 1) / kRingLines;
  sweep_ring_variant_kernel<K><<<min(groups, resident[device]), vThreads, smem, stream>>>(a);
  return cudaSuccess;
}

__global__ void rgb_level_kernel(const float* x, unsigned char* out, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < n) out[i] = (unsigned char)rgb_level(x[i]);
}

}  // namespace

extern "C" int sweep_shared_bytes(int n, int n_pairs, int levels) {
  return variant_k(n) ? variant_shared_bytes(variant_k(n))
                      : replay_shared_bytes(n, n_pairs, levels);
}

extern "C" int sweep_launch(const SweepArgs* args, int device, void* stream) {
  const SweepArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.lines > 0 && a.n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (variant_k(a.n)) {
      case 1: err = variant_launch<1>(a, device, s); break;
      case 2: err = variant_launch<2>(a, device, s); break;
      case 4: err = variant_launch<4>(a, device, s); break;
      case 8: err = variant_launch<8>(a, device, s); break;
      case 16: err = variant_launch<16>(a, device, s); break;
      default:
        if (a.smem > 48 * 1024)
          err = cudaFuncSetAttribute(lightgrid_sweep_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
        if (err == cudaSuccess)
          lightgrid_sweep_kernel<<<(a.lines + kLines - 1) / kLines, kThreads, a.smem, s>>>(a);
    }
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// sweep_occupancy of this build's kernel for lines of n voxels
extern "C" int sweep_occupancy(int n, int smem, int* registers, int* local_bytes,
                               int* blocks_per_sm, int* lines_per_block, int* threads,
                               int* lane_voxels) {
  const int k = variant_k(n);
  *lane_voxels = k;
  *lines_per_block = k ? kRingLines : kLines;
  *threads = k ? vThreads : kThreads;
  cudaError_t err;
  switch (k) {
    case 1: err = occupancy(sweep_ring_variant_kernel<1>, vThreads, smem, registers,
                            local_bytes, blocks_per_sm); break;
    case 2: err = occupancy(sweep_ring_variant_kernel<2>, vThreads, smem, registers,
                            local_bytes, blocks_per_sm); break;
    case 4: err = occupancy(sweep_ring_variant_kernel<4>, vThreads, smem, registers,
                            local_bytes, blocks_per_sm); break;
    case 8: err = occupancy(sweep_ring_variant_kernel<8>, vThreads, smem, registers,
                            local_bytes, blocks_per_sm); break;
    case 16: err = occupancy(sweep_ring_variant_kernel<16>, vThreads, smem, registers,
                             local_bytes, blocks_per_sm); break;
    default: err = occupancy(lightgrid_sweep_kernel, kThreads, smem, registers, local_bytes,
                             blocks_per_sm);
  }
  return (int)err;
}

// rgb_level of n values (a thread each): the quantize's rgb level as this
// build computes it, for tile_sweep.py's dense check of SWEEP_FAST_LEVEL
// against quantize_grid_u8.
extern "C" int sweep_rgb_levels(const float* x, unsigned char* out, long long n, void* stream) {
  if (n > 0)
    rgb_level_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
