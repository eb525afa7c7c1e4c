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
// Design.  What bounds it: the instructions its warps issue (the flop bound
// counts each add and multiply at the f32 FMA peak; at -fmad=false each is
// an instruction, so the arithmetic alone cannot pass ~50% of that bound),
// at a SIMT efficiency of ~0.7 (lanes leave the skip, the trace and the
// taps at different steps), and its gathers (8 scattered table words a
// trilinear fetch, a dependent depth word a trace step).  A block of 128
// threads takes four 8 x 4 lane tiles of the [rows, width] lane grid
// (gi.lane_tiles, gi_fast_ray.cu's warp tiles) in two stages split by
// __syncthreads:
//   1. each thread runs its own lane's skip, screen trace and resolve (the
//      fallback for status 1, the pyramid for 3, 0 where no voxel opened);
//      a lane that marches is appended to the block's march queue (its
//      lane id and open point; a warp-aggregated append, one ballot and
//      one shared atomic a warp);
//   2. the block's threads take the queue's entries, so the voxel march
//      runs in full warps whatever the lanes' statuses.
// Per step: the crossing test compares squared norms, taking the square
// roots only where they lie within 2^-20 (sqrt rounds correctly and is
// monotonic: the same outcome); a crossing takes its third alpha tap only
// where the first two leave the outcome open (an alpha lies in [0,
// 1.0000003], so two summing to >= 1.5 stay solid and two under 0.45 cannot
// reach it); and the lightgrid's 128^3 table takes Corners::load_cube,
// whose index math folds at compile time (any other size the general
// fetch).  The queue's order may change from launch to launch, a lane's
// arithmetic does not, so the bits are the same.  The matrices, the
// pyramid's level offsets, the rgb decode of the 256 u8 levels and the
// queue (struct of arrays) in shared memory.  Measured on an H100 80GB HBM3
// at 700 W, path C's diffuse ray (522,240 lanes): 0.19 ms device against the
// first design's 0.23 (a thread a lane, every phase in place); its share
// of the flop bound (the taps and roots the function needs) is in PERF.md.
// On that design every loop at its whole budget cost +47% and
// one more gather a fetch +24%, while conflict-free decode lookups and more
// resident blocks gained nothing.  The probes and the designs not kept:
// reference_sweep.py, reference_sweep.cu, PERF.md.
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

constexpr int kThreads = 128;           // a block: four warp tiles
constexpr int kMaxLevels = 16;          // the pyramid's levels (checked by the wrapper)
constexpr int kSkipSteps = 4;           // phase A's steps
constexpr float kOpenThresh = 0.3f;     // phase A's open threshold
constexpr float kHitThresh = 0.3f;      // _voxel_march's stop
constexpr float kSolid = 1.5f;          // three taps' alpha sum of a solid crossing
constexpr float kOpenSum = 0.45f;       // two taps' sum under which no third makes it solid
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

// What a block keeps in shared memory besides its queue: view_from_world,
// clip_from_view, view_from_clip, world_from_view, the pyramid's level
// offsets and the rgb decode of every u8 level.
struct Shared {
  float mats[64];
  int level_off[kMaxLevels];
  float decode[256];
};

// A lane's screen trace between two steps.
struct Trace {
  float pos[3], step[3];
  float slen, trav, dist;
};

// The block's march queue, at most one entry a thread: the lanes that
// march, their lane ids and open points (struct of arrays).
template <int B>
struct MarchQueue {
  int count;
  int lane[B];
  float ro[3][B];
};

// A slot in a queue for each lane of the warp that pushes (all 32 lanes
// call it): one shared atomic a warp.
__device__ __forceinline__ int queue_slot(int* count, bool push) {
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, push);
  const int slot = threadIdx.x & 31;
  int base = 0;
  if (slot == 0 && mask != 0u) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  return base + __popc(mask & ((1u << slot) - 1u));
}

// Appends the lanes of the warp that march (all 32 lanes call it).
template <int B>
__device__ __forceinline__ void push_march(MarchQueue<B>& q, bool marches, int lane,
                                           const float ro[3]) {
  const int slot = queue_slot(&q.count, marches);
  if (marches) {
    q.lane[slot] = lane;
    for (int c = 0; c < 3; ++c) q.ro[c][slot] = ro[c];
  }
}

// A trilinear fetch of the u8 table at uvw: G > 0 a table of G^3 texels
// (Corners::load_cube), 0 one of the sizes in a
template <int G>
__device__ __forceinline__ void fetch(const RefArgs& a, Corners& cs, float u, float v, float w) {
  if constexpr (G > 0) {
    cs.load_cube<G>(a, u, v, w);
  } else {
    cs.load(a, u, v, w);
  }
}

// alpha of the u8 table at grid-NDC p (uvw = p*0.5+0.5)
template <int G>
__device__ __forceinline__ float grid_alpha(const RefArgs& a, Corners& cs, const float p[3]) {
  fetch<G>(a, cs, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
  return cs.alpha();
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}

// norm3(s) < norm3(p), with the square roots only where the squared norms
// lie within 2^-20 of each other: sqrt rounds correctly and is monotonic,
// so squares further apart give different roots in the same order (and a
// NaN compares false either way)
__device__ __forceinline__ bool nearer(const float s[3], const float p[3]) {
  const float s2 = (s[0] * s[0] + s[1] * s[1]) + s[2] * s[2];
  const float p2 = (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2];
  return s2 < p2 && (p2 > s2 * 1.00000095367431640625f || sqrtf(s2) < sqrtf(p2));
}

// -- phase A: skip the initial blockage (the position freezes once open);
// ro is where the skip stopped.  Returns whether a voxel opened.
template <int G>
__device__ __forceinline__ bool skip_blockage(const RefArgs& a, int lane, float ro[3]) {
  float rd[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = a.rd[3 * lane + c] * a.voxel;
    ro[c] = a.pw[3 * lane + c] * a.scale;
  }
  Corners cs;
  bool found = false;
  for (int i = 0; i < kSkipSteps && !found; ++i) {
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rd[c];
    found = grid_alpha<G>(a, cs, ro) < kOpenThresh;
  }
  return found;
}

// -- phase B's set-up: the trace from the view position toward the open point
__device__ __forceinline__ void trace_begin(const RefArgs& a, const float* vfw, int lane,
                                            const float ro[3], Trace& t) {
  const float noise = a.noise[lane];
  const float p0[3] = {a.pv[3 * lane], a.pv[3 * lane + 1], a.pv[3 * lane + 2]};
  float to[3];
  const float q[3] = {ro[0] * a.inv_scale, ro[1] * a.inv_scale, ro[2] * a.inv_scale};
  for (int c = 0; c < 3; ++c) to[c] = xform(vfw, c, q[0], q[1], q[2]) - p0[c];
  const float step_len0 = fmaxf(p0[2], 1.0f) * (1.0f + noise) * kInv100;
  const float xy_len = fmaxf(sqrtf(to[0] * to[0] + to[1] * to[1]), 1e-8f);
  t.dist = norm3(to[0], to[1], to[2]);
  for (int c = 0; c < 3; ++c) {
    t.pos[c] = p0[c];
    t.step[c] = (to[c] / xy_len) * step_len0;
  }
  t.slen = step_len0;
  t.trav = 0.0f;
}

// -- phase B: up to `steps` steps of the trace.  Returns 0 while the lane is
// still tracing, else its status: 1 off screen, 2 past the open point, 3
// resolved (uv and step length in res).
template <int G>
__device__ __forceinline__ int trace_steps(const RefArgs& a, const Shared& sm, float noise,
                                           Trace& t, int steps, float res[3]) {
  const float* cfv = sm.mats + 16;
  const float* vfc = sm.mats + 32;
  const float* wfv = sm.mats + 48;
  const float noff = noise * 0.2f;
  const float bf = 2.0f + noise;
  Corners cs;
  for (int i = 0; i < steps; ++i) {
    for (int c = 0; c < 3; ++c) t.pos[c] = t.pos[c] + t.step[c];
    t.trav = t.trav + t.slen;
    const float cx = xform(cfv, 0, t.pos[0], t.pos[1], t.pos[2]);
    const float cy = xform(cfv, 1, t.pos[0], t.pos[1], t.pos[2]);
    const float cw = xform(cfv, 3, t.pos[0], t.pos[1], t.pos[2]);
    const float w = fabsf(cw) < 1e-8f ? 1e-8f : cw;
    const float nx = cx / w, ny = cy / w;
    if (fabsf(nx) > 1.0f || fabsf(ny) > 1.0f) return 1;
    for (int c = 0; c < 3; ++c) t.step[c] = t.step[c] * 1.2f;
    t.slen = t.slen * 1.2f;
    const float u = nx * 0.5f + 0.5f, v = ny * 0.5f + 0.5f;
    const float d = depth_nearest(a, u, v);
    float s4[4];
    for (int r = 0; r < 4; ++r) s4[r] = xform(vfc, r, nx, ny, d);
    const float sw = fabsf(s4[3]) < 1e-8f ? 1e-8f : s4[3];
    const float surf[3] = {s4[0] / sw, s4[1] / sw, s4[2] / sw};
    if (nearer(surf, t.pos)) {
      // a crossing: its solidity from three alpha taps between surface and ray
      float t0[3], t1[3];
      for (int c = 0; c < 3; ++c) {
        t0[c] = xform(wfv, c, surf[0], surf[1], surf[2]) * a.half_scale + 0.5f;
        t1[c] = xform(wfv, c, t.pos[0], t.pos[1], t.pos[2]) * a.half_scale + 0.5f;
      }
      float asum = 0.0f;
      for (int k = 0; k < 3; ++k) {
        // an alpha lies in [0, 1.0000003]: two taps summing to >= 1.5 stay
        // solid, and two under 0.45 cannot reach 1.5, whatever the third
        if (k == 2 && (asum >= kSolid || asum < kOpenSum)) break;
        const float f = noff + (k == 0 ? 0.2f : k == 1 ? 0.4f : 0.6f);
        fetch<G>(a, cs, t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                t0[2] + (t1[2] - t0[2]) * f);
        asum = asum + cs.alpha();
      }
      if (asum >= kSolid) {
        res[0] = u;
        res[1] = v;
        res[2] = t.slen;
        return 3;
      }
      // translucent: boost the step and keep going
      for (int c = 0; c < 3; ++c) t.step[c] = t.step[c] * bf;
      t.slen = t.slen * bf;
    } else if (t.trav > t.dist) {
      return 2;
    }
  }
  return 0;
}

__device__ __forceinline__ void store(const RefArgs& a, int lane, const float rgb[3], int status) {
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
}

// -- phase C, status 1: the lightgrid 2.5 voxels along the view direction,
// tone-compressed
template <int G>
__device__ __forceinline__ void fallback(const RefArgs& a, const Shared& sm, int lane,
                                         float rgb[3]) {
  float p[3], fb[3];
  for (int c = 0; c < 3; ++c)
    p[c] = a.pw[3 * lane + c] * a.scale + (2.5f * a.vd[3 * lane + c]) * a.voxel;
  Corners cs;
  fetch<G>(a, cs, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
  cs.rgb(sm.decode, fb);
  tone_compress(fb, rgb);
}

// -- phase C for a lane whose trace ended: the fallback (1), the pyramid (3),
// or 0 where no voxel opened (2), stored.  Returns whether the lane marches
// instead (2 with an open voxel; nothing stored).
template <int G>
__device__ __forceinline__ bool resolve(const RefArgs& a, const Shared& sm, int lane, int status,
                                        bool found, const float res[3]) {
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (status == 1) {
    fallback<G>(a, sm, lane, rgb);
  } else if (status == 3) {
    pyramid_resolve(a, sm.level_off, res[2], res[0], res[1], a.ss_intensity, rgb);
  } else if (found) {
    return true;
  }
  store(a, lane, rgb, status);
  return false;
}

// -- phase C for a marching lane: fog-march the grid from the open point ro
template <int G>
__device__ __forceinline__ void voxel_march(const RefArgs& a, const Shared& sm, int lane,
                                            float ro[3]) {
  Corners cs;
  float sum[4];
  fetch<G>(a, cs, ro[0] * 0.5f + 0.5f, ro[1] * 0.5f + 0.5f, ro[2] * 0.5f + 0.5f);
  cs.rgb(sm.decode, sum);
  sum[3] = 1e-4f + 1.0f;
  const float noise = a.noise[lane];
  const float fog = a.fog_lane != nullptr ? a.fog_lane[lane] : a.fog;
  float rdm[3];
  for (int c = 0; c < 3; ++c) {
    const float rd2 = (a.rd[3 * lane + c] * a.voxel) * a.step_scale;
    ro[c] = ro[c] + rd2 * noise;
    rdm[c] = 0.5f * rd2;
  }
  for (int i = 0; i < a.num_steps; ++i) {
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rdm[c];
    if (grid_alpha<G>(a, cs, ro) > kHitThresh) break;
    float s[3];
    cs.rgb(sm.decode, s);
    for (int c = 0; c < 3; ++c) sum[c] = sum[c] * fog + s[c];
    sum[3] = sum[3] * fog + 1.0f;
  }
  const float w = fmaxf(sum[3], 1e-4f);
  const float mean[3] = {sum[0] / w, sum[1] / w, sum[2] / w};
  float rgb[3];
  tone_compress(mean, rgb);
  store(a, lane, rgb, 2);
}

// The block's shared tables (B threads fill them; a barrier follows).
template <int B>
__device__ __forceinline__ void load_shared(const RefArgs& a, Shared& sm) {
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
  for (int v = tid; v < 256; v += B) sm.decode[v] = decode_rgb(v);
}

// This thread's lane in block blockIdx.x of B / 32 warp tiles, or -1
template <int B>
__device__ __forceinline__ int block_lane(const RefArgs& a) {
  const int tiles_x = (a.width + 32 / a.tile_h - 1) / (32 / a.tile_h);
  const int tiles = tiles_x * ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  const int t = blockIdx.x * (B / 32) + (threadIdx.x >> 5);
  return t < tiles ? tile_lane(a.n, a.width, a.tile_h, t, threadIdx.x & 31, tiles_x) : -1;
}

// The kernel: B threads a block, B / 32 warp tiles; G > 0 for a table of
// G^3 texels (the lightgrid's default 128), 0 for any size.
template <int B, int G>
__global__ void __launch_bounds__(B) gi_reference_ray_kernel(const RefArgs a) {
  __shared__ Shared sm;
  __shared__ MarchQueue<B> q;
  load_shared<B>(a, sm);
  if (threadIdx.x == 0) q.count = 0;
  __syncthreads();

  // -- stage 1: the skip, the trace and the resolves of a lane of this
  // warp's tile; the lanes that march join the queue
  const int lane = block_lane<B>(a);
  float ro[3];
  bool marches = false;
  if (lane >= 0) {
    const bool found = skip_blockage<G>(a, lane, ro);
    Trace tr;
    trace_begin(a, sm.mats, lane, ro, tr);
    float res[3];
    int status = trace_steps<G>(a, sm, a.noise[lane], tr, a.max_ss_steps, res);
    if (status == 0) status = 2;   // out of steps: on to the voxel march
    marches = resolve<G>(a, sm, lane, status, found, res);
  }
  push_march<B>(q, marches, lane, ro);

  // -- stage 2: the voxel march, 32 marching lanes a warp
  __syncthreads();
  if (threadIdx.x < q.count) {
    float mro[3] = {q.ro[0][threadIdx.x], q.ro[1][threadIdx.x], q.ro[2][threadIdx.x]};
    voxel_march<G>(a, sm, q.lane[threadIdx.x], mro);
  }
}

// the package's kernels: the lightgrid's default 128^3 table, any other
constexpr int kCube = 128;
constexpr auto kKernelCube = gi_reference_ray_kernel<kThreads, kCube>;
constexpr auto kKernel = gi_reference_ray_kernel<kThreads, 0>;

// A launch of `kernel` (B threads a block) over every warp tile of the lanes.
template <int B>
int launch_tiles(void (*kernel)(RefArgs), const RefArgs& a, int device, void* stream) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.n > 0) {
    const int tw = 32 / a.tile_h;
    const long long tiles = (long long)((a.width + tw - 1) / tw) *
                            ((a.n / a.width + a.tile_h - 1) / a.tile_h);
    const int grid = (int)((tiles + B / 32 - 1) / (B / 32));
    kernel<<<grid, B, 0, (cudaStream_t)stream>>>(a);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// registers, local memory and static shared memory a thread / block,
// resident blocks an SM of `kernel` (B threads a block)
template <int B>
int occupancy(void (*kernel)(RefArgs), int* registers, int* local_bytes, int* blocks_per_sm,
              int* threads, int* shared_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *threads = B;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, B, 0);
}

}  // namespace

extern "C" int gi_reference_ray_launch(const RefArgs* args, int device, void* stream) {
  const RefArgs& a = *args;
  const bool cube = a.gd == kCube && a.gh == kCube && a.gw == kCube;
  return launch_tiles<kThreads>(cube ? kKernelCube : kKernel, a, device, stream);
}

// registers, local memory, resident blocks an SM, threads a block and static
// shared memory of the compiled kernel for a table of gd x gh x gw texels,
// for chip_smoke.py
extern "C" int gi_reference_ray_occupancy(int gd, int gh, int gw, int* registers,
                                          int* local_bytes, int* blocks_per_sm, int* threads,
                                          int* shared_bytes) {
  const bool cube = gd == kCube && gh == kCube && gw == kCube;
  return occupancy<kThreads>(cube ? kKernelCube : kKernel, registers, local_bytes,
                             blocks_per_sm, threads, shared_bytes);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
