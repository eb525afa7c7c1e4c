// Sweep-only source (reference_sweep.py), never built by the package: the
// reference-GI ray kernel's forks and probes.  It compiles the package's
// csrc/gi_reference_ray.cu into the same library, renaming that file's
// launcher and occupancy query, so that this file's take their place
// behind shade/gi.py's gi.run_reference_ray.
//
// REF_VARIANT selects the kernel behind the launcher:
//  - 0: the first design's kernel (a thread a lane in 8 x 4 warp
//    tiles, each loop left where the lane's masks freeze it, the march in
//    place), built on the package's helpers (gi_common.cuh), with the
//    probes of REF_PROBE, a sum of (each but 1 not the plain version's
//    bits; timed only):
//      1 every lane runs every loop's whole budget (the skip's 4 steps, the
//        trace's max_ss_steps, the march's num_steps), a lane past its stop
//        fetching at its frozen state, its results unchanged (divergence);
//      2 every corner and depth load reads the first word of its table, the
//        index math kept (gathers);
//      4 no march: a marching lane's rgb is its open sample's;
//      8 the decode table read at a conflict-free address (bank `lane`,
//        row from the level's low bits): the lookups without bank
//        conflicts;
//     16 no decode lookups: a level's rgb is the level itself;
//     32 every corner and depth load issued twice, the second from the same
//        address through an offset the compiler cannot see (n >> 31) and
//        ANDed away: the cost of one more gather a fetch (exact);
//    and REF_MIN_BLOCKS, __launch_bounds__' blocks an SM (0 none).
//  - 1: the package's kernel (its launcher, unchanged);
//  - 2: the package's stages built from its pieces (load_shared,
//    block_lane, skip_blockage, trace_begin, resolve, push_march,
//    voxel_march) at REF_BLOCK threads a block, with a trace queue after
//    REF_SPLIT trace steps (0: none, the package's stages) and the trace
//    step REF_STEP: -1 the package's trace_steps, else this file's fork of
//    it (0: the first design's step) with a sum of
//      1 the three taps' 24 corner loads issued together, then their alphas;
//      2 the next step's position, projection and depth load issued before
//        this step's crossing test (redone where a translucent crossing
//        boosts the step);
//      4 the crossing test on squared norms, the square roots only where
//        the two lie within 2^-20 (the same outcome: sqrt is monotonic and
//        rounds two values further apart to different floats);
//      8 the third tap only where the first two leave the outcome open
//        (their sum in [0.45, 1.5): an alpha lies in [0, 1.0000003], so a
//        sum of two >= 1.5 stays solid and one < 0.45 cannot reach 1.5).
//    All exact.  The 128^3 table takes the package's fixed-size fetch
//    (Corners::load_cube) unless REF_NO_CUBE=1 (the general fetch);
//    REF_MIN_BLOCKS bounds the registers here too.
//  - 3: the package's stages at REF_BLOCK threads with the trace's taps
//    shared by the warp (trace_steps_coop): every lane of a warp stays in
//    the trace loop until all are done, and each step's crossings put
//    their first two taps' points in shared memory, which the warp's lanes
//    take in turn (the finished lanes among them), then the thirds still
//    open the same way; each lane sums its own alphas in order.  Exact.
//  - 4: the resolves queued too: stage 1 appends a lane to one of three
//    queues (the pyramid's uv and step, the fallback, the march's open
//    point) and stage 2 takes the pyramids, the fallbacks, then the
//    marches, 32 lanes of one kind a warp.  Exact.

#define gi_reference_ray_launch gi_reference_ray_launch_package
#define gi_reference_ray_occupancy gi_reference_ray_occupancy_package
#include "vulkan_pbr_renderer_tpu_torch/csrc/gi_reference_ray.cu"
#undef gi_reference_ray_launch
#undef gi_reference_ray_occupancy

#ifndef REF_VARIANT
#define REF_VARIANT 0
#endif
#ifndef REF_PROBE
#define REF_PROBE 0
#endif
#ifndef REF_MIN_BLOCKS
#define REF_MIN_BLOCKS 0
#endif
#ifndef REF_BLOCK
#define REF_BLOCK 128
#endif
#ifndef REF_SPLIT
#define REF_SPLIT 0
#endif
#ifndef REF_STEP
#define REF_STEP -1
#endif
#ifndef REF_NO_CUBE
#define REF_NO_CUBE 0
#endif

namespace {

constexpr int pThreads = 128;
constexpr int pWarps = pThreads / 32;
constexpr bool pFull = (REF_PROBE & 1) != 0;
constexpr bool pFixed = (REF_PROBE & 2) != 0;
constexpr bool pNoMarch = (REF_PROBE & 4) != 0;
constexpr bool pNoBank = (REF_PROBE & 8) != 0;
constexpr bool pNoLookup = (REF_PROBE & 16) != 0;
constexpr bool pTwice = (REF_PROBE & 32) != 0;

struct ProbeShared {
  float mats[64];
  int level_off[16];
  float decode[256];
};

// Corners::load's index math; with pFixed every load reads the table's
// first word (the offset ANDed with a zero the compiler cannot see: n >> 31)
__device__ __forceinline__ void probe_load(const RefArgs& a, Corners& cs, float u, float v,
                                           float w) {
  const float x = u * (float)a.gw - 0.5f;
  const float y = v * (float)a.gh - 0.5f;
  const float z = w * (float)a.gd - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  cs.fx = window_frac(x, x0f);
  cs.fy = window_frac(y, y0f);
  cs.fz = window_frac(z, z0f);
  const int ix = clamp_index(x0f, a.gw), iy = clamp_index(y0f, a.gh);
  const int iz = clamp_index(z0f, a.gd);
  const int cell = (iz * a.gh + iy) * a.gw + ix;
  const int dy = iy + 1 < a.gh ? a.gw : 0;
  const int dz = iz + 1 < a.gd ? a.gh * a.gw : 0;
  const int dx = ix + 1 < a.gw ? 1 : 0;
  const int mask = pFixed ? (a.n >> 31) : -1;
  const unsigned int* t = reinterpret_cast<const unsigned int*>(a.table);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int off = ((k & 1) ? dx : 0) + ((k & 2) ? dy : 0) + ((k & 4) ? dz : 0);
    cs.c[k] = __ldg(t + ((cell + off) & mask));
    if (pTwice) cs.c[k] |= __ldg(t + (cell + off + (a.n >> 31))) & (unsigned)(a.n >> 31);
  }
}

__device__ __forceinline__ float probe_alpha(const RefArgs& a, Corners& cs, const float p[3]) {
  probe_load(a, cs, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
  return cs.alpha();
}

__device__ __forceinline__ void probe_rgb(const Corners& cs, const float* decode, float out[3]) {
  const unsigned slot = threadIdx.x & 31u;
  float k[8];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned q = (cs.c[i] >> (8 * ch)) & 0xFFu;
      k[i] = pNoLookup ? level_f32(q) : pNoBank ? decode[(q & 7u) * 32u + slot] : decode[q];
    }
    out[ch] = lerp8(k, cs.fx, cs.fy, cs.fz);
  }
}

__device__ __forceinline__ float probe_depth(const RefArgs& a, float u, float v) {
  const int ix = clamp_index(floorf(u * (float)a.tw), a.tw);
  const int iy = clamp_index(floorf(v * (float)a.th), a.th);
  const int mask = pFixed ? (a.n >> 31) : -1;
  float d = __ldg(a.depth + ((iy * a.tw + ix) & mask));
  if (pTwice)
    d = __uint_as_float(__float_as_uint(d) |
                        (__float_as_uint(__ldg(a.depth + (iy * a.tw + ix + (a.n >> 31)))) &
                         (unsigned)(a.n >> 31)));
  return d + 0.0f;
}

// The first design's ray of one lane, with the probes.
__device__ void probe_ray(const RefArgs& a, const ProbeShared& sm, int lane) {
  const float* vfw = sm.mats;
  const float* cfv = sm.mats + 16;
  const float* vfc = sm.mats + 32;
  const float* wfv = sm.mats + 48;
  float sink = 0.0f;   // pFull: what a stopped lane fetched

  const float noise = a.noise[lane];
  float rd[3], ro[3];
  for (int c = 0; c < 3; ++c) {
    rd[c] = a.rd[3 * lane + c] * a.voxel;
    ro[c] = a.pw[3 * lane + c] * a.scale;
  }

  Corners cs;
  bool found = false;
  for (int i = 0; i < kSkipSteps; ++i) {
    if (found) {
      if (!pFull) break;
      sink += probe_alpha(a, cs, ro);
      continue;
    }
    for (int c = 0; c < 3; ++c) ro[c] = ro[c] + rd[c];
    found = probe_alpha(a, cs, ro) < kOpenThresh;
  }

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
  int status = 0;
  for (int i = 0; i < a.max_ss_steps; ++i) {
    const bool live = status == 0;
    if (!live && !pFull) break;
    float np[3];
    for (int c = 0; c < 3; ++c) np[c] = pos[c] + step[c];
    const float cx = xform(cfv, 0, np[0], np[1], np[2]);
    const float cy = xform(cfv, 1, np[0], np[1], np[2]);
    const float cw = xform(cfv, 3, np[0], np[1], np[2]);
    const float w = fabsf(cw) < 1e-8f ? 1e-8f : cw;
    const float nx = cx / w, ny = cy / w;
    const bool off = fabsf(nx) > 1.0f || fabsf(ny) > 1.0f;
    if (live) {
      for (int c = 0; c < 3; ++c) pos[c] = np[c];
      trav = trav + slen;
      if (off) {
        status = 1;
        continue;
      }
      for (int c = 0; c < 3; ++c) step[c] = step[c] * 1.2f;
      slen = slen * 1.2f;
    }
    const float u = nx * 0.5f + 0.5f, v = ny * 0.5f + 0.5f;
    const float d = probe_depth(a, u, v);
    float s4[4];
    for (int r = 0; r < 4; ++r) s4[r] = xform(vfc, r, nx, ny, d);
    const float sw = fabsf(s4[3]) < 1e-8f ? 1e-8f : s4[3];
    const float surf[3] = {s4[0] / sw, s4[1] / sw, s4[2] / sw};
    if (norm3(surf[0], surf[1], surf[2]) < norm3(np[0], np[1], np[2])) {
      float t0[3], t1[3];
      for (int c = 0; c < 3; ++c) {
        t0[c] = xform(wfv, c, surf[0], surf[1], surf[2]) * a.half_scale + 0.5f;
        t1[c] = xform(wfv, c, np[0], np[1], np[2]) * a.half_scale + 0.5f;
      }
      float asum = 0.0f;
      for (int k = 0; k < 3; ++k) {
        const float f = noff + (k == 0 ? 0.2f : k == 1 ? 0.4f : 0.6f);
        probe_load(a, cs, t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                   t0[2] + (t1[2] - t0[2]) * f);
        asum = asum + cs.alpha();
      }
      if (!live) {
        sink += asum;
        continue;
      }
      if (asum >= kSolid) {
        status = 3;
        res_u = u;
        res_v = v;
        res_slen = slen;
        continue;
      }
      for (int c = 0; c < 3; ++c) step[c] = step[c] * bf;
      slen = slen * bf;
    } else if (!live) {
      sink += d;
    } else if (trav > dist) {
      status = 2;
    }
  }
  if (status == 0) status = 2;

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (status == 1) {
    float p[3], fb[3];
    for (int c = 0; c < 3; ++c)
      p[c] = a.pw[3 * lane + c] * a.scale + (2.5f * a.vd[3 * lane + c]) * a.voxel;
    probe_load(a, cs, p[0] * 0.5f + 0.5f, p[1] * 0.5f + 0.5f, p[2] * 0.5f + 0.5f);
    probe_rgb(cs, sm.decode, fb);
    tone_compress(fb, rgb);
  } else if (status == 3) {
    pyramid_resolve(a, sm.level_off, res_slen, res_u, res_v, a.ss_intensity, rgb);
  }
  const bool marches = status == 2 && found;
  if (marches || pFull) {
    float sum[4];
    probe_load(a, cs, ro[0] * 0.5f + 0.5f, ro[1] * 0.5f + 0.5f, ro[2] * 0.5f + 0.5f);
    probe_rgb(cs, sm.decode, sum);
    sum[3] = 1e-4f + 1.0f;
    const float fog = a.fog_lane != nullptr ? a.fog_lane[lane] : a.fog;
    float rdm[3];
    for (int c = 0; c < 3; ++c) {
      const float rd2 = rd[c] * a.step_scale;
      ro[c] = ro[c] + rd2 * noise;
      rdm[c] = 0.5f * rd2;
    }
    bool live = marches;
    for (int i = 0; i < (pNoMarch ? 0 : a.num_steps); ++i) {
      if (!live && !pFull) break;
      float np[3];
      for (int c = 0; c < 3; ++c) np[c] = ro[c] + rdm[c];
      const float al = probe_alpha(a, cs, np);
      if (!live) {
        sink += al;
        continue;
      }
      for (int c = 0; c < 3; ++c) ro[c] = np[c];
      if (al > kHitThresh) {
        live = false;
        continue;
      }
      float s[3];
      probe_rgb(cs, sm.decode, s);
      for (int c = 0; c < 3; ++c) sum[c] = sum[c] * fog + s[c];
      sum[3] = sum[3] * fog + 1.0f;
    }
    if (marches) {
      const float w = fmaxf(sum[3], 1e-4f);
      const float mean[3] = {sum[0] / w, sum[1] / w, sum[2] / w};
      tone_compress(mean, rgb);
    } else {
      sink += sum[0];
    }
  }
  if (sink == -1.0e30f) rgb[0] = sink;   // keeps a stopped lane's fetches alive
  for (int c = 0; c < 3; ++c) a.out_rgb[3 * lane + c] = rgb[c];
  a.out_status[lane] = status;
}

#if REF_MIN_BLOCKS > 0
__global__ void __launch_bounds__(pThreads, REF_MIN_BLOCKS)
#else
__global__ void __launch_bounds__(pThreads)
#endif
    gi_reference_probe_kernel(const RefArgs a) {
  __shared__ ProbeShared sm;
  const int tid = threadIdx.x;
  if (tid < 16) {
    sm.mats[tid] = a.view_from_world[tid];
    sm.mats[16 + tid] = a.clip_from_view[tid];
    sm.mats[32 + tid] = a.view_from_clip[tid];
    sm.mats[48 + tid] = a.world_from_view[tid];
    int off = 0;
    for (int j = 0; j < tid; ++j) off += max(1, a.prev_w >> j);
    sm.level_off[tid] = off;
  }
  for (int q = tid; q < 256; q += pThreads) sm.decode[q] = decode_rgb(q);
  __syncthreads();
  const int tiles_x = (a.width + 32 / a.tile_h - 1) / (32 / a.tile_h);
  const int tiles = tiles_x * ((a.n / a.width + a.tile_h - 1) / a.tile_h);
  const int t = blockIdx.x * pWarps + (tid >> 5);
  const int lane = t < tiles ? tile_lane(a.n, a.width, a.tile_h, t, tid & 31, tiles_x) : -1;
  if (lane >= 0) probe_ray(a, sm, lane);
}


// -- REF_VARIANT 2: the queue kernels built from the package's pieces

// the screen position of a view point: ndc x, y (|w| < 1e-8 made 1e-8)
__device__ __forceinline__ void project(const float* cfv, const float p[3], float& nx,
                                        float& ny) {
  const float cx = xform(cfv, 0, p[0], p[1], p[2]);
  const float cy = xform(cfv, 1, p[0], p[1], p[2]);
  const float cw = xform(cfv, 3, p[0], p[1], p[2]);
  const float w = fabsf(cw) < 1e-8f ? 1e-8f : cw;
  nx = cx / w;
  ny = cy / w;
}

// trace_steps with the forks of REF_STEP's bits
template <int kStep, int G>
__device__ __forceinline__ int trace_steps_fork(const RefArgs& a, const Shared& sm, float noise,
                                                Trace& t, int steps, float res[3]) {
  constexpr bool kBatch = (kStep & 1) != 0, kPre = (kStep & 2) != 0, kSq = (kStep & 4) != 0;
  constexpr bool kTap3 = (kStep & 8) != 0;
  const float* cfv = sm.mats + 16;
  const float* vfc = sm.mats + 32;
  const float* wfv = sm.mats + 48;
  const float noff = noise * 0.2f;
  const float bf = 2.0f + noise;
  float nxt[3], nx_n = 0.0f, ny_n = 0.0f, d_n = 0.0f;   // kPre: the coming step's
  bool have = false;
  for (int i = 0; i < steps; ++i) {
    float nx, ny, d = 0.0f;
    if (kPre && have) {
      for (int c = 0; c < 3; ++c) t.pos[c] = nxt[c];
      nx = nx_n;
      ny = ny_n;
      d = d_n;
    } else {
      for (int c = 0; c < 3; ++c) t.pos[c] = t.pos[c] + t.step[c];
      project(cfv, t.pos, nx, ny);
    }
    t.trav = t.trav + t.slen;
    if (fabsf(nx) > 1.0f || fabsf(ny) > 1.0f) return 1;
    for (int c = 0; c < 3; ++c) t.step[c] = t.step[c] * 1.2f;
    t.slen = t.slen * 1.2f;
    const float u = nx * 0.5f + 0.5f, v = ny * 0.5f + 0.5f;
    if (!(kPre && have)) d = depth_nearest(a, u, v);
    have = false;
    if (kPre && i + 1 < steps) {
      for (int c = 0; c < 3; ++c) nxt[c] = t.pos[c] + t.step[c];
      project(cfv, nxt, nx_n, ny_n);
      d_n = depth_nearest(a, nx_n * 0.5f + 0.5f, ny_n * 0.5f + 0.5f);
      have = true;
    }
    float s4[4];
    for (int r = 0; r < 4; ++r) s4[r] = xform(vfc, r, nx, ny, d);
    const float sw = fabsf(s4[3]) < 1e-8f ? 1e-8f : s4[3];
    const float surf[3] = {s4[0] / sw, s4[1] / sw, s4[2] / sw};
    bool cross;
    if (kSq) {
      const float sa = (surf[0] * surf[0] + surf[1] * surf[1]) + surf[2] * surf[2];
      const float sb = (t.pos[0] * t.pos[0] + t.pos[1] * t.pos[1]) + t.pos[2] * t.pos[2];
      cross = sa < sb && (sb > sa * 1.00000095367431640625f || sqrtf(sa) < sqrtf(sb));
    } else {
      cross = norm3(surf[0], surf[1], surf[2]) < norm3(t.pos[0], t.pos[1], t.pos[2]);
    }
    if (cross) {
      float t0[3], t1[3];
      for (int c = 0; c < 3; ++c) {
        t0[c] = xform(wfv, c, surf[0], surf[1], surf[2]) * a.half_scale + 0.5f;
        t1[c] = xform(wfv, c, t.pos[0], t.pos[1], t.pos[2]) * a.half_scale + 0.5f;
      }
      float asum = 0.0f;
      if (kBatch) {
        Corners cs[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float f = noff + (k == 0 ? 0.2f : k == 1 ? 0.4f : 0.6f);
          fetch<G>(a, cs[k], t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                   t0[2] + (t1[2] - t0[2]) * f);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) asum = asum + cs[k].alpha();
      } else {
        Corners cs;
        for (int k = 0; k < 3; ++k) {
          if (kTap3 && k == 2 && (asum >= kSolid || asum < 0.45f)) break;
          const float f = noff + (k == 0 ? 0.2f : k == 1 ? 0.4f : 0.6f);
          fetch<G>(a, cs, t0[0] + (t1[0] - t0[0]) * f, t0[1] + (t1[1] - t0[1]) * f,
                   t0[2] + (t1[2] - t0[2]) * f);
          asum = asum + cs.alpha();
        }
      }
      if (asum >= kSolid) {
        res[0] = u;
        res[1] = v;
        res[2] = t.slen;
        return 3;
      }
      for (int c = 0; c < 3; ++c) t.step[c] = t.step[c] * bf;
      t.slen = t.slen * bf;
      have = false;   // the coming step was projected with the unboosted step
    } else if (t.trav > t.dist) {
      return 2;
    }
  }
  return 0;
}

template <int kStep, int G>
__device__ __forceinline__ int run_steps(const RefArgs& a, const Shared& sm, float noise,
                                         Trace& t, int steps, float res[3]) {
  if constexpr (kStep < 0) {
    return trace_steps<G>(a, sm, noise, t, steps, res);
  } else {
    return trace_steps_fork<kStep, G>(a, sm, noise, t, steps, res);
  }
}

// the trace queue: lanes still tracing after the split (lane id, ~id where
// no voxel opened; the trace state and the open point)
constexpr int kTraceWords = 12;
template <int B>
struct TraceQueue {
  int count;
  int lane[B];
  float state[kTraceWords][B];
};

#if REF_MIN_BLOCKS > 0
#define REF_QUEUE_BOUNDS __launch_bounds__(B, REF_MIN_BLOCKS)
#else
#define REF_QUEUE_BOUNDS __launch_bounds__(B)
#endif

template <int B, int kSplit, int kStep, int G>
__global__ void REF_QUEUE_BOUNDS composed_kernel(const RefArgs a) {
  __shared__ Shared sm;
  __shared__ MarchQueue<B> q;
  __shared__ TraceQueue<(kSplit > 0 ? B : 1)> tq;
  load_shared<B>(a, sm);
  if (threadIdx.x == 0) q.count = tq.count = 0;
  __syncthreads();

  const int lane = block_lane<B>(a);
  const int first = kSplit > 0 ? min(kSplit, a.max_ss_steps) : a.max_ss_steps;
  float ro[3];
  Trace tr;
  bool found = false, traces = false, marches = false;
  if (lane >= 0) {
    found = skip_blockage<G>(a, lane, ro);
    trace_begin(a, sm.mats, lane, ro, tr);
    float res[3];
    int status = run_steps<kStep, G>(a, sm, a.noise[lane], tr, first, res);
    if (status == 0 && first == a.max_ss_steps) status = 2;
    traces = status == 0;
    if (!traces) marches = resolve<G>(a, sm, lane, status, found, res);
  }
  if constexpr (kSplit > 0) {
    const int slot = queue_slot(&tq.count, traces);
    if (traces) {
      tq.lane[slot] = found ? lane : ~lane;
      const float state[kTraceWords] = {tr.pos[0], tr.pos[1], tr.pos[2], tr.step[0], tr.step[1],
                                        tr.step[2], tr.slen, tr.trav, tr.dist,
                                        ro[0], ro[1], ro[2]};
#pragma unroll
      for (int k = 0; k < kTraceWords; ++k) tq.state[k][slot] = state[k];
    }
  }
  push_march<B>(q, marches, lane, ro);
  if constexpr (kSplit > 0) {
    __syncthreads();
    marches = false;
    int tlane = -1;
    if (threadIdx.x < tq.count) {
      const int e = tq.lane[threadIdx.x];
      tlane = e >= 0 ? e : ~e;
      float st[kTraceWords];
#pragma unroll
      for (int k = 0; k < kTraceWords; ++k) st[k] = tq.state[k][threadIdx.x];
      tr = Trace{{st[0], st[1], st[2]}, {st[3], st[4], st[5]}, st[6], st[7], st[8]};
      for (int c = 0; c < 3; ++c) ro[c] = st[9 + c];
      float res[3];
      int status = run_steps<kStep, G>(a, sm, a.noise[tlane], tr, a.max_ss_steps - first, res);
      if (status == 0) status = 2;
      marches = resolve<G>(a, sm, tlane, status, e >= 0, res);
    }
    push_march<B>(q, marches, tlane, ro);
  }
  __syncthreads();
  if (threadIdx.x < q.count) {
    float mro[3] = {q.ro[0][threadIdx.x], q.ro[1][threadIdx.x], q.ro[2][threadIdx.x]};
    voxel_march<G>(a, sm, q.lane[threadIdx.x], mro);
  }
}


// -- REF_VARIANT 3: the package's stages with the taps shared by the warp

// a warp's cooperative taps: job j's uvw point and its alpha
struct TapScratch {
  float pt[3][64];
  float alpha[64];
};

// jobs [0, n) of ts, taken by the lanes of `warp` in turn; a warp barrier after
template <int G>
__device__ __forceinline__ void coop_taps(const RefArgs& a, TapScratch& ts, unsigned warp, int n) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  const int nw = __popc(warp);
  for (int j = __popc(warp & lt); j < n; j += nw) {
    Corners cs;
    fetch<G>(a, cs, ts.pt[0][j], ts.pt[1][j], ts.pt[2][j]);
    ts.alpha[j] = cs.alpha();
  }
  __syncwarp(warp);
}

// trace_steps (the package's squared-norm test and third-tap rule) with
// every lane of `warp` in the loop until all are done, each crossing's
// first two taps (then the open thirds) spread over the warp's lanes, the
// lanes that finished their trace among them; each lane sums its own
// taps' alphas in order (the same bits)
template <int G>
__device__ int trace_steps_coop(const RefArgs& a, const Shared& sm, float noise, Trace& t,
                                int steps, float res[3], TapScratch& ts, unsigned warp) {
  const float* cfv = sm.mats + 16;
  const float* vfc = sm.mats + 32;
  const float* wfv = sm.mats + 48;
  const float noff = noise * 0.2f;
  const float bf = 2.0f + noise;
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  int status = 0, i = 0;
  bool live = steps > 0;
  while (__any_sync(warp, live)) {
    bool cross = false;
    float t0[3], t1[3], u = 0.0f, v = 0.0f;
    if (live) {
      for (int c = 0; c < 3; ++c) t.pos[c] = t.pos[c] + t.step[c];
      t.trav = t.trav + t.slen;
      const float cx = xform(cfv, 0, t.pos[0], t.pos[1], t.pos[2]);
      const float cy = xform(cfv, 1, t.pos[0], t.pos[1], t.pos[2]);
      const float cw = xform(cfv, 3, t.pos[0], t.pos[1], t.pos[2]);
      const float w = fabsf(cw) < 1e-8f ? 1e-8f : cw;
      const float nx = cx / w, ny = cy / w;
      if (fabsf(nx) > 1.0f || fabsf(ny) > 1.0f) {
        status = 1;
        live = false;
      } else {
        for (int c = 0; c < 3; ++c) t.step[c] = t.step[c] * 1.2f;
        t.slen = t.slen * 1.2f;
        u = nx * 0.5f + 0.5f;
        v = ny * 0.5f + 0.5f;
        const float d = depth_nearest(a, u, v);
        float s4[4];
        for (int r = 0; r < 4; ++r) s4[r] = xform(vfc, r, nx, ny, d);
        const float sw = fabsf(s4[3]) < 1e-8f ? 1e-8f : s4[3];
        const float surf[3] = {s4[0] / sw, s4[1] / sw, s4[2] / sw};
        if (nearer(surf, t.pos)) {
          cross = true;
          for (int c = 0; c < 3; ++c) {
            t0[c] = xform(wfv, c, surf[0], surf[1], surf[2]) * a.half_scale + 0.5f;
            t1[c] = xform(wfv, c, t.pos[0], t.pos[1], t.pos[2]) * a.half_scale + 0.5f;
          }
        } else if (t.trav > t.dist) {
          status = 2;
          live = false;
        }
      }
    }
    const unsigned cm = __ballot_sync(warp, cross);
    if (cm != 0u) {
      const int rank = __popc(cm & lt);
      if (cross) {
        for (int k = 0; k < 2; ++k) {
          const float f = noff + (k == 0 ? 0.2f : 0.4f);
          for (int c = 0; c < 3; ++c) ts.pt[c][2 * rank + k] = t0[c] + (t1[c] - t0[c]) * f;
        }
      }
      __syncwarp(warp);
      coop_taps<G>(a, ts, warp, 2 * __popc(cm));
      float asum = 0.0f;
      bool third = false;
      if (cross) {
        asum = asum + ts.alpha[2 * rank];
        asum = asum + ts.alpha[2 * rank + 1];
        third = !(asum >= kSolid || asum < kOpenSum);
      }
      const unsigned tm = __ballot_sync(warp, third);
      if (tm != 0u) {
        __syncwarp(warp);
        const int r3 = __popc(tm & lt);
        if (third) {
          const float f = noff + 0.6f;
          for (int c = 0; c < 3; ++c) ts.pt[c][r3] = t0[c] + (t1[c] - t0[c]) * f;
        }
        __syncwarp(warp);
        coop_taps<G>(a, ts, warp, __popc(tm));
        if (third) asum = asum + ts.alpha[r3];
      }
      __syncwarp(warp);
      if (cross) {
        if (asum >= kSolid) {
          res[0] = u;
          res[1] = v;
          res[2] = t.slen;
          status = 3;
          live = false;
        } else {
          for (int c = 0; c < 3; ++c) t.step[c] = t.step[c] * bf;
          t.slen = t.slen * bf;
        }
      }
    }
    if (live && ++i == steps) live = false;
  }
  return status;
}

template <int B, int G>
__global__ void __launch_bounds__(B) coop_kernel(const RefArgs a) {
  __shared__ Shared sm;
  __shared__ MarchQueue<B> q;
  __shared__ TapScratch ts[B / 32];
  load_shared<B>(a, sm);
  if (threadIdx.x == 0) q.count = 0;
  __syncthreads();
  const int lane = block_lane<B>(a);
  const unsigned warp = __ballot_sync(0xFFFFFFFFu, lane >= 0);
  float ro[3];
  bool marches = false;
  if (lane >= 0) {
    const bool found = skip_blockage<G>(a, lane, ro);
    Trace tr;
    trace_begin(a, sm.mats, lane, ro, tr);
    float res[3];
    int status = trace_steps_coop<G>(a, sm, a.noise[lane], tr, a.max_ss_steps, res,
                                     ts[threadIdx.x >> 5], warp);
    if (status == 0) status = 2;
    marches = resolve<G>(a, sm, lane, status, found, res);
  }
  push_march<B>(q, marches, lane, ro);
  __syncthreads();
  if (threadIdx.x < q.count) {
    float mro[3] = {q.ro[0][threadIdx.x], q.ro[1][threadIdx.x], q.ro[2][threadIdx.x]};
    voxel_march<G>(a, sm, q.lane[threadIdx.x], mro);
  }
}

// -- REF_VARIANT 4: the resolves queued too

// what stage 2 does for a lane, by kind: the pyramid (status 3), the
// fallback (1), the voxel march (2 with an open voxel)
enum Kind { kPyramid, kFallback, kMarch, kKinds };

template <int B>
struct Queues {
  int count[kKinds];
  int lane[kKinds][B];
  float data[kKinds][3][B];   // the pyramid's u, v and step length; the march's open point
};

template <int B>
__device__ __forceinline__ void push(Queues<B>& q, int kind, int lane, const float d[3]) {
#pragma unroll
  for (int k = 0; k < kKinds; ++k) {
    const int slot = queue_slot(&q.count[k], kind == k);
    if (kind == k) {
      q.lane[k][slot] = lane;
      for (int c = 0; c < 3; ++c) q.data[k][c][slot] = d[c];
    }
  }
}

template <int B, int G>
__global__ void __launch_bounds__(B) resolve_queue_kernel(const RefArgs a) {
  __shared__ Shared sm;
  __shared__ Queues<B> q;
  load_shared<B>(a, sm);
  if (threadIdx.x < kKinds) q.count[threadIdx.x] = 0;
  __syncthreads();
  const int lane = block_lane<B>(a);
  int kind = -1;
  float d[3];
  if (lane >= 0) {
    float ro[3];
    const bool found = skip_blockage<G>(a, lane, ro);
    Trace tr;
    trace_begin(a, sm.mats, lane, ro, tr);
    float res[3];
    const int status = trace_steps<G>(a, sm, a.noise[lane], tr, a.max_ss_steps, res);
    kind = status == 1 ? kFallback : status == 3 ? kPyramid : found ? kMarch : -1;
    for (int c = 0; c < 3; ++c) d[c] = kind == kMarch ? ro[c] : res[c];
    if (kind < 0) {
      const float zero[3] = {0.0f, 0.0f, 0.0f};
      store(a, lane, zero, 2);
    }
  }
  push<B>(q, kind, lane, d);
  __syncthreads();
  int t = threadIdx.x;
  float rgb[3];
  if (t < q.count[kPyramid]) {
    pyramid_resolve(a, sm.level_off, q.data[kPyramid][2][t], q.data[kPyramid][0][t],
                    q.data[kPyramid][1][t], a.ss_intensity, rgb);
    store(a, q.lane[kPyramid][t], rgb, 3);
  } else if ((t -= q.count[kPyramid]) < q.count[kFallback]) {
    fallback<G>(a, sm, q.lane[kFallback][t], rgb);
    store(a, q.lane[kFallback][t], rgb, 1);
  } else if ((t -= q.count[kFallback]) < q.count[kMarch]) {
    float ro[3] = {q.data[kMarch][0][t], q.data[kMarch][1][t], q.data[kMarch][2][t]};
    voxel_march<G>(a, sm, q.lane[kMarch][t], ro);
  }
}

// the kernel of a variant for a table of gd x gh x gw texels: its 128^3
// instance where the table is 128^3
#if REF_VARIANT == 2
template <int G>
constexpr auto kVariant = composed_kernel<REF_BLOCK, REF_SPLIT, REF_STEP, G>;
#elif REF_VARIANT == 3
template <int G>
constexpr auto kVariant = coop_kernel<REF_BLOCK, G>;
#elif REF_VARIANT == 4
template <int G>
constexpr auto kVariant = resolve_queue_kernel<REF_BLOCK, G>;
#endif
#if REF_VARIANT >= 2
auto variant_kernel(int gd, int gh, int gw) {
  const bool cube = !REF_NO_CUBE && gd == kCube && gh == kCube && gw == kCube;
  return cube ? kVariant<kCube> : kVariant<0>;
}
#endif

}  // namespace

#if REF_VARIANT == 0
extern "C" int gi_reference_ray_launch(const RefArgs* args, int device, void* stream) {
  const RefArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.n > 0) {
    const int tw = 32 / a.tile_h;
    const long long tiles = (long long)((a.width + tw - 1) / tw) *
                            ((a.n / a.width + a.tile_h - 1) / a.tile_h);
    const int grid = (int)((tiles + pWarps - 1) / pWarps);
    gi_reference_probe_kernel<<<grid, pThreads, 0, (cudaStream_t)stream>>>(a);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int gi_reference_ray_occupancy(int, int, int, int* registers, int* local_bytes,
                                          int* blocks_per_sm, int* threads, int* shared_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gi_reference_probe_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *threads = pThreads;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            gi_reference_probe_kernel, pThreads, 0);
}
#elif REF_VARIANT >= 2
extern "C" int gi_reference_ray_launch(const RefArgs* args, int device, void* stream) {
  return launch_tiles<REF_BLOCK>(variant_kernel(args->gd, args->gh, args->gw), *args, device,
                                 stream);
}

extern "C" int gi_reference_ray_occupancy(int gd, int gh, int gw, int* registers,
                                          int* local_bytes, int* blocks_per_sm, int* threads,
                                          int* shared_bytes) {
  return occupancy<REF_BLOCK>(variant_kernel(gd, gh, gw), registers, local_bytes, blocks_per_sm,
                              threads, shared_bytes);
}
#else
extern "C" int gi_reference_ray_launch(const RefArgs* args, int device, void* stream) {
  return gi_reference_ray_launch_package(args, device, stream);
}

extern "C" int gi_reference_ray_occupancy(int gd, int gh, int gw, int* registers,
                                          int* local_bytes, int* blocks_per_sm, int* threads,
                                          int* shared_bytes) {
  return gi_reference_ray_occupancy_package(gd, gh, gw, registers, local_bytes, blocks_per_sm,
                                            threads, shared_bytes);
}
#endif
