// The lightgrid sweep for Hopper (sm_90a): pass 3 of the frame and the u8
// table the fast GI reads, in one launch.
//
// Replaces no Pallas kernel: the JAX package sweeps with
// jax.lax.associative_scan in XLA (vulkan_pbr_renderer_tpu/shade/gi.py:42
// _sweep_linrec and :68 sweep_lightgrid), and the fast GI quantizes the
// swept grid into its u8 table with eager ops (shade/gi_modes.py's
// quantize_grid_u8 call, shade/gi.py:263 in the port).  The plain versions
// are shade/gi.py's sweep_lightgrid and quantize_grid_u8.
//
// What it computes.  The [D,H,W,4] f32 grid is cut into lines along the
// frame's axis (z, y or x).  Along each line of n voxels: the forward, then
// the backward linear recurrence L[i] = a[i] * L[i-1] + b[i] through the
// empty voxels (a = move_ratio, b = move_ratio * value; an occupied voxel
// has a = 0, b = its radiance), both with the original occupancy and
// radiance, each seeded with the skylight; the light that leaves the line
// is added to the last voxel processed; then 35% of the backward result is
// blended into the empty voxels.  Alpha passes through.  Beside the new
// grid it writes quantize_grid_u8's levels: rgb as sqrt(x / (1 + x)),
// alpha raw, each round(v * 255) half to even, clipped to 0..254.
//
// Exactness.  The plain version solves each recurrence with the recursion
// of jax.lax.associative_scan, and its rounding follows that tree: per
// level of the recursion (shade/gi.py sweep_schedule) a set of disjoint
// combines (a, b)[dst] = (a, b)[dst - s] . (a, b)[dst] at a stride s = 2^d,
// the up levels at d = 0, 1, ... then the down levels back.  Both kernels
// walk those combines in that order.  A combine is (a1 * a2, a2 * b1 + b2)
// as a rounded product and a rounded sum (no FMA; -fmad=false and the _rn
// intrinsics).  The products a1 * a2 of an empty line reach 0.5^128 =
// 2^-128, below f32's normal range, and then scale the skylight, so
// denormals are kept (no -ftz, no fast math).  The quantize is an IEEE
// divide, a correctly rounded sqrt and rintf.  Python numbers of the plain
// version are f32 multipliers on the card: move_ratio, (1 - move_ratio) /
// move_ratio and blend come as f32 from the wrapper.
//
// What bounds it.  It moves bytes: the grid read once (33.55 MB at 128^3)
// and written once, and the 8.39 MB table, ~0.0225 ms at 3.35 TB/s; its
// ~40 flops a voxel are far below the f32 peak.
//
// Two kernels, chosen by the line's length n:
//  * sweep_ring_kernel, for n = 16 K with K = 1, 2, 4, 8 or 16 (every axis
//    of the frame's 128^3 grid, K = 8).  Persistent blocks of 4 warps walk
//    groups of 8 lines (adjacent in x: for the z and y axes one step of a
//    group is one 128-byte line of device memory; an x line is itself W*16
//    contiguous bytes).  A ring of 2 stages in shared memory keeps the
//    next group's voxels arriving by cp.async (16 bytes a thread, L2
//    only) while the warps scan the current group, and its stores drain.  Each line lies in the registers of 16 lanes (two lines
//    a warp): lane l holds the K adjacent voxels l*K .. l*K + K - 1; a
//    combine whose two voxels lie in one lane is a register combine, one
//    across lanes takes the source lane's last voxel by __shfl_sync within
//    the line's 16 lanes (one float4 a level at most), so the scan needs
//    no shared memory and no __syncwarp.  The backward sweep runs the same
//    code with the lanes and slots mirrored.  The lanes then write their
//    line's new voxels over the old ones in the stage, and the block
//    stores the group as 16-byte lines of the grid and of the table (the
//    words of 4 neighbouring lanes gathered by shuffles).  The stage's
//    slots are XOR-swizzled so that the copies, a lane's reads of its
//    voxels and the stores meet no bank conflict.
//  * lightgrid_sweep_kernel, the replay kernel, for every other length
//    (odd grids, a 520-voxel line): a block of 8 warps loads its 8 lines
//    into padded shared memory, each warp replays the schedule's pairs
//    level by level over its line with a __syncwarp a level, and the block
//    writes the grid as 16-byte stores and the table as 16-byte lines of 4
//    voxels where 4 neighbours of the table are contiguous and aligned
//    (vec_table), else as a word a voxel.
// On the H100 (tile_sweep.py, PERF.md) at 128^3 the ring kernel takes
// about 0.040 ms against the replay kernel's 0.058 (at every length in
// the sweep-only sweep_variants.cu): with neither loads nor stores
// it still takes 0.034, so its instructions and their latency, not the
// bytes, set the pace; 32 lanes a line, 3 or 4 stages, a register bound
// of 8 blocks an SM, batched quantizes and a fast approximate quantize
// were no faster (sweep_variants.cu keeps them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

// the replay kernel's lines a block, a warp each
constexpr int kLines = 8;
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
__device__ __forceinline__ int slot(int i) { return i + (i >> 3); }
__host__ __device__ __forceinline__ int ab_pitch(int n) { return (n + (n >> 3)) | 1; }
__host__ __device__ __forceinline__ int old_pitch(int n) { return n | 1; }

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

__global__ void __launch_bounds__(kThreads) lightgrid_sweep_kernel(const SweepArgs a) {
  extern __shared__ float4 smem[];
  const int n = a.n;
  const int po = old_pitch(n), pab = ab_pitch(n);
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
  float4* const qold = old + q * po;
  float4* const qab = ab + q * pab;

  // load: the old voxels, and the forward scan's (b, a)
  if (q < nl) {
#pragma unroll 4
    for (int i = i0; i < n; i += di) {
      const float4 v = __ldg(a.grid + base + (size_t)i * stride);
      qold[i] = v;
      qab[slot(i)] = v.w > 0.5f ? make_float4(v.x, v.y, v.z, 0.0f)
                          : make_float4(__fmul_rn(a.mr, v.x), __fmul_rn(a.mr, v.y),
                                        __fmul_rn(a.mr, v.z), a.mr);
    }
  }
  __syncthreads();

  // each warp sweeps one line
  if (warp < nl) {
    float4* lab = ab + warp * pab;
    const float4* lold = old + warp * po;
    scan_line(lab, pairs, level_start, a.levels, n, false, lane);
    // the forward result, and from it the backward scan's (b, a)
    for (int i = lane; i < n; i += 32) {
      const float4 v = lold[i];
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
    scan_line(lab, pairs, level_start, a.levels, n, true, lane);
  }
  __syncthreads();

  // the new grid (16-byte stores) and the table's words
  if (q < nl) {
#pragma unroll 2
    for (int i = i0; i < n; i += di) {
      const float4 v = qold[i];
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
      const unsigned word = level(o.x, true) | level(o.y, true) << 8 |
                            level(o.z, true) << 16 | level(o.w, false) << 24;
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


// ---------------------------------------------------------------------------
// sweep_ring_kernel: a line in registers, groups of lines through a ring of
// stages.  The helpers take the lanes a line as L (the kernel's kLanes; the
// sweep-only sweep_variants.cu builds them at 32 too).

constexpr int kRingLines = 8;                       // lines a group
constexpr int kLanes = 16;                          // lanes a line: two lines a warp
constexpr int kRingThreads = kLanes * kRingLines;   // 4 warps
constexpr int kStages = 2;                          // the ring's stages
// chunks a thread stores at once (ptxas keeps the batch's form free of
// local memory at K = 8 where a plain loop body spills 8 bytes)
constexpr int kStoreBatch = 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int log2_of(int k) { return k <= 1 ? 0 : 1 + log2_of(k / 2); }

// A stage holds a group's 8 lines of N = L * K voxels: [line][step] along
// x, [step][line] across (as device memory has them), the low 3 bits of
// the fast index XORed with bits of the step so that the 8 lanes of a
// quarter warp reading their voxels l*K + j hit 8 distinct 16-byte bank
// groups (and the copies and stores, 8 neighbours of memory, too).
template <int L, int K>
__device__ __forceinline__ int ring_slot(int q, int i, bool along) {
  constexpr int N = L * K, LK = log2_of(K);
  if (along) return q * N + (K >= 2 ? (i ^ ((i >> LK) & 7)) : i);
  return i * kRingLines + (q ^ ((i >> LK) & 7));
}

// chunk c of a group: (line q, step i), neighbouring threads on
// neighbouring 16-byte chunks of device memory
__device__ __forceinline__ void ring_chunk(int c, int n, bool along, int& q, int& i) {
  if (along) {
    q = c / n;
    i = c % n;
  } else {
    q = c % kRingLines;
    i = c / kRingLines;
  }
}

// The first voxel of a thread's chunk's line: across (z, y) a thread's
// chunks all lie on line line0 + threadIdx.x % 8, whose start `own` the
// caller takes once a group (a division); along x line l starts at l * n.
__device__ __forceinline__ size_t ring_base(const SweepArgs& a, int line0, int q, size_t own) {
  return a.along ? (size_t)(line0 + q) * a.n : own;
}

// the voxels of lines line0 .. line0 + nl - 1 into a stage, by cp.async
template <int L, int K>
__device__ __forceinline__ void ring_load(const SweepArgs& a, float4* stage, int line0, int nl) {
  constexpr int N = L * K;
  const size_t own = a.along ? 0 : line_base(a, line0 + threadIdx.x % kRingLines);
  for (int c = threadIdx.x; c < kRingLines * N; c += L * kRingLines) {
    int q, i;
    ring_chunk(c, N, a.along, q, i);
    if (q < nl)
      cp_async16(stage + ring_slot<L, K>(q, i, a.along),
                 a.grid + ring_base(a, line0, q, own) + (size_t)i * a.stride);
  }
}

// a float4 from the lane `delta` before (R: after) in the line's L lanes
template <int L, bool R>
__device__ __forceinline__ float4 shfl4(const float4 v, int delta) {
  if (R)
    return make_float4(__shfl_down_sync(0xFFFFFFFFu, v.x, delta, L),
                       __shfl_down_sync(0xFFFFFFFFu, v.y, delta, L),
                       __shfl_down_sync(0xFFFFFFFFu, v.z, delta, L),
                       __shfl_down_sync(0xFFFFFFFFu, v.w, delta, L));
  return make_float4(__shfl_up_sync(0xFFFFFFFFu, v.x, delta, L),
                     __shfl_up_sync(0xFFFFFFFFu, v.y, delta, L),
                     __shfl_up_sync(0xFFFFFFFFu, v.z, delta, L),
                     __shfl_up_sync(0xFFFFFFFFu, v.w, delta, L));
}

// One level of the scan over a line in registers.  In scan order (mirrored
// for the backward sweep: R) the line's lane Lk holds positions Lk*K + J,
// J = 0..K-1, in its slots x[R ? K-1-J : J].  The level at depth d (stride
// s = 2^d) writes position P from P - s where
//   up:   (P + 1) % 2s == 0,
//   down: (P + 1) % 2s == s and P + 1 > s,
// sweep_schedule's pairs for a length of L * K.  For s >= K only scan
// slot K-1 is written, from slot K-1 of the lane s/K before; for s < K the
// slots written are fixed (the lane drops out of (P + 1) % 2s), and a
// source lies in the same lane but at a down level's slot s-1, which reads
// slot K-1 of the lane before.
template <int L, int K, bool R, bool Up, int d>
__device__ __forceinline__ void scan_level(float4 (&x)[K], int Lk) {
  constexpr int s = 1 << d;
  constexpr int last = R ? 0 : K - 1;
  float4 nb = x[last];
  if (s >= K || !Up) nb = shfl4<L, R>(x[last], s >= K ? s / K : 1);
#pragma unroll
  for (int J = (s >= K ? K - 1 : 0); J < K; ++J) {
    const int p1 = Lk * K + J + 1;
    const bool dst = Up ? (p1 & (2 * s - 1)) == 0 : ((p1 & (2 * s - 1)) == s && p1 > s);
    if (dst) {
      const int js = J >= s ? J - s : 0;
      float4& y = x[R ? K - 1 - J : J];
      y = combine(J >= s ? x[R ? K - 1 - js : js] : nb, y);
    }
  }
}

template <int L, int K, bool R, int... d>
__device__ __forceinline__ void scan_up(float4 (&x)[K], int Lk, std::integer_sequence<int, d...>) {
  (scan_level<L, K, R, true, d>(x, Lk), ...);
}

template <int L, int K, bool R, int... d>
__device__ __forceinline__ void scan_down(float4 (&x)[K], int Lk,
                                          std::integer_sequence<int, d...>) {
  constexpr int top = log2_of(L * K) - 2;   // the deepest down level
  (scan_level<L, K, R, false, top - d>(x, Lk), ...);
}

// one recurrence over a line of L * K voxels: the up levels d = 0 ..
// log2(n) - 1, then the down levels back from log2(n) - 2 to 0
template <int L, int K, bool R>
__device__ __forceinline__ void scan_regs(float4 (&x)[K], int lk) {
  constexpr int levels = log2_of(L * K);
  const int Lk = R ? L - 1 - lk : lk;
  scan_up<L, K, R>(x, Lk, std::make_integer_sequence<int, levels>{});
  scan_down<L, K, R>(x, Lk, std::make_integer_sequence<int, levels - 1>{});
}

// The sweep of line q of the stage by its L lanes (lk: the lane's index
// among them) in three steps around its two scans: the forward scan's (b,
// a) from the stage's voxels; the forward result, and from it the backward
// scan's (b, a); the new voxels, written over the old ones in the stage.
// Each step reads the old voxels from the stage again (the registers hold
// the scan's (B, A) alone).
template <int L, int K>
__device__ __forceinline__ void ring_forward_inputs(const SweepArgs& a, const float4* st, int q,
                                                    int lk, float4 (&x)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float4 v = st[ring_slot<L, K>(q, lk * K + j, a.along)];
    x[j] = v.w > 0.5f ? make_float4(v.x, v.y, v.z, 0.0f)
                      : make_float4(__fmul_rn(a.mr, v.x), __fmul_rn(a.mr, v.y),
                                    __fmul_rn(a.mr, v.z), a.mr);
  }
}

template <int L, int K>
__device__ __forceinline__ void ring_backward_inputs(const SweepArgs& a, const float4* st, int q,
                                                     int lk, float4 (&x)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float4 v = st[ring_slot<L, K>(q, lk * K + j, a.along)];
    const float3 Lt = light(x[j], a.sky);
    if (v.w > 0.5f) {
      x[j] = make_float4(v.x, v.y, v.z, 0.0f);
    } else {
      float3 f = make_float3(__fmul_rn(a.keep, Lt.x), __fmul_rn(a.keep, Lt.y),
                             __fmul_rn(a.keep, Lt.z));
      if (lk * K + j == L * K - 1)
        f = make_float3(__fadd_rn(f.x, Lt.x), __fadd_rn(f.y, Lt.y), __fadd_rn(f.z, Lt.z));
      x[j] = make_float4(__fmul_rn(a.mr, f.x), __fmul_rn(a.mr, f.y), __fmul_rn(a.mr, f.z),
                         a.mr);
    }
  }
}

template <int L, int K>
__device__ __forceinline__ void ring_blend(const SweepArgs& a, float4* st, int q, int lk,
                                           const float4 (&x)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float4* const at = st + ring_slot<L, K>(q, lk * K + j, a.along);
    float4 o = *at;
    if (o.w <= 0.5f) {
      const float3 Lt = light(x[j], a.sky);
      float3 b = make_float3(__fmul_rn(a.keep, Lt.x), __fmul_rn(a.keep, Lt.y),
                             __fmul_rn(a.keep, Lt.z));
      if (lk * K + j == 0)
        b = make_float3(__fadd_rn(b.x, Lt.x), __fadd_rn(b.y, Lt.y), __fadd_rn(b.z, Lt.z));
      o.x = __fadd_rn(o.x, __fmul_rn(__fsub_rn(b.x, o.x), a.blend));
      o.y = __fadd_rn(o.y, __fmul_rn(__fsub_rn(b.y, o.y), a.blend));
      o.z = __fadd_rn(o.z, __fmul_rn(__fsub_rn(b.z, o.z), a.blend));
    }
    *at = o;
  }
}

template <int L, int K>
__device__ __forceinline__ void ring_line(const SweepArgs& a, float4* st, int q, int lk) {
  float4 x[K];
  ring_forward_inputs<L, K>(a, st, q, lk, x);
  scan_regs<L, K, false>(x, lk);
  ring_backward_inputs<L, K>(a, st, q, lk, x);
  scan_regs<L, K, true>(x, lk);
  ring_blend<L, K>(a, st, q, lk, x);
}

// quantize_grid_u8's word of a voxel
__device__ __forceinline__ unsigned table_word(const float4 o) {
  return level(o.x, true) | level(o.y, true) << 8 | level(o.z, true) << 16 |
         level(o.w, false) << 24;
}

// A stage's new voxels to the grid (16-byte stores, neighbouring lanes on
// neighbouring voxels) and their table words: where the plan's vec_table
// holds, the words of 4 neighbouring lanes (adjacent lines across,
// adjacent steps along: 4 neighbours in the table) go out as one 16-byte
// store of the first lane, where all 4 lines are live; else a word a
// voxel.  A thread's chunks go kStoreBatch at a time: their reads, their
// quantizes, then their stores.
template <int L, int K>
__device__ __forceinline__ void ring_store(const SweepArgs& a, const float4* st, int line0,
                                           int nl) {
  constexpr int N = L * K, T = L * kRingLines;
  const int lane = threadIdx.x & 31;
  const size_t own = a.along ? 0 : line_base(a, line0 + threadIdx.x % kRingLines);
#pragma unroll 1
  for (int c0 = threadIdx.x; c0 < kRingLines * N; c0 += kStoreBatch * T) {
    int q[kStoreBatch], i[kStoreBatch];
    float4 o[kStoreBatch];
    unsigned word[kStoreBatch];
#pragma unroll
    for (int u = 0; u < kStoreBatch; ++u) {
      ring_chunk(c0 + u * T, N, a.along, q[u], i[u]);
      o[u] = q[u] < nl ? st[ring_slot<L, K>(q[u], i[u], a.along)]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kStoreBatch; ++u) word[u] = table_word(o[u]);
#pragma unroll
    for (int u = 0; u < kStoreBatch; ++u) {
      const bool live = q[u] < nl;
      const size_t g = ring_base(a, line0, q[u], own) + (size_t)i[u] * a.stride;
      if (live) a.out[g] = o[u];
      const unsigned w1 = __shfl_down_sync(0xFFFFFFFFu, word[u], 1);
      const unsigned w2 = __shfl_down_sync(0xFFFFFFFFu, word[u], 2);
      const unsigned w3 = __shfl_down_sync(0xFFFFFFFFu, word[u], 3);
      const bool whole = a.vec_table && (a.along ? live : (q[u] | 3) < nl);
      if (whole) {
        if ((lane & 3) == 0)
          *reinterpret_cast<uint4*>(a.table + g) = make_uint4(word[u], w1, w2, w3);
      } else if (live) {
        a.table[g] = word[u];
      }
    }
  }
}

// Group k of a block is group blockIdx.x + k * gridDim.x, in stage k %
// kStages.  Iteration k: wait for its own copies of group k and meet the
// block (every copy of group k landed; every store read of group k - 1
// done), start the copies of group k + 1 into group k - 1's stage, sweep
// group k (line q by the kLanes threads from q * kLanes), meet, store
// group k.
template <int K>
__global__ void __launch_bounds__(kRingThreads) sweep_ring_kernel(const SweepArgs a) {
  constexpr int kStage = kRingLines * kLanes * K;   // float4 a stage
  extern __shared__ float4 ring[];
  const int q = threadIdx.x / kLanes, lk = threadIdx.x % kLanes;
  const int warp_first = (threadIdx.x & ~31) / kLanes;   // the warp's first line
  const int groups = (a.lines + kRingLines - 1) / kRingLines;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int g = blockIdx.x + s * gridDim.x;
    if (g < groups)
      ring_load<kLanes, K>(a, ring + s * kStage, g * kRingLines,
                           min(kRingLines, a.lines - g * kRingLines));
    cp_async_commit();
  }
  int k = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, ++k) {
    float4* const cur = ring + (k % kStages) * kStage;
    const int line0 = g * kRingLines, nl = min(kRingLines, a.lines - line0);
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int gn = g + (kStages - 1) * gridDim.x;
    if (gn < groups)
      ring_load<kLanes, K>(a, ring + ((k + kStages - 1) % kStages) * kStage, gn * kRingLines,
                           min(kRingLines, a.lines - gn * kRingLines));
    cp_async_commit();
    // a warp whose lines are all past the group's end skips them (its
    // shuffles need every lane of the warp)
    if (warp_first < nl) ring_line<kLanes, K>(a, cur, q, lk);
    __syncthreads();
    ring_store<kLanes, K>(a, cur, line0, nl);
  }
  cp_async_wait<0>();
}

// the ring kernel's voxels a lane for a length (0: the replay kernel's)
__host__ __device__ constexpr int ring_k(int n) {
  return n % kLanes || n / kLanes > 16 || (n / kLanes & (n / kLanes - 1)) ? 0 : n / kLanes;
}

__host__ __device__ constexpr int ring_shared_bytes(int k) {
  return kStages * kRingLines * kLanes * k * 16;
}

// a kernel's occupancy query (registers, local memory, resident blocks at
// `smem` dynamic shared bytes of `threads`), its attribute set first
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int* registers, int* local_bytes,
                      int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
}

// The blocks of a persistent kernel resident at once on `device` (its SMs
// times the blocks an SM keeps), queried at the first call and kept in
// *cached.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int device, int* cached) {
  if (*cached) return cudaSuccess;
  int sms = 0, per_sm = 0, regs = 0, local = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = occupancy(kernel, threads, smem, &regs, &local, &per_sm);
  if (err == cudaSuccess) *cached = sms * max(per_sm, 1);
  return err;
}

// The ring kernel on `stream`: a persistent grid of as many blocks as are
// resident at once on the card, at most one a group.
template <int K>
cudaError_t ring_launch(const SweepArgs& a, int device, cudaStream_t stream) {
  static int resident[64];   // blocks of the kernel resident at once, per device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = ring_shared_bytes(K);
  const cudaError_t err = resident_blocks(sweep_ring_kernel<K>, kRingThreads, smem, device,
                                          &resident[device]);
  if (err != cudaSuccess) return err;
  const int groups = (a.lines + kRingLines - 1) / kRingLines;
  sweep_ring_kernel<K><<<min(groups, resident[device]), kRingThreads, smem, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

extern "C" int sweep_shared_bytes(int n, int n_pairs, int levels) {
  if (ring_k(n)) return ring_shared_bytes(ring_k(n));
  return (int)(kLines * (size_t)(old_pitch(n) + ab_pitch(n)) * sizeof(float4) +
               (size_t)n_pairs * 4 + (size_t)(levels + 1) * 4);
}

// One sweep on `stream`: the ring kernel for lengths of 32, 64, 128 and
// 256 voxels, the replay kernel for the others.  Returns the first CUDA
// error (0 = launched).
extern "C" int sweep_launch(const SweepArgs* args, int device, void* stream) {
  const SweepArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && a.lines > 0 && a.n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (ring_k(a.n)) {
      case 1: err = ring_launch<1>(a, device, s); break;
      case 2: err = ring_launch<2>(a, device, s); break;
      case 4: err = ring_launch<4>(a, device, s); break;
      case 8: err = ring_launch<8>(a, device, s); break;
      case 16: err = ring_launch<16>(a, device, s); break;
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

// The kernel a length of n voxels takes on the current card: registers and
// local memory a thread, the blocks an SM keeps resident at `smem` dynamic
// shared bytes a block, the lines a block sweeps at once, its threads, and
// the voxels a lane holds (the ring kernel's K; 0: the replay kernel).
extern "C" int sweep_occupancy(int n, int smem, int* registers, int* local_bytes,
                               int* blocks_per_sm, int* lines_per_block, int* threads,
                               int* lane_voxels) {
  cudaError_t err;
  const int k = ring_k(n);
  *lane_voxels = k;
  *lines_per_block = k ? kRingLines : kLines;
  *threads = k ? kRingThreads : kThreads;
  switch (k) {
    case 1: err = occupancy(sweep_ring_kernel<1>, kRingThreads, smem, registers, local_bytes,
                            blocks_per_sm); break;
    case 2: err = occupancy(sweep_ring_kernel<2>, kRingThreads, smem, registers, local_bytes,
                            blocks_per_sm); break;
    case 4: err = occupancy(sweep_ring_kernel<4>, kRingThreads, smem, registers, local_bytes,
                            blocks_per_sm); break;
    case 8: err = occupancy(sweep_ring_kernel<8>, kRingThreads, smem, registers, local_bytes,
                            blocks_per_sm); break;
    case 16: err = occupancy(sweep_ring_kernel<16>, kRingThreads, smem, registers, local_bytes,
                             blocks_per_sm); break;
    default: err = occupancy(lightgrid_sweep_kernel, kThreads, smem, registers, local_bytes,
                             blocks_per_sm);
  }
  return (int)err;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
