// Tile binning for Hopper (sm_90a): per-tile triangle lists in pair order.
//
// Replaces the XLA binning of the JAX package,
// vulkan_pbr_renderer_tpu/raster/binning.py:104 bin_triangles (not a Pallas
// kernel: XLA runs it as scatters, cummax fills, a sort and gathers).  It
// computes raster/binning.py::bin_triangles_plain bit for bit: the segment
// starts of every tile, the pair rows ("slim13" or "wide16"), the
// hierarchical-z bound of every chunk (z_order), the longest segment and the
// true pair count.
//
// Why not the TPU's way.  The JAX package expands a triangle's run of pair
// rows with a scatter of its id at the run's start and a cummax forward fill,
// because XLA's gathers on the TPU are slow; the plain version keeps that
// fill and then gathers per row anyway.  On the card a row finds its triangle
// directly: the triangles' inclusive pair-count sums `ends` are sorted, so
// row p belongs to the first triangle t with ends[t] > p (a binary search).
// That balances the work (a thread per row, whatever a triangle's size) and
// replaces the scatter, the fill and the per-row gathers of the span.
//
// Launches (the wrapper raster/binning.py::bin_triangles calls them through
// _expand and _finish, in order on one stream with no host sync):
//  1. binning_setup_launch, a thread per triangle: the tile span of the
//     triangle's bbox within the band of rows [y_origin, y_origin + height),
//     its pair count ntx * nty, its first tile and, under z_order, its
//     quantized minimum vertex depth zq.  The wrapper scans the counts into
//     `ends` with torch.cumsum (JAX scans with jnp.cumsum outside any kernel).
//  2. binning_expand_launch, a thread per buffer row p < cap: the row's
//     triangle, its tile (first tile + (m / ntx) rows + m % ntx columns, m the
//     row's rank in its run) and the int64 sort key (tile << 32) | tri, or
//     (tile << 31) | (zq << tri_bits) | tri under z_order.  Dead rows
//     (p >= total) carry tile n_tiles and the triangle the cummax fill gives
//     them: the last triangle with a pair (tri 0 and zq = zq_max when there is
//     no pair), searched once by each block that holds a dead row.  An
//     overflowing buffer (total > cap) keeps its first cap rows.
//     The wrapper sorts the keys with torch.sort (jax.lax.sort's place).
//  3. binning_finish_launch: a thread per sorted row packs the pair row
//     straight from the setup fields (the dead constant past the live rows);
//     a thread per tile finds starts[t], the first row of tile >= t (a binary
//     search: searchsorted(side="left"), empty tiles included); one block
//     reduces the longest segment and writes the true pair count; a warp per
//     chunk takes the minimum zq of its rows and scales it once by
//     f32(1 / zq_max), which is the minimum of the scaled values because a
//     rounded product by a positive constant is monotone.
//
// What bounds it on the card: bytes.  Each setup field it reads is read once
// (adj, z_vert, c_z, bbox, z_mode, valid: 78 B per triangle) and the pair
// rows, starts and chunk_minz written once (52 or 64 B per row).  The int64
// keys are this file's own intermediate (written, sorted, read back) and are
// not part of that bound; neither is the sort, a library call outside this
// file.
//
// Exactness: the float work is the plain version's zq (two adds, a product
// and clamps), done with the _rn intrinsics, -fmad=false, and PyTorch's NaN
// rules for minimum and clamp, and float-to-int64 conversion that truncates
// (NaN to 0, as the card's conversion does in PyTorch).  Everything else
// copies bits or is integer arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.minimum and torch.clamp on the card: a NaN operand propagates.
__device__ __forceinline__ float torch_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

// First index t in [lo, hi) with ends[t] > p (hi when there is none).
__device__ __forceinline__ int upper_bound(const long long* ends, int lo, int hi, long long p) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (ends[mid] > p) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__global__ void setup_kernel(const int* __restrict__ bbox, const unsigned char* __restrict__ valid,
                             const float* __restrict__ z_vert,
                             const unsigned char* __restrict__ z_mode, int n, int tile_w,
                             int tile_h, int tiles_x, int tiles_y, int height, int y_origin,
                             int zq_max, int* __restrict__ counts, int4* __restrict__ info) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long x0 = bbox[4 * t], x1 = bbox[4 * t + 2];
  const long long by0 = (long long)bbox[4 * t + 1] - y_origin;
  const long long by1 = (long long)bbox[4 * t + 3] - y_origin;
  const bool live = valid[t] && by1 > 0 && by0 < height;
  const long long tx0 = clamp_ll(floor_div(x0, tile_w), 0, tiles_x - 1);
  const long long ty0 = clamp_ll(floor_div(by0, tile_h), 0, tiles_y - 1);
  const long long tx1 = clamp_ll(floor_div(x1 - 1, tile_w), 0, tiles_x - 1);
  const long long ty1 = clamp_ll(floor_div(by1 - 1, tile_h), 0, tiles_y - 1);
  const long long ntx = live ? tx1 - tx0 + 1 : 0;
  const long long nty = live ? ty1 - ty0 + 1 : 0;
  counts[t] = (int)(ntx * nty);
  int zq = 0;
  if (zq_max > 0) {   // z_order: binning.py::_min_vertex_depth_q
    const float z0 = z_vert[3 * t], d1 = z_vert[3 * t + 1], d2 = z_vert[3 * t + 2];
    float lo = torch_min(d1, torch_min(d2, __fadd_rn(d1, d2)));
    lo = (lo != lo) ? lo : fminf(lo, 0.0f);
    float minz = __fadd_rn(z0, lo);
    minz = z_mode[t] ? torch_clamp(minz, 0.0f, 1.0f) : 0.0f;
    const long long q = (long long)__fmul_rn(minz, (float)zq_max);
    zq = (int)(q < zq_max ? q : zq_max);
  }
  info[t] = make_int4((int)(ty0 * tiles_x + tx0), (int)ntx, zq, 0);
}

__global__ void expand_kernel(const long long* __restrict__ ends, const int4* __restrict__ info,
                              int n, long long cap, int tiles_x, int n_tiles, int z_order,
                              int tri_bits, int zq_max, long long* __restrict__ keys) {
  // the dead rows' triangle and zq: one search per block that holds a dead row
  __shared__ long long dead_tri;
  __shared__ long long dead_zq;
  const long long first = (long long)blockIdx.x * blockDim.x;
  const long long total = n > 0 ? ends[n - 1] : 0;
  if (threadIdx.x == 0 && first + blockDim.x > total) {
    dead_tri = total > 0 ? upper_bound(ends, 0, n - 1, total - 1) : 0;
    dead_zq = total > 0 ? info[dead_tri].z : zq_max;
  }
  __syncthreads();
  const long long p = first + threadIdx.x;
  if (p >= cap) return;
  long long tile = n_tiles, tri, zq;
  if (p < total) {
    tri = upper_bound(ends, 0, n - 1, p);
    const int4 in = info[tri];
    const long long m = p - (tri > 0 ? ends[tri - 1] : 0);
    const long long ntx = in.y > 1 ? in.y : 1;
    tile = (long long)in.x + (m / ntx) * tiles_x + m % ntx;
    zq = in.z;
  } else {   // a dead row: the last triangle with a pair
    tri = dead_tri;
    zq = dead_zq;
  }
  keys[p] = z_order ? (tile << 31) | (zq << tri_bits) | tri : (tile << 32) | tri;
}

__global__ void rows_kernel(const long long* __restrict__ skeys, const long long* __restrict__ ends,
                            int n, long long cap, long long tri_mask, int wide,
                            const float* __restrict__ adj, const float* __restrict__ z_vert,
                            const float* __restrict__ c_z, const unsigned char* __restrict__ z_mode,
                            const unsigned char* __restrict__ valid, const int* __restrict__ bbox,
                            float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cap) return;
  const long long total = n > 0 ? ends[n - 1] : 0;
  const int ncol = wide ? 16 : 13;
  float row[16];
  if (p < total) {
    const long long tri = skeys[p] & tri_mask;
    const float* a = adj + 9 * tri;
    if (valid[tri]) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int i = 0; i < 3; ++i) row[3 * j + i] = a[3 * i + j];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) row[k] = (k % 3 == 2) ? (k == 2 ? -1.0f : 1.0f) : 0.0f;
    }
    const bool zm = z_mode[tri];
    const float* z = (zm ? z_vert : c_z) + 3 * tri;
    row[9] = z[0];
    row[10] = z[1];
    row[11] = z[2];
    if (wide) {
      row[12] = (float)tri;
      row[13] = (float)bbox[4 * tri + 1];
      row[14] = (float)bbox[4 * tri + 3];
      row[15] = zm ? 1.0f : 0.0f;
    } else {
      row[12] = zm ? (float)(tri + 1) : -(float)(tri + 1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) row[k] = 0.0f;
    row[2] = -1.0f;
    row[12] = wide ? -1.0f : 0.0f;
  }
  float* dst = out + p * ncol;
  if (wide) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d4[k] = make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2], row[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 13; ++k) dst[k] = row[k];
  }
}

// starts[t] = the first sorted row whose tile is >= t, or cap.
__global__ void starts_kernel(const long long* __restrict__ skeys, long long cap, int shift,
                              int n_tiles, int* __restrict__ starts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  long long lo = 0, hi = cap;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if ((skeys[mid] >> shift) >= t) hi = mid; else lo = mid + 1;
  }
  starts[t] = (int)lo;
}

// One block: the longest segment starts[t+1] - starts[t], and the true pair
// count as int32.
__global__ void totals_kernel(const int* __restrict__ starts, int n_tiles,
                              const long long* __restrict__ ends, int n,
                              int* __restrict__ max_segment, int* __restrict__ total_pairs) {
  __shared__ int warp_max[32];
  int best = 0;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    best = max(best, starts[t + 1] - starts[t]);
  }
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) best = max(best, warp_max[w]);
    *max_segment = best;
    *total_pairs = (int)(n > 0 ? ends[n - 1] : 0);
  }
}

// A warp per chunk of `chunk` sorted rows: min zq, scaled once.
__global__ void chunk_minz_kernel(const long long* __restrict__ skeys, long long n_chunks,
                                  int chunk, int tri_bits, int zq_max, float inv_zq_max,
                                  float* __restrict__ chunk_minz) {
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;
  if (zq_max == 0) {
    if (lane == 0) chunk_minz[c] = 0.0f;
    return;
  }
  int best = zq_max;
  const long long* k = skeys + c * chunk;
  for (int r = lane; r < chunk; r += 32) best = min(best, (int)((k[r] >> tri_bits) & zq_max));
  for (int o = 16; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (lane == 0) chunk_minz[c] = __fmul_rn((float)best, inv_zq_max);
}

unsigned blocks_for(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

}  // namespace

// Step 1.  bbox i32 [n,4], valid / z_mode bool [n], z_vert f32 [n,3];
// zq_max 0 skips zq (z_order off).  Writes counts i32 [n] and info i32 [n,4]
// = (first tile, ntx, zq, 0).
extern "C" int binning_setup_launch(const int* bbox, const unsigned char* valid,
                                    const float* z_vert, const unsigned char* z_mode, int n,
                                    int tile_w, int tile_h, int tiles_x, int tiles_y, int height,
                                    int y_origin, int zq_max, int* counts, int* info,
                                    void* stream) {
  if (n > 0) {
    setup_kernel<<<blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        bbox, valid, z_vert, z_mode, n, tile_w, tile_h, tiles_x, tiles_y, height, y_origin, zq_max,
        counts, reinterpret_cast<int4*>(info));
  }
  return (int)cudaGetLastError();
}

// Step 2.  ends i64 [n] (inclusive sums of counts); writes keys i64 [cap].
extern "C" int binning_expand_launch(const long long* ends, const int* info, int n, long long cap,
                                     int tiles_x, int n_tiles, int z_order, int tri_bits,
                                     int zq_max, long long* keys, void* stream) {
  if (cap > 0) {
    expand_kernel<<<blocks_for(cap, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        ends, reinterpret_cast<const int4*>(info), n, cap, tiles_x, n_tiles, z_order, tri_bits,
        zq_max, keys);
  }
  return (int)cudaGetLastError();
}

// Step 3.  skeys i64 [cap] sorted; writes pair_data f32 [cap, 13|16],
// starts i32 [n_tiles+1], chunk_minz f32 [cap/chunk], max_segment and
// total_pairs (i32 scalars).  zq_max 0: chunk_minz is zeros.
extern "C" int binning_finish_launch(const long long* skeys, const long long* ends, int n,
                                     long long cap, int chunk, int n_tiles, int z_order,
                                     int tri_bits, int zq_max, int wide, const float* adj,
                                     const float* z_vert, const float* c_z,
                                     const unsigned char* z_mode, const unsigned char* valid,
                                     const int* bbox, float* pair_data, int* starts,
                                     float* chunk_minz, int* max_segment, int* total_pairs,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long tri_mask = z_order ? (1LL << tri_bits) - 1 : 0xFFFFFFFFLL;
  if (cap > 0) {
    rows_kernel<<<blocks_for(cap, kThreads), kThreads, 0, s>>>(
        skeys, ends, n, cap, tri_mask, wide, adj, z_vert, c_z, z_mode, valid, bbox, pair_data);
  }
  starts_kernel<<<blocks_for(n_tiles + 1, kThreads), kThreads, 0, s>>>(
      skeys, cap, z_order ? 31 : 32, n_tiles, starts);
  totals_kernel<<<1, 1024, 0, s>>>(starts, n_tiles, ends, n, max_segment, total_pairs);
  const long long n_chunks = cap / chunk;
  if (n_chunks > 0) {
    const float inv = zq_max > 0 ? (float)(1.0 / zq_max) : 0.0f;
    chunk_minz_kernel<<<blocks_for(n_chunks * 32, kThreads), kThreads, 0, s>>>(
        skeys, n_chunks, chunk, tri_bits, z_order ? zq_max : 0, inv, chunk_minz);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
