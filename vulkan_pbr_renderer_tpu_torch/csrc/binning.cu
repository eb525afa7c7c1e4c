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
// because XLA's gathers on the TPU are slow, and then sorts every row of the
// pair buffer by (tile, triangle).  On the card a row finds its triangle
// directly: the triangles' inclusive pair-count sums `ends` are sorted, so
// row p belongs to the first triangle t with ends[t] > p (a binary search).
// And only the live rows p < L = min(total, cap) are sorted, by a counting
// sort on the tile: a histogram, its scan (which is `starts`), a scatter, and
// a sort of each tile's short run by its 32-bit in-tile key.
//
// Launches (the wrapper raster/binning.py::bin_triangles calls them through
// _launch, in order on one stream with no host sync):
//  1. binning_setup_launch, a thread per triangle: the tile span of the
//     triangle's bbox within the band of rows [y_origin, y_origin + height),
//     its pair count ntx * nty, its first tile and, under z_order, its
//     quantized minimum vertex depth zq.  The wrapper scans the counts into
//     `ends` with torch.cumsum (JAX scans with jnp.cumsum outside any kernel).
//  2. binning_sort_launch, each stage selected by a bit of `stages`:
//     count    a memset of the per-tile histogram, then a thread per live row:
//              its triangle, its tile (first tile + (m / ntx) rows + m % ntx
//              columns, m the row's rank in its run) and its in-tile key, tri
//              or (zq << tri_bits) | tri under z_order.  A warp's rows that
//              share a tile add to the histogram once (__match_any_sync), and
//              each row keeps (tile, its slot in the tile, key).  The row
//              p = L - 1 leaves its zq for the dead rows.
//     scan     one block over the histogram: starts (exclusive sums, starts[T]
//              = L), the longest segment, the true pair count and the list of
//              the tiles whose runs are longer than sort_keys, for any T.
//     scatter  a thread per live row: its key to starts[tile] + slot.  The
//              slots come from atomics, so a tile's keys arrive in no fixed
//              order; each (tile, triangle) pair occurs once, so the keys of a
//              tile are distinct and the sort gives one order, the int64
//              sort's.
//     sort     the short sort, a block per tile with 2 to sort_keys keys:
//              bitonic in shared memory; then the long sort, 1024-thread
//              blocks over the list of longer runs: a stable LSD radix sort in
//              shared memory (4 bits a pass, as many passes as the keys have
//              bits, keys ranked within a warp by ballots), and for a
//              run longer than radix_keys pieces of that length merged by the
//              same block (each key's place is its index in its piece plus
//              the keys below it in the other pieces, each searched in shared
//              memory), right at any length.  Both write the sorted keys back
//              in place.  A block per
//              tile packing its own rows would leave the card waiting on the
//              deepest tiles (thousands of rows in one block), so the rows
//              are the next stage's.
//     pack     a thread per buffer row: a live row packed straight from the
//              setup fields of its sorted key's triangle, a dead row [L, cap)
//              as the dead constant, staged in shared memory and stored as
//              whole float4 lines; under z_order chunk_minz, the minimum zq of
//              each chunk's rows scaled once by f32(1 / zq_max) (the minimum
//              of the scaled values, as a rounded product by a positive
//              constant is monotone), by a segmented warp minimum and an
//              atomic min per chunk; zeros without z_order.  Dead rows carry
//              the triangle the cummax fill gives them (the last triangle with
//              a pair, zq_max when there is no pair); only its zq shows, in
//              chunk_minz.
//     An overflowing buffer (total > cap) keeps its first cap rows: L = cap,
//     and a triangle's run may be cut part way through a tile row.
//
// What bounds it on the card: bytes.  Each setup field it reads is read once
// (adj, z_vert, c_z, bbox, z_mode, valid: 78 B per triangle) and the pair
// rows, starts and chunk_minz written once (52 or 64 B per row, dead rows
// included).  The per-row (tile, slot, key) and the keys are this file's own
// intermediates (16 + 4 B per live row, written and read once each).
//
// Exactness: the float work is the plain version's zq (two adds, a product
// and clamps), done with the _rn intrinsics, -fmad=false, and PyTorch's NaN
// rules for minimum and clamp, and float-to-int64 conversion that truncates
// (NaN to 0, as the card's conversion does in PyTorch).  Everything else
// copies bits or is integer arithmetic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;       // every kernel but the scan and the long sort
constexpr int kScanThreads = 1024;
constexpr int kLongThreads = 1024;
constexpr int kCountBlocksPerSm = 8;
constexpr unsigned kSentinel = 0xFFFFFFFFu;   // above every key (< 2^31)
// the long sort's radix, 4 bits a pass, and its blocks per SM (two of 1024
// threads, each with two buffers of at most 12,288 keys: 96 KB)
constexpr int kRadixBits = 4, kDigits = 1 << kRadixBits, kLongBlocksPerSm = 2;
constexpr int kCntStride = kDigits + 1;   // a warp's digit counters, padded

enum Stage { kCount = 1, kScan = 2, kScatter = 4, kShortSort = 8, kLongSort = 16, kPack = 32 };

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

__device__ __forceinline__ long long live_rows(const long long* ends, int n, long long cap) {
  const long long total = n > 0 ? ends[n - 1] : 0;
  return total < cap ? total : cap;
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

// A thread per live row (a grid-stride loop that a warp walks together):
// rows[p] = (tile, slot within the tile, key); hist[tile] counts the rows.
__global__ void count_kernel(const long long* __restrict__ ends, const int4* __restrict__ info,
                             int n, long long cap, int tiles_x, int z_order, int tri_bits,
                             int* __restrict__ hist, int4* __restrict__ rows,
                             int* __restrict__ dead_zq) {
  const long long live = live_rows(ends, n, cap);
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < live;
       base += stride) {
    const long long p = base + lane;
    int tile = -1, key = 0;
    if (p < live) {
      const int tri = upper_bound(ends, 0, n - 1, p);
      const int4 in = info[tri];
      const long long m = p - (tri > 0 ? ends[tri - 1] : 0);
      const long long ntx = in.y > 1 ? in.y : 1;
      tile = in.x + (int)(m / ntx) * tiles_x + (int)(m % ntx);
      key = z_order ? (in.z << tri_bits) | tri : tri;
      if (p == live - 1) *dead_zq = in.z;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, tile);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (lane == leader && tile >= 0) first = atomicAdd(hist + tile, __popc(peers));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (tile >= 0) rows[p] = make_int4(tile, first + __popc(peers & ((1u << lane) - 1u)), key, 0);
  }
}

// Exclusive sum of v over the block (blockDim.x a multiple of 32); *total
// gets the block's sum.  warp_sums holds 32 ints.  Every thread calls it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return excl;
}

// One block: starts = exclusive sums of hist (starts[n_tiles] = L), the
// longest segment, the true pair count as int32, and the list of the tiles
// whose runs are longer than sort_keys (the long sort's work) with its
// length.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const int* __restrict__ hist, int n_tiles,
                            const long long* __restrict__ ends, int n, int sort_keys,
                            int* __restrict__ starts, int* __restrict__ max_segment,
                            int* __restrict__ total_pairs, int* __restrict__ long_tiles,
                            int* __restrict__ n_long) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int carry = 0, carry_long = 0, best = 0;
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int v = t < n_tiles ? hist[t] : 0;
    best = max(best, v);
    int sum, sum_long;
    const int excl = block_exclusive_sum(v, warp_sums, &sum);
    const int excl_long = block_exclusive_sum(v > sort_keys, warp_sums, &sum_long);
    if (t < n_tiles) {
      starts[t] = carry + excl;
      if (v > sort_keys) long_tiles[carry_long + excl_long] = t;
    }
    carry += sum;
    carry_long += sum_long;
  }
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (lane == 0) warp_sums[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < n_warps; ++w) best = max(best, warp_sums[w]);
    starts[n_tiles] = carry;
    *max_segment = best;
    *total_pairs = (int)(n > 0 ? ends[n - 1] : 0);
    *n_long = carry_long;
  }
}

__global__ void scatter_kernel(const long long* __restrict__ ends, int n, long long cap,
                               const int4* __restrict__ rows, const int* __restrict__ starts,
                               unsigned* __restrict__ keys) {
  const long long live = live_rows(ends, n, cap);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < live; p += stride) {
    const int4 r = rows[p];
    keys[starts[r.x] + r.y] = (unsigned)r.z;
  }
}

// Bitonic sort of s[0, n2) ascending, n2 a power of two; the block's threads
// share the work.  Starts and ends with the block in step.
__device__ void bitonic_sort(unsigned* s, int n2) {
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n2 >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const unsigned a = s[lo], b = s[hi];
        if ((a > b) == ((lo & k) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// A block per tile whose run holds 2 to sort_keys keys: the run sorted in
// shared memory and written back in place.
__global__ void sort_short_kernel(const int* __restrict__ starts, unsigned* __restrict__ keys,
                                  int sort_keys) {
  extern __shared__ unsigned s_short[];
  const int t = blockIdx.x;
  const int s0 = starts[t];
  const int m = starts[t + 1] - s0;
  if (m < 2 || m > sort_keys) return;
  int n2 = 1;
  while (n2 < m) n2 <<= 1;
  unsigned* seg = keys + s0;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) s_short[i] = i < m ? seg[i] : kSentinel;
  bitonic_sort(s_short, n2);
  for (int i = threadIdx.x; i < m; i += blockDim.x) seg[i] = s_short[i];
}

// The lanes of the warp whose digit equals this lane's (valid lanes only):
// one ballot per digit bit, cheaper than __match_any_sync when every warp
// of the SM ranks at once.
__device__ __forceinline__ unsigned same_digit_lanes(unsigned d, bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Stable LSD radix sort of s[0, len) by the low key_bits bits, kRadixBits a
// pass, through s2 (len keys).  Each warp owns a contiguous stretch of the
// keys and walks it 32 at a time; same_digit_lanes ranks the keys of one
// digit within a step, and cnt counts each warp's keys per digit (warp w's
// digit d at w * kCntStride + d: a warp's counters in distinct banks), so
// their exclusive sum taken digit-major orders the keys by (digit, warp,
// step, lane): stable.  Starts and ends with the block in step; the sorted
// keys are in s.
__device__ void radix_sort_shared(unsigned* s, unsigned* s2, int len, int key_bits, int* cnt,
                                  int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int per_warp = ((len + n_warps - 1) / n_warps + 31) & ~31;
  const int w0 = warp * per_warp, w1 = min(w0 + per_warp, len);
  const unsigned below = (1u << lane) - 1u;
  unsigned* src = s;
  unsigned* dst = s2;
  __syncthreads();
  for (int shift = 0; shift < key_bits; shift += kRadixBits) {
    int* my_cnt = cnt + warp * kCntStride;
    if (lane < kDigits) my_cnt[lane] = 0;
    __syncwarp();
    for (int b = w0; b < w1; b += 32) {
      const int i = b + lane;
      const bool valid = i < w1;
      const unsigned d = valid ? (src[i] >> shift) & (kDigits - 1) : 0u;
      const unsigned peers = same_digit_lanes(d, valid);
      if (valid && (peers & below) == 0) my_cnt[d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    const bool mine = threadIdx.x < kDigits * n_warps;   // digit-major: (d, w)
    int* at = cnt + (threadIdx.x % n_warps) * kCntStride + threadIdx.x / n_warps;
    int total;
    const int first = block_exclusive_sum(mine ? *at : 0, warp_sums, &total);
    if (mine) *at = first;
    __syncthreads();
    for (int b = w0; b < w1; b += 32) {
      const int i = b + lane;
      const bool valid = i < w1;
      const unsigned key = valid ? src[i] : 0u;
      const unsigned d = (key >> shift) & (kDigits - 1);
      const unsigned peers = same_digit_lanes(d, valid);
      const int base = valid ? my_cnt[d] : 0;
      __syncwarp();
      if (valid) {
        dst[base + __popc(peers & below)] = key;
        if ((peers & below) == 0) my_cnt[d] = base + __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    unsigned* t = src;
    src = dst;
    dst = t;
  }
  if (src != s) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) s[i] = src[i];
  }
  __syncthreads();
}

// The number of keys of a[0, na) below key (a sorted).
__device__ __forceinline__ int count_below(const unsigned* a, int na, unsigned key) {
  int lo = 0, hi = na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The long sort: the tiles of the list, each by one block of kLongThreads.
// A run of at most radix_keys keys is radix-sorted in shared memory; a
// longer one in pieces of radix_keys there, written back in place, and then
// merged, right at any length: a key's place is its index in its piece plus
// the keys below it in every other piece (the keys of a tile are distinct),
// counted by binary searches in each piece in turn, held in shared memory,
// and summed in `place`; the keys go to tmp at their places and back.  The
// sorted run ends in place.
__global__ void __launch_bounds__(kLongThreads, kLongBlocksPerSm) sort_long_kernel(
    const int* __restrict__ starts, const int* __restrict__ long_tiles,
    const int* __restrict__ n_long, unsigned* keys, unsigned* tmp, int* place_buf,
    int radix_keys, int key_bits) {
  extern __shared__ unsigned s_long[];
  __shared__ int warp_sums[32];
  __shared__ int cnt[kCntStride * 32];
  for (int i = blockIdx.x; i < *n_long; i += gridDim.x) {
    const int t = long_tiles[i];
    const int s0 = starts[t];
    const int m = starts[t + 1] - s0;
    unsigned* seg = keys + s0;
    for (int r0 = 0; r0 < m; r0 += radix_keys) {
      const int len = min(m - r0, radix_keys);
      for (int j = threadIdx.x; j < len; j += blockDim.x) s_long[j] = seg[r0 + j];
      radix_sort_shared(s_long, s_long + radix_keys, len, key_bits, cnt, warp_sums);
      for (int j = threadIdx.x; j < len; j += blockDim.x) seg[r0 + j] = s_long[j];
      __syncthreads();
    }
    if (m <= radix_keys) continue;
    int* place = place_buf + s0;
    for (int j = threadIdx.x; j < m; j += blockDim.x) place[j] = j % radix_keys;
    for (int q0 = 0; q0 < m; q0 += radix_keys) {
      const int len = min(m - q0, radix_keys);
      for (int j = threadIdx.x; j < len; j += blockDim.x) s_long[j] = seg[q0 + j];
      __syncthreads();
      for (int j = threadIdx.x; j < m; j += blockDim.x) {
        if (j < q0 || j >= q0 + len) place[j] += count_below(s_long, len, seg[j]);
      }
      __syncthreads();
    }
    unsigned* out = tmp + s0;
    for (int j = threadIdx.x; j < m; j += blockDim.x) out[place[j]] = seg[j];
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) seg[j] = out[j];
    __syncthreads();
  }
}

// Stores the floats [g0, g0 + len) of out from stage, which holds the float
// of out's index (g0 & ~3) + i at stage[i]: aligned float4s inside, single
// floats at the two ends.
__device__ __forceinline__ void store_lines(float* __restrict__ out, long long g0, long long len,
                                            const float* stage) {
  const long long a = g0 & ~3LL, end = g0 + len;
  const long long n4 = (end - a + 3) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(stage);
  for (long long q = threadIdx.x; q < n4; q += blockDim.x) {
    const long long g = a + 4 * q;
    if (g >= g0 && g + 4 <= end) {
      reinterpret_cast<float4*>(out)[g >> 2] = s4[q];
    } else {
      for (int k = 0; k < 4; ++k) {
        if (g + k >= g0 && g + k < end) out[g + k] = stage[4 * q + k];
      }
    }
  }
}

// A thread per buffer row, kThreads rows a block: the live row p < L packed
// straight from the setup fields of its sorted key's triangle, the dead row
// (0, 0, -1, 0...; col 12 0 in slim13, -1 in wide16) past them, staged in
// shared memory and the block's rows stored as whole lines.  Under z_order each warp also
// takes the minimum zq of its rows per chunk (a dead row's is the dead rows'
// zq) and lowers chunk_minz to it, scaled once by f32(1 / zq_max), with an
// atomic min on the bits (non-negative floats order as their bits do;
// chunk_minz starts above every value).
__global__ void pack_kernel(const long long* __restrict__ ends, int n, long long cap, int chunk,
                            int z_order, int tri_bits, unsigned tri_mask, int zq_max,
                            float inv_zq_max, int wide, const unsigned* __restrict__ keys,
                            const int* __restrict__ dead_zq, const float* __restrict__ adj,
                            const float* __restrict__ z_vert, const float* __restrict__ c_z,
                            const unsigned char* __restrict__ z_mode,
                            const unsigned char* __restrict__ valid,
                            const int* __restrict__ bbox, float* __restrict__ out,
                            float* __restrict__ chunk_minz) {
  __shared__ float4 stage4[(kThreads * 16 + 4) / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long live = live_rows(ends, n, cap);
  const int ncol = wide ? 16 : 13;
  const long long r0 = (long long)blockIdx.x * kThreads;
  const long long p = r0 + threadIdx.x;
  const long long g0 = r0 * ncol;
  int zq = zq_max;
  if (p < cap) {
    float row[16];
    if (p < live) {
      const unsigned key = keys[p];
      const long long tri = key & tri_mask;
      zq = (int)(key >> tri_bits);
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
      if (live > 0) zq = *dead_zq;
#pragma unroll
      for (int k = 0; k < 16; ++k) row[k] = 0.0f;
      row[2] = -1.0f;
      row[12] = wide ? -1.0f : 0.0f;
    }
    if (wide) {   // 64-byte rows, 16-byte aligned: four float4s (scalars would conflict)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        stage4[4 * threadIdx.x + k] =
            make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2], row[4 * k + 3]);
      }
    } else {      // 52-byte rows (13 is odd: no bank conflict)
      float* dst = stage + (g0 & 3) + (long long)threadIdx.x * 13;
#pragma unroll
      for (int k = 0; k < 13; ++k) dst[k] = row[k];
    }
  }
  if (z_order) {
    // a segmented minimum over the warp's rows of one chunk (consecutive
    // lanes), then one atomic per chunk the warp touches
    const int lane = threadIdx.x & 31;
    const long long c = p / chunk;
    int best = zq;
    for (int o = 1; o < 32; o <<= 1) {
      const int other = __shfl_down_sync(0xffffffffu, best, o);
      const long long oc = __shfl_down_sync(0xffffffffu, c, o);
      if (lane + o < 32 && oc == c) best = min(best, other);
    }
    const long long prev = __shfl_up_sync(0xffffffffu, c, 1);
    if (p < cap && (lane == 0 || prev != c)) {
      atomicMin(reinterpret_cast<int*>(chunk_minz + c),
                __float_as_int(__fmul_rn((float)best, inv_zq_max)));
    }
  }
  __syncthreads();
  const long long rows = cap - r0 < kThreads ? cap - r0 : kThreads;
  store_lines(out, g0, rows * ncol, stage);
}

unsigned blocks_for(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int grid_stride_blocks(long long items) {
  const long long want = blocks_for(items, kThreads);
  const long long most = (long long)sm_count() * kCountBlocksPerSm;
  return (int)(want < most ? (want > 0 ? want : 1) : most);
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

// Step 2, the stages selected by `stages` (count 1, scan 2, scatter 4,
// short sort 8, long sort 16, pack 32; the wrapper passes all).  ends i64 [n] (inclusive sums
// of the counts), info i32 [n,4] from step 1; scratch: rows i32 [cap,4]
// (16-byte aligned; also the long sort's merge buffers), keys u32 [cap], hist
// i32 [n_tiles], long_tiles i32 [n_tiles], n_long and dead_zq i32 [1] each.
// Writes pair_data f32 [cap, 13|16], starts i32 [n_tiles+1], chunk_minz f32
// [cap/chunk] (zeros without z_order), max_segment and total_pairs (i32
// scalars).  sort_keys, a power of two from 32 to 4096, is the longest run
// the short sort takes; radix_keys, from 32 to 12288, the longest run the
// long sort sorts in shared memory in one piece.  key_bits: the bits of the largest key (tri_bits, plus zq's under
// z_order).
extern "C" int binning_sort_launch(const long long* ends, const int* info, int n, long long cap,
                                   int chunk, int tiles_x, int n_tiles, int z_order, int tri_bits,
                                   int zq_max, int wide, int sort_keys, int radix_keys,
                                   int key_bits, const float* adj, const float* z_vert,
                                   const float* c_z, const unsigned char* z_mode,
                                   const unsigned char* valid, const int* bbox, int* rows,
                                   unsigned* keys, int* hist, int* long_tiles, int* n_long,
                                   int* dead_zq, float* pair_data, int* starts, float* chunk_minz,
                                   int* max_segment, int* total_pairs, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int4* rows4 = reinterpret_cast<int4*>(rows);
  const int grid = grid_stride_blocks(cap);
  if (stages & kCount) {
    cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n_tiles, s);
    if (cap > 0) {
      count_kernel<<<grid, kThreads, 0, s>>>(ends, reinterpret_cast<const int4*>(info), n, cap,
                                              tiles_x, z_order, tri_bits, hist, rows4, dead_zq);
    }
  }
  if (stages & kScan) {
    scan_kernel<<<1, kScanThreads, 0, s>>>(hist, n_tiles, ends, n, sort_keys, starts,
                                           max_segment, total_pairs, long_tiles, n_long);
  }
  if ((stages & kScatter) && cap > 0) {
    scatter_kernel<<<grid, kThreads, 0, s>>>(ends, n, cap, rows4, starts, keys);
  }
  if ((stages & kShortSort) && n_tiles > 0) {
    sort_short_kernel<<<n_tiles, kThreads, sizeof(unsigned) * sort_keys, s>>>(starts, keys,
                                                                            sort_keys);
  }
  if ((stages & kLongSort) && n_tiles > 0) {
    const size_t smem = 2 * sizeof(unsigned) * (size_t)radix_keys;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sort_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int long_blocks = kLongBlocksPerSm * sm_count();
    sort_long_kernel<<<n_tiles < long_blocks ? n_tiles : long_blocks, kLongThreads, smem, s>>>(
        starts, long_tiles, n_long, keys, reinterpret_cast<unsigned*>(rows), rows + cap,
        radix_keys, key_bits);
  }
  const long long n_chunks = chunk > 0 ? cap / chunk : 0;
  if ((stages & kPack) && cap > 0) {
    // chunk_minz starts above every value under z_order (0x7f7f7f7f is
    // 3.4e38), and is zeros otherwise
    cudaMemsetAsync(chunk_minz, z_order ? 0x7f : 0, sizeof(float) * (size_t)n_chunks, s);
    const float inv = zq_max > 0 ? (float)(1.0 / zq_max) : 0.0f;
    const unsigned tri_mask = z_order ? (1u << tri_bits) - 1u : 0xFFFFFFFFu;
    pack_kernel<<<blocks_for(cap, kThreads), kThreads, 0, s>>>(
        ends, n, cap, chunk, z_order, tri_bits, tri_mask, zq_max, inv, wide, keys, dead_zq, adj,
        z_vert, c_z, z_mode, valid, bbox, pair_data, chunk_minz);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
