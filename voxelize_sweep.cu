// Sweep-only source (tile_sweep.py's "voxelize" group), never built by the
// package: csrc/voxelize.cu's per-sample arithmetic (voxel_sample) behind an
// int64 kernel with a binary search a sample, whatever the stream, in
// place of the package's voxelize_kernel.  With no -D value it is the
// earlier two-launch pass (a memset and this kernel, then the package's
// decode), the design the package's one-launch pass
// (voxelize_pass_launch, compiled here unchanged) is timed against.  Its
// forks the package does not keep and probes say where the kernel's time
// goes.  The forks are bit for bit with the plain chain (tile_sweep.py
// checks them):
//  - VOXEL_BLOCK_WINDOW=1: a block finds the triangles of its first and
//    last sample by binary search over the offsets in device memory, stages
//    the offsets between them (at most one a sample) in shared memory, and
//    each sample searches there (the package: a search a sample over the
//    whole offsets);
//  - VOXEL_READ_FIRST=1: a sample reads its voxel's word from L2 first and
//    skips its atomicMax where the word there is already at least its own
//    (the words only grow, so a stale read never skips a needed atomic);
//  - VOXEL_WARP_MAX=1: the lanes of a warp that hit one voxel
//    (__match_any_sync) take their words' max (__reduce_max_sync) and one
//    lane issues the atomic.
//  - VOXEL_PASS_ZERO_FIRST=1 (a fork of the one-launch pass, its first
//    design): a first phase zeroes the u32 words, a grid barrier, the
//    samples, a barrier, the decode (which leaves the words as they are);
//  - VOXEL_PASS_ZERO_OUT=1 (the same with the decoded grid): the first
//    phase zeroes the decoded grid too, whose 33.5 MB of writes the L2 then
//    drains while the samples run, and the decode stores only the occupied
//    voxels (it reads every word from L2).
// The probes (not the plain version's bits; timed only): VOXEL_PROBE=1
// issues no atomic (the word's work stays alive behind a store that never
// happens), 2 stops after the lookup.  VOXEL_THREADS (samples a block) is
// the package's own -D value.
//
// It compiles the package's voxelize.cu into the same library, renaming
// that file's int64 launcher and occupancy query, so that its own take
// their place behind shade/gi.py's voxelize_scene (the decode and the
// one-launch pass are the package's).

#ifndef VOXEL_BLOCK_WINDOW
#define VOXEL_BLOCK_WINDOW 0
#endif
#ifndef VOXEL_READ_FIRST
#define VOXEL_READ_FIRST 0
#endif
#ifndef VOXEL_WARP_MAX
#define VOXEL_WARP_MAX 0
#endif
#ifndef VOXEL_PROBE
#define VOXEL_PROBE 0
#endif
#ifndef VOXEL_PASS_ZERO_FIRST
#define VOXEL_PASS_ZERO_FIRST 0
#endif
#ifndef VOXEL_PASS_ZERO_OUT
#define VOXEL_PASS_ZERO_OUT 0
#endif

#define voxelize_launch voxelize_launch_package
#define voxelize_occupancy voxelize_occupancy_package
#if VOXEL_PASS_ZERO_FIRST || VOXEL_PASS_ZERO_OUT
#define voxelize_pass_launch voxelize_pass_launch_package
#endif
#include "vulkan_pbr_renderer_tpu_torch/csrc/voxelize.cu"
#undef voxelize_launch
#undef voxelize_occupancy
#undef voxelize_pass_launch

namespace {

__global__ void __launch_bounds__(kThreads) voxelize_sweep_kernel(const VoxelArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
#if VOXEL_BLOCK_WINDOW
  // the launch covers only blocks whose first sample lies below the total
  __shared__ int s_off[kThreads];
  __shared__ int s_t[2];
  if (threadIdx.x < 2) {
    const int first = a.start + blockIdx.x * kThreads;
    const int last = min(a.start + min((int)(blockIdx.x + 1) * kThreads, a.s_len), a.total) - 1;
    s_t[threadIdx.x] = last_at_or_below(a.n_tris, threadIdx.x == 0 ? first : last,
                                        [&](int k) { return __ldg(a.offsets + k); });
  }
  __syncthreads();
  const int t0 = s_t[0];
  const int n = s_t[1] - t0 + 1;   // <= kThreads: one run start at most a sample
  for (int k = threadIdx.x; k < n; k += kThreads) s_off[k] = __ldg(a.offsets + t0 + k);
  __syncthreads();
  const int pid = a.start + i;
  if (i >= a.s_len || pid >= a.total) return;
  const int k = last_at_or_below(n, pid, [&](int j) { return s_off[j]; });
  const int t = t0 + k;
  const float local = (float)(pid - s_off[k]);
#else
  const int pid = a.start + i;
  if (i >= a.s_len || pid >= a.total) return;
  const int t = last_at_or_below(a.n_tris, pid, [&](int j) { return __ldg(a.offsets + j); });
  const float local = (float)(pid - __ldg(a.offsets + t));
#endif
#if VOXEL_PROBE == 2
  if (local == -1.0f) a.grid[0] = t;   // never: keeps the lookup alive
  return;
#endif
  long long idx, word;
  if (!voxel_sample(a, t, local, idx, word)) return;
  unsigned long long* cell = reinterpret_cast<unsigned long long*>(a.grid) + idx;
#if VOXEL_PROBE == 1
  // never (n_tris >= 1, word >= 1), which the compiler cannot see
  if (word == -(long long)a.n_tris) *cell = (unsigned long long)word;
  return;
#endif
#if VOXEL_WARP_MAX
  const unsigned mask = __activemask();
  const unsigned peers = __match_any_sync(mask, (unsigned)idx);
  const unsigned top = __reduce_max_sync(peers, (unsigned)word);
  if ((int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  word = top;
#endif
#if VOXEL_READ_FIRST
  if ((unsigned long long)word <= __ldcg(cell)) return;
#endif
  atomicMax(cell, (unsigned long long)word);
}

}  // namespace

// csrc/voxelize.cu's launcher with this file's kernel.
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
    voxelize_sweep_kernel<<<(live + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(a);
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int voxelize_occupancy(int* registers, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, voxelize_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, voxelize_sweep_kernel,
                                                            kThreads, 0);
}

#if VOXEL_PASS_ZERO_FIRST || VOXEL_PASS_ZERO_OUT
namespace {

__global__ void __launch_bounds__(kThreads) voxelize_pass_fork_kernel(const VoxelArgs a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long cells = (long long)a.grid_size * a.grid_size * a.grid_size;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kThreads;
  uint4* const w4 = reinterpret_cast<uint4*>(a.words);
  float4* const out = reinterpret_cast<float4*>(a.out);
  for (long long i = first; i < cells / 4; i += step) w4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = cells / 4 * 4 + first; i < cells; i += step) a.words[i] = 0u;
  if (VOXEL_PASS_ZERO_OUT)
    for (long long i = first; i < cells; i += step) out[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  grid.sync();
  const int live = min(a.s_len, a.total - a.start);
  for (long long i = first; i < live; i += step) {
    float local;
    const int t = sample_triangle(a, a.start + (int)i, local);
    long long cell, word;
    if (voxel_sample(a, t, local, cell, word)) atomicMax(a.words + cell, (unsigned)word);
  }
  grid.sync();
  for (long long i = first; i < cells; i += step) {
    const unsigned w = __ldcg(a.words + i);
    if (w || !VOXEL_PASS_ZERO_OUT) out[i] = decode_word((long long)w, a.inv255);
  }
}

}  // namespace

// csrc/voxelize.cu's voxelize_pass_launch with this file's pass kernel
// (the grid the same: as many blocks as are resident, at most one per
// kThreads voxels).
extern "C" int voxelize_pass_launch(const VoxelArgs* args, int device, void* stream) {
  static int resident[64];
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const VoxelArgs& a = *args;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, voxelize_pass_fork_kernel,
                                                          kThreads, 0);
    if (err == cudaSuccess) resident[device] = sms * per_sm;
  }
  if (err == cudaSuccess) {
    const long long cells = (long long)a.grid_size * a.grid_size * a.grid_size;
    const long long blocks = (cells + kThreads - 1) / kThreads;
    const int grid = blocks < resident[device] ? (int)blocks : resident[device];
    void* params[] = {const_cast<VoxelArgs*>(args)};
    err = cudaLaunchCooperativeKernel((const void*)voxelize_pass_fork_kernel,
                                      dim3(grid > 0 ? grid : 1), dim3(kThreads), params, 0,
                                      (cudaStream_t)stream);
  }
  if (cur != device) cudaSetDevice(cur);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
#endif
