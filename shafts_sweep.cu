// Sweep-only source (tile_sweep.py's "shafts" group), never built by the
// package: the polar shafts with no profile.  Each shaft pixel takes the n_r
// bilinear samples of its own profile row inline (csrc/lighting.cu's
// profile_value, the same arithmetic) and compares them, in one plain
// launch with no flags: 6.3 M samples at path A's 130,560 shaft pixels x
// 48 against the profile's 196,608, read from a 16.8 MB sun map that L2
// holds.  It is the alternative measured against the package's one-launch
// banded kernel (csrc/lighting.cu shafts_polar_kernel) and not kept; see
// PERF.md.
//
// It compiles the package's lighting.cu into the same library, renaming
// that file's launcher, so that its own shafts_polar_launch takes the
// banded kernel's place behind shade/shadow.py's plan (whose flags it
// ignores).

#define shafts_polar_launch shafts_polar_launch_banded
#include "vulkan_pbr_renderer_tpu_torch/csrc/lighting.cu"
#undef shafts_polar_launch

namespace {

__global__ void __launch_bounds__(kThreads) shafts_inline_kernel(const ShaftArgs a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)a.rows * a.cols) return;
  float cs[3];
  cam_sun(a, cs);
  const ShaftPixel sp = shaft_setup(a, cs, t);
  float hits = 0.0f;
  for (int jj = 0; jj < a.n_r; ++jj)
    hits += shaft_hit(a, cs, sp, jj, profile_value(a, cs, sp.kt, jj));
  shaft_store(a, sp, hits, t);
}

}  // namespace

extern "C" int shafts_polar_launch(const ShaftArgs* args, int, void* stream) {
  const long long n = (long long)args->rows * args->cols;
  if (n > 0)
    shafts_inline_kernel<<<(int)((n + kThreads - 1) / kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
