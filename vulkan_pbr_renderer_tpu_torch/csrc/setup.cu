// Triangle transform + setup for Hopper (sm_90a): world positions to every
// TriSetup field in one launch a raster pass.
//
// Replaces no Pallas kernel: the JAX package computes these in XLA,
// vulkan_pbr_renderer_tpu/raster/setup.py:171 transform_to_clip followed by
// :65 setup_triangles (with _adjugate3 at :43), outside any kernel.  In the
// port their plain versions (raster/setup.py transform_to_clip and
// setup_triangles) run as some 200 elementwise PyTorch kernels over all N
// triangles each pass, which held most of the camera raster pass's launches
// and device time; raster/setup.py transform_and_setup launches this kernel
// on a CUDA tensor instead.
//
// Input: tri_pos [N,3,3] f32 world positions whose rows may be `row_stride`
// floats apart (the renderer passes the view scene.tri_attr[:, :9], 96 bytes
// a row, read in place), the [4,4] matrix, an optional [2] NDC jitter, the
// viewport and the cull mode.  Output: the eight TriSetup fields, each its
// own contiguous tensor of the plain version's dtype and shape.
//
// What bounds it on the card.  Each triangle reads 36 bytes and writes 94
// (adj 36, c_w 12, c_z 12, z_vert 12, det 4, bbox 16, z_mode 1, valid 1):
// 83.03 MB on SunTemple's 638,700 triangles, 0.0248 ms at 3.35 TB/s.  The
// arithmetic (~220 flops a triangle, 15 of them IEEE divides) is well under it.
// The strided rows make the reads touch 64 of every 96 bytes.
//
// Design: one thread per triangle, everything in registers; the matrix and
// the jitter in shared memory.  A thread's 36-byte adj row and 12-byte c_w,
// c_z and z_vert rows would be scalar stores 36 and 12 bytes apart across a
// warp, each store instruction touching up to 36 sectors of L2 for 4 bytes
// apiece; so the block stages those four fields of its triangles in shared
// memory (18 KB) and writes each as one contiguous run of 16-byte lines.
// det, bbox (one 16-byte store), z_mode and valid are already contiguous
// across a warp and go out directly.  Rows 16-byte aligned (the renderer's
// 96-byte tri_attr rows) load as two float4 and a float, three load
// instructions where nine scalars would each touch a sector of every row in
// the warp; other rows (a dense [N,3,3], 36 bytes apart) as nine floats.  On path A's passes the staging took the kernel from about 3x
// its bound to under 2x (PERF.md).
//
// Exactness: the outputs equal the plain composition on the card bit for
// bit.  PyTorch runs that composition one elementwise op at a time, each
// rounded once, so every product, sum and divide here is a _rn intrinsic in
// the plain version's order, and the file is compiled with -fmad=false and
// without fast math.  The constants are the f32 roundings PyTorch makes of
// its Python scalars (1e-6, 1e-30, 1e9).  torch.sign is (0 < d) - (d < 0)
// (0 for a NaN or a signed zero); clamp and amin / amax propagate NaN.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStaged = 18;   // floats of a triangle staged: adj 9, c_w 3, c_z 3, z_vert 3
constexpr float kEps = 1e-6f;
constexpr float kTiny = 1e-30f;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
// NaN-propagating minimum / maximum and clamps (torch.amin, amax, clamp)
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v != v) ? v : (v < lo ? lo : v);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

// n floats from shared memory to dst (16-byte aligned), by the whole block:
// 16-byte lines, then the tail
__device__ __forceinline__ void store_lines(float* __restrict__ dst, const float* src, int n) {
  const int lines = n / 4;
  for (int q = threadIdx.x; q < lines; q += kThreads) {
    reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
  }
  for (int q = 4 * lines + threadIdx.x; q < n; q += kThreads) dst[q] = src[q];
}

// Triangle i: its fields, the staged ones into the block's stage.
// cull: 0 back (keep det < 0, flip -1), 1 front (det > 0, flip 1), 2 none
// (det != 0, flip sign(det))
__device__ __forceinline__ void setup_one(
    const float* __restrict__ pos, long long row_stride, int aligned_rows, const float* m,
    bool jittered, int width, int height, int cull, int i, float* stage,
    unsigned char* __restrict__ zmode_out, float* __restrict__ det_out,
    int* __restrict__ bbox_out, unsigned char* __restrict__ valid_out) {
  // transform_to_clip: clip[r] = (x*m[r][0] + y*m[r][1]) + (z*m[r][2] + m[r][3])
  // (utils/math3d.py transform_points), then x, y += jitter * w
  const float* p = pos + (size_t)i * (size_t)row_stride;
  float q[9];
  if (aligned_rows) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    q[0] = a.x, q[1] = a.y, q[2] = a.z, q[3] = a.w, q[4] = b.x, q[5] = b.y, q[6] = b.z;
    q[7] = b.w, q[8] = __ldg(p + 8);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) q[k] = __ldg(p + k);
  }
  float xh[3], yh[3], z[3], w[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float px = q[3 * v], py = q[3 * v + 1], pz = q[3 * v + 2];
    float c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      c[r] = add(add(mul(px, m[4 * r]), mul(py, m[4 * r + 1])),
                 add(mul(pz, m[4 * r + 2]), m[4 * r + 3]));
    }
    if (jittered) {
      c[0] = add(c[0], mul(m[16], c[3]));
      c[1] = add(c[1], mul(m[17], c[3]));
    }
    // homogeneous pixel coordinates: (0.5 x + 0.5 w) * width
    xh[v] = mul(add(mul(0.5f, c[0]), mul(0.5f, c[3])), (float)width);
    yh[v] = mul(add(mul(0.5f, c[1]), mul(0.5f, c[3])), (float)height);
    z[v] = c[2];
    w[v] = c[3];
  }

  // _adjugate3 of the rows (xh, yh, w): a[v][k]; cof[r][c] is c_rc
  const float a[3][3] = {{xh[0], yh[0], w[0]}, {xh[1], yh[1], w[1]}, {xh[2], yh[2], w[2]}};
  float cof[3][3];
  cof[0][0] = sub(mul(a[1][1], a[2][2]), mul(a[1][2], a[2][1]));
  cof[0][1] = sub(mul(a[1][2], a[2][0]), mul(a[1][0], a[2][2]));
  cof[0][2] = sub(mul(a[1][0], a[2][1]), mul(a[1][1], a[2][0]));
  cof[1][0] = sub(mul(a[0][2], a[2][1]), mul(a[0][1], a[2][2]));
  cof[1][1] = sub(mul(a[0][0], a[2][2]), mul(a[0][2], a[2][0]));
  cof[1][2] = sub(mul(a[0][1], a[2][0]), mul(a[0][0], a[2][1]));
  cof[2][0] = sub(mul(a[0][1], a[1][2]), mul(a[0][2], a[1][1]));
  cof[2][1] = sub(mul(a[0][2], a[1][0]), mul(a[0][0], a[1][2]));
  cof[2][2] = sub(mul(a[0][0], a[1][1]), mul(a[0][1], a[1][0]));
  // adj[r][c] = cof[c][r]; det = (m00 adj00 + m01 adj10) + m02 adj20
  const float det = add(add(mul(a[0][0], cof[0][0]), mul(a[0][1], cof[0][1])),
                        mul(a[0][2], cof[0][2]));
  bool valid;
  float flip;
  if (cull == 0) {
    valid = det < 0.0f;
    flip = -1.0f;
  } else if (cull == 1) {
    valid = det > 0.0f;
    flip = 1.0f;
  } else {
    valid = det != 0.0f;
    flip = (float)((int)(0.0f < det) - (int)(det < 0.0f));
  }
  float adj[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) adj[r][c] = mul(cof[c][r], flip);
  }
  const float abs_det = mul(flip, det);
  const float div_det = abs_det == 0.0f ? 1.0f : abs_det;
  float c_w[3], c_z[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c_w[r] = add(add(adj[r][0], adj[r][1]), adj[r][2]);
    c_z[r] = div(add(add(mul(adj[r][0], z[0]), mul(adj[r][1], z[1])), mul(adj[r][2], z[2])),
                 div_det);
  }

  // high-precision depth: per-vertex z / safe_w and its deltas
  float zv[3];
  bool z_mode = true, any_front = false;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    zv[v] = div(z[v], fabsf(w[v]) < kEps ? kEps : w[v]);
    z_mode = z_mode && (w[v] > kEps);
    any_front = any_front || (w[v] > kEps);
  }

  // screen bbox of the front vertices, extended to the border along each
  // sign of the w = eps crossings of the edges
  bool front[3];
  float lo_x[3], hi_x[3], lo_y[3], hi_y[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    front[v] = w[v] > kEps;
    const float wc = clamp_min(w[v], kEps);
    const float pxv = div(xh[v], wc), pyv = div(yh[v], wc);
    lo_x[v] = front[v] ? pxv : kBig;
    hi_x[v] = front[v] ? pxv : -kBig;
    lo_y[v] = front[v] ? pyv : kBig;
    hi_y[v] = front[v] ? pyv : -kBig;
  }
  float px_min = minp(minp(lo_x[0], lo_x[1]), lo_x[2]);
  float px_max = maxp(maxp(hi_x[0], hi_x[1]), hi_x[2]);
  float py_min = minp(minp(lo_y[0], lo_y[1]), lo_y[2]);
  float py_max = maxp(maxp(hi_y[0], hi_y[1]), hi_y[2]);
  bool ext_xp = false, ext_xn = false, ext_yp = false, ext_yn = false;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int j = (e + 1) % 3;
    const bool cross = front[e] != front[j];
    const float dw = sub(w[j], w[e]);
    const float denom = fabsf(dw) < kTiny ? kTiny : dw;
    const float t = div(sub(kEps, w[e]), denom);
    const float dx = add(xh[e], mul(t, sub(xh[j], xh[e])));
    const float dy = add(yh[e], mul(t, sub(yh[j], yh[e])));
    ext_xp = ext_xp || (cross && dx >= 0.0f);
    ext_xn = ext_xn || (cross && dx <= 0.0f);
    ext_yp = ext_yp || (cross && dy >= 0.0f);
    ext_yn = ext_yn || (cross && dy <= 0.0f);
  }
  if (ext_xn) px_min = -kBig;
  if (ext_xp) px_max = kBig;
  if (ext_yn) py_min = -kBig;
  if (ext_yp) py_max = kBig;
  const float fw = (float)width, fh = (float)height;
  const int x0 = (int)clamp(floorf(px_min), 0.0f, fw);
  const int y0 = (int)clamp(floorf(py_min), 0.0f, fh);
  const int x1 = (int)clamp(add(ceilf(px_max), 1.0f), 0.0f, fw);
  const int y1 = (int)clamp(add(ceilf(py_max), 1.0f), 0.0f, fh);
  valid = valid && any_front && (x1 > x0) && (y1 > y0);

  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) stage[t * 9 + 3 * r + c] = adj[r][c];
    stage[kThreads * 9 + t * 3 + r] = c_w[r];
    stage[kThreads * 12 + t * 3 + r] = c_z[r];
  }
  stage[kThreads * 15 + t * 3] = zv[0];
  stage[kThreads * 15 + t * 3 + 1] = sub(zv[1], zv[0]);
  stage[kThreads * 15 + t * 3 + 2] = sub(zv[2], zv[0]);
  zmode_out[i] = z_mode ? 1 : 0;
  det_out[i] = det;
  reinterpret_cast<int4*>(bbox_out)[i] = make_int4(x0, y0, x1, y1);
  valid_out[i] = valid ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
setup_kernel(const float* __restrict__ pos, long long row_stride, const float* __restrict__ mat,
             const float* __restrict__ jitter, int width, int height, int cull, int n,
             float* __restrict__ adj_out, float* __restrict__ cw_out, float* __restrict__ cz_out,
             float* __restrict__ zv_out, unsigned char* __restrict__ zmode_out,
             float* __restrict__ det_out, int* __restrict__ bbox_out,
             unsigned char* __restrict__ valid_out, int aligned_rows) {
  __shared__ float m[18];   // the matrix row-major, then the jitter
  // the block's adj rows, then its c_w, c_z and z_vert rows, as they lie in
  // the outputs
  __shared__ __align__(16) float stage[kThreads * kStaged];
  if (threadIdx.x < 16) m[threadIdx.x] = mat[threadIdx.x];
  if (jitter != nullptr && threadIdx.x >= 16 && threadIdx.x < 18) {
    m[threadIdx.x] = jitter[threadIdx.x - 16];
  }
  __syncthreads();
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  if (i < n) setup_one(pos, row_stride, aligned_rows, m, jitter != nullptr, width, height, cull,
                       i, stage, zmode_out, det_out, bbox_out, valid_out);
  __syncthreads();
  const int count = min(kThreads, n - i0);
  store_lines(adj_out + (size_t)i0 * 9, stage, count * 9);
  store_lines(cw_out + (size_t)i0 * 3, stage + kThreads * 9, count * 3);
  store_lines(cz_out + (size_t)i0 * 3, stage + kThreads * 12, count * 3);
  store_lines(zv_out + (size_t)i0 * 3, stage + kThreads * 15, count * 3);
}

}  // namespace

// Launch on `stream` one thread per triangle (n > 0).  `pos` rows are
// row_stride floats apart, each [3,3] contiguous; `jitter` may be null;
// the outputs must be 16-byte aligned.  Returns the first CUDA error (0 =
// launched); the wrapper raises on anything else.
extern "C" int setup_launch(const float* pos, long long row_stride, const float* mat,
                            const float* jitter, int width, int height, int cull, int n,
                            float* adj, float* c_w, float* c_z, float* z_vert,
                            unsigned char* z_mode, float* det, int* bbox, unsigned char* valid,
                            void* stream) {
  const int aligned_rows = row_stride % 4 == 0 && (size_t)pos % 16 == 0;
  if (n > 0) {
    setup_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        pos, row_stride, mat, jitter, width, height, cull, n, adj, c_w, c_z, z_vert, z_mode, det,
        bbox, valid, aligned_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
