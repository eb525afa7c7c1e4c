"""Dynamic voxel-grid global illumination (counterpart of
vulkan_pbr_renderer_tpu/shade/gi.py), the stages both GI modes run:

1. **Voxelize** (lightgrid_voxelize.glsl): area-proportional point samples
   of every triangle, sun-lit through the shadow map, scatter-maxed into a
   packed [D,D,D] word grid and decoded.  Runs only when the sun moved.
   The frame's entry point `voxelize_lightgrid` is one cooperative launch
   of csrc/voxelize.cu on the card (u32 words scatter-maxed, then decoded
   and zeroed again, split by a grid-wide barrier); the row-sharded frame
   keeps the int64 words of `voxelize_scene` (a memset and a kernel) for
   its ranks' max, then `decode_voxel_grid`.  Both take the per-scene plan
   its caller holds (`_VoxelPlan`: the checks, the stream's offsets and
   the f16 triangle rows).  On the CPU the plain versions
   `voxelize_scene_plain` and `decode_voxel_grid_plain`.
2. **Sweep** (lightgrid_sweep.glsl): the per-axis moving-light recurrence
   L[i] = a[i]*L[i-1] + b[i], solved by the same log-depth associative scan
   the reference package uses, in the same tree order.  The frame's entry
   point `sweep_lightgrid_u8` also writes the fast GI's u8 table
   (`quantize_grid_u8`) beside the swept grid: on the card one launch of
   csrc/sweep.cu (the ring kernel with each line in 16 lanes' registers,
   or the replay kernel for lengths it does not take), on the CPU the two
   plain versions.
3. **Marches** (lighting_pass.glsl:236-424).  The fast form: the fog march
   on the window-packed grid (`sample_radiance_fog`) and the bounded linear
   screen trace (`screen_trace_linear`).  The reference form: the blockage
   skip (`_skip_blockage`), the voxel march (`_voxel_march`), the pure voxel
   march `sample_radiance` and the hybrid screen + voxel march
   `sample_radiance_with_screen_trace`.  Early breaks are per-lane masks over
   a static number of steps, so no step synchronizes with the host.  One
   fast-GI ray per lane, march + trace + resolve, is `fast_ray_resolve`:
   the CUDA kernel csrc/gi_fast_ray.cu on the card, `fast_ray_resolve_plain`
   on the CPU.  One reference-GI ray per lane, the hybrid march, is
   `reference_ray_resolve`: the CUDA kernel csrc/gi_reference_ray.cu on the
   card, `reference_ray_resolve_plain` on the CPU.  The fast GI's other
   marches and screen terms (section 5): the economy mode's quadrature
   (`sample_radiance_fast`, `march_to_hit`), the wave-9 march
   (`sample_radiance_march`), the screen probes (`screen_probe`,
   `screen_probe_multi`) and the hierarchical-z trace (`build_hiz_atlas`,
   `hiz_trace`, `screen_trace_hiz`); one ray of them per lane is
   `screen_ray_resolve_plain`, whose kernels (csrc/gi_screen_ray.cu) are
   `screen_ray_resolve` (the fog march with the probes or hi-z term) and
   `probe_ray_resolve` (the economy mode); the wave-9 march has none.

The packs keep the reference package's quantized values (u8 sqrt-compressed
radiance, alpha in 1/255 steps); both GI modes read them as one unpacked u8
table (`quantize_grid_u8`), whose trilinear fetches give the window packs'
values bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..gpu import cuda_build, sampling
from ..utils import color as colorlib
from ..utils import math3d as m3

# ---------------------------------------------------------------------------
# 2. Lightgrid sweep


def _interleave(even, odd):
    """Merge along dim 0: out[0::2] = even, out[1::2] = odd."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def _linrec_scan(a, b):
    """Inclusive scan of the affine maps (a, b) along dim 0 under
    (a1, b1) . (a2, b2) = (a1*a2, a2*b1 + b2) — jax.lax.associative_scan's
    recursion step for step, so the sums round in the same tree order."""
    n = a.shape[0]
    if n < 2:
        return a, b

    def combine(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]

    odd = _linrec_scan(*combine((a[0:-1:2], b[0:-1:2]), (a[1::2], b[1::2])))
    if n % 2 == 0:
        even = combine((odd[0][:-1], odd[1][:-1]), (a[2::2], b[2::2]))
    else:
        even = combine(odd, (a[2::2], b[2::2]))
    even = (torch.cat([a[:1], even[0]]), torch.cat([b[:1], even[1]]))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _sweep_linrec(values, occupied, rad, skylight, move_ratio, reverse):
    """One directional sweep along dim 0 (gi.py:42-65): empty voxel
    L_out = mr*(v + L_in), v' = (1-mr)/mr*L_out; occupied L_out = rad,
    v' = v; seed L = skylight; the final moving light is added to the last
    processed voxel."""
    occ = occupied[..., None]
    a = torch.where(occ, 0.0, move_ratio).to(values.dtype)
    b = torch.where(occ, rad, move_ratio * values)
    if reverse:
        a, b = a.flip(0), b.flip(0)
    A, B = _linrec_scan(a, b)
    if reverse:
        A, B = A.flip(0), B.flip(0)
    L = A * skylight + B
    new_vals = torch.where(occ, values, (1.0 - move_ratio) / move_ratio * L)
    end = 0 if reverse else -1
    new_vals[end] = new_vals[end] + L[end]
    return new_vals


def sweep_lightgrid(grid, axis, skylight=(1.0, 1.2, 2.0), move_ratio=0.5, blend=0.35):
    """One frame's sweep along `axis` (0=z, 1=y, 2=x of the [D,H,W,4] grid):
    forward then backward with the ORIGINAL occupancy and radiance, then a
    blend into the empty voxels (lightgrid_sweep.glsl:25-74)."""
    sky = torch.tensor(skylight, dtype=grid.dtype, device=grid.device)
    g = torch.movedim(grid, axis, 0)
    old_rgb = g[..., :3]
    alpha = g[..., 3]
    occupied = alpha > 0.5
    fwd = _sweep_linrec(old_rgb, occupied, old_rgb, sky, move_ratio, reverse=False)
    bwd = _sweep_linrec(fwd, occupied, old_rgb, sky, move_ratio, reverse=True)
    mixed = old_rgb + (bwd - old_rgb) * blend
    new_rgb = torch.where(occupied[..., None], old_rgb, mixed)
    return torch.movedim(torch.cat([new_rgb, alpha[..., None]], -1), 0, axis)


def sweep_schedule(n):
    """_linrec_scan's combines over a line of n, in the order its recursion
    makes them: a list of levels, each an int64 array [k, 2] of (src, dst)
    positions, where a level combines (a, b)[dst] = (a, b)[src] . (a,
    b)[dst] in place.  A level's pairs are disjoint (no position is both
    read and written), so they run at once; replayed level by level they
    give _linrec_scan's bits (csrc/sweep.cu walks them; the backward sweep
    mirrors the positions)."""
    def rec(idx):
        m = len(idx)
        if m < 2:
            return []
        up = np.stack([idx[0:m - 1:2], idx[1:m:2]], 1)[:m // 2]
        down = np.stack([idx[1:m - 1:2], idx[2::2]], 1)
        return [up] + rec(idx[1::2][:m // 2]) + ([down] if len(down) else [])

    return rec(np.arange(n, dtype=np.int64))


class _SweepArgs(ctypes.Structure):
    """struct SweepArgs of csrc/sweep.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "grid", "out", "table", "pairs", "level_start")] + [("sky", ctypes.c_float * 3)] + [
        (n, ctypes.c_float) for n in ("mr", "keep", "blend")] + [(n, ctypes.c_int) for n in (
            "n", "lines", "inner", "outer", "stride", "along", "levels", "n_pairs",
            "vec_table", "smem")]


SWEEP_MAX_SHARED = 232_448  # the shared memory a block may take on the H100


def sweep_layout(shape, axis):
    """(lines, inner, outer, stride) of the [D, H, W, 4] grid's lines along
    axis, as csrc/sweep.cu addresses them: line l starts at voxel (l //
    inner) * outer + l % inner and its voxels lie stride apart."""
    d, h, w = shape[:3]
    inner, outer, stride = {0: (h * w, 0, h * w), 1: (w, h * w, w), 2: (1, w, 1)}[axis]
    return d * h * w // shape[axis], inner, outer, stride


class _SweepPlan:
    """What a sweep launch of one grid shape and axis keeps between frames:
    the struct with every per-shape field set, the combine schedule on the
    card (sweep_schedule, src | dst << 16 a combine, and each level's start)
    and the grid's shape, which each call's grid is compared with
    (`accepts`).  A call sets the three data pointers under the plan's
    lock.  Raises ValueError where a block's lines do not fit in shared
    memory."""

    def __init__(self, device, shape, axis, skylight, move_ratio, blend):
        n = shape[axis]
        levels = sweep_schedule(n)
        pairs = (np.concatenate([lv[:, 0] | lv[:, 1] << 16 for lv in levels]) if levels
                 else np.zeros(0, np.int64))
        starts = np.cumsum([0] + [len(lv) for lv in levels])
        smem = _sweep_library().sweep_shared_bytes(n, len(pairs), len(levels))
        if smem > SWEEP_MAX_SHARED:
            raise ValueError(f"sweep_lightgrid_u8: a swept length of {n} needs {smem} bytes of "
                             f"shared memory a block, more than {SWEEP_MAX_SHARED}")
        self.pairs = torch.as_tensor(pairs.astype(np.uint32).view(np.int32), device=device)
        self.level_start = torch.as_tensor(starts.astype(np.int32), device=device)
        lines, inner, outer, stride = sweep_layout(shape, axis)
        f32 = np.float32
        self.shape, self.device, self.lock = tuple(shape), device.index, threading.Lock()
        self.args = _SweepArgs(
            pairs=self.pairs.data_ptr(), level_start=self.level_start.data_ptr(),
            sky=(ctypes.c_float * 3)(*f32(skylight)), mr=f32(move_ratio),
            keep=f32((1.0 - move_ratio) / move_ratio), blend=f32(blend), n=n,
            lines=lines, inner=inner, outer=outer, stride=stride, along=int(axis == 2),
            levels=len(levels), n_pairs=len(pairs),
            vec_table=int((inner if axis < 2 else shape[2]) % 4 == 0), smem=smem)

    def accepts(self, grid):
        """Whether grid is a contiguous float32 grid of the plan's shape on its
        card, 16-byte aligned (the kernel reads a voxel as one 16-byte load)."""
        return (grid.dtype == torch.float32 and grid.is_cuda
                and grid.get_device() == self.device and tuple(grid.shape) == self.shape
                and grid.is_contiguous() and grid.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=16)
def _sweep_plan(device, shape, axis, skylight, move_ratio, blend):
    return _SweepPlan(device, shape, axis, skylight, move_ratio, blend)


def _sweep_check(grid, axis):
    """The full checks of sweep_lightgrid_u8's inputs (ValueError)."""
    fn = "sweep_lightgrid_u8"
    if axis not in (0, 1, 2):
        raise ValueError(f"{fn}: axis must be 0, 1 or 2, got {axis!r}")
    cuda_build.need(grid, "grid", fn, grid.device if torch.is_tensor(grid) else None)
    if grid.dim() != 4 or grid.shape[3] != 4:
        raise ValueError(f"{fn}: grid must be [D, H, W, 4], got {tuple(grid.shape)}")
    if grid.is_cuda and grid.data_ptr() % 16:
        raise ValueError(f"{fn}: grid must start on a 16-byte boundary")


def sweep_lightgrid_u8(grid, axis, skylight=(1.0, 1.2, 2.0), move_ratio=0.5, blend=0.35):
    """One frame's sweep (sweep_lightgrid) and the u8 table of the swept
    grid (quantize_grid_u8): (grid_out [D,H,W,4] f32, table [D,H,W,4] u8).
    A CUDA tensor launches csrc/sweep.cu once (sweep_ring_kernel for lines
    of 16, 32, 64, 128 or 256 voxels, else lightgrid_sweep_kernel) through a
    plan cached per shape and axis (_SweepPlan), or raises; a CPU
    tensor takes the two plain versions.  On the card a call's grid is
    compared with its plan's; the full checks (ValueError) run on the CPU
    and where that comparison fails.  `sweep_lightgrid_u8.launches` counts
    launches."""
    if not torch.is_tensor(grid) or not grid.is_cuda:
        _sweep_check(grid, axis)
        g = sweep_lightgrid(grid, axis, skylight, move_ratio, blend)
        return g, quantize_grid_u8(g)
    if grid.dim() != 4 or grid.shape[3] != 4 or axis not in (0, 1, 2) or grid.numel() == 0:
        _sweep_check(grid, axis)   # raises, but on an empty grid
        return torch.empty_like(grid), torch.empty(grid.shape, dtype=torch.uint8,
                                                   device=grid.device)
    plan = _sweep_plan(grid.device, tuple(grid.shape), axis, tuple(skylight), float(move_ratio),
                       float(blend))
    if not plan.accepts(grid):
        _sweep_check(grid, axis)   # raises where the grid is wrong
    out = torch.empty(grid.shape, dtype=torch.float32, device=grid.device)
    table = torch.empty(grid.shape, dtype=torch.uint8, device=grid.device)
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    with plan.lock:
        args = plan.args
        args.grid, args.out, args.table = grid.data_ptr(), out.data_ptr(), table.data_ptr()
        err = _sweep_launcher()(ctypes.byref(args), plan.device, stream)
    if err != 0:
        raise RuntimeError(f"sweep_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(_sweep_library(), err)})")
    sweep_lightgrid_u8.launches += 1
    return out, table


sweep_lightgrid_u8.launches = 0


def _sweep_library():
    """The built sweep library (csrc/sweep.cu)."""
    lib = cuda_build.load_library("sweep")
    lib.sweep_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.sweep_shared_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _sweep_launcher():
    """csrc/sweep.cu's sweep_launch(args, device, stream)."""
    fn = _sweep_library().sweep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sweep_occupancy(n=128):
    """{registers, local_bytes, blocks_per_sm, lines_per_block, threads,
    lane_voxels, shared_bytes, kernel} of the sweep kernel that lines of n
    voxels take on the current card, as csrc/sweep.cu reports it: kernel
    "ring" (sweep_ring_kernel, lane_voxels the voxels a lane holds) or
    "replay" (lightgrid_sweep_kernel, lane_voxels 0); threads a block."""
    lib = _sweep_library()
    levels = sweep_schedule(n)
    smem = lib.sweep_shared_bytes(n, sum(len(lv) for lv in levels), len(levels))
    names = ("registers", "local_bytes", "blocks_per_sm", "lines_per_block", "threads",
             "lane_voxels")
    vals = [ctypes.c_int() for _ in names]
    fn = lib.sweep_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * len(names)
    fn.restype = ctypes.c_int
    err = fn(n, smem, *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"sweep_occupancy failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    out = dict(zip(names, (v.value for v in vals)))
    out.update(shared_bytes=smem, kernel="ring" if out["lane_voxels"] else "replay")
    return out


# ---------------------------------------------------------------------------
# 1. Voxelization by surface point sampling


def voxelize_sample_capacity(scene, grid_size, lightgrid_scale,
                             samples_per_voxel_area=4.0, cap=1 << 20, align=1024):
    """Host-side (numpy) exact size of voxelize_scene's sample stream: a
    multiple of `align` at or above the true sample count, capped at `cap`.
    Any capacity >= the true count gives the same samples."""
    ta = scene.tri_attr[:, :9].detach().cpu().numpy().astype(np.float32)
    p0, p1, p2 = ta[:, 0:3], ta[:, 3:6], ta[:, 6:9]
    n = np.cross(p1 - p0, p2 - p0)
    area = 0.5 * np.linalg.norm(n, axis=-1)
    voxel_size = 2.0 / (grid_size * lightgrid_scale)
    counts = np.ceil(area / (voxel_size * voxel_size)
                     * samples_per_voxel_area).astype(np.int64)
    total = int(np.clip(counts, 1, cap).sum())
    return int(min(-(-total // align) * align, cap))


def _norm3(v):
    """|v| over the last axis of 3, summed in XLA's order."""
    return m3.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                   + v[..., 2] * v[..., 2])


def _voxel_tables(tri_attr, mat_id, grid_size, lightgrid_scale, samples_per_voxel_area,
                  total_samples):
    """The sun-independent part of the voxelize stream: each triangle's
    exclusive sample offset (int64 [T]), the true sample total (an int64
    0-dim tensor) and the per-triangle f16 row [T,19] (p0 e1 e2 uv0 duv1
    duv2 normal mat)."""
    p0 = tri_attr[:, 0:3]
    e1 = tri_attr[:, 3:6] - p0
    e2 = tri_attr[:, 6:9] - p0
    n = m3.cross(e1, e2)
    nlen = _norm3(n)
    area = 0.5 * nlen
    tri_normal = n / torch.clamp(nlen, min=1e-12)[:, None]

    voxel_size = 2.0 / (grid_size * lightgrid_scale)
    area_vox = area / (voxel_size * voxel_size)
    counts = torch.clamp(torch.ceil(area_vox * samples_per_voxel_area).to(torch.int64),
                         1, total_samples)
    offsets = torch.cumsum(counts, 0) - counts
    total = offsets[-1] + counts[-1]

    # one per-sample row: p0 e1 e2 uv0 duv1 duv2 normal mat — 19 f16
    uv0 = tri_attr[:, 18:20]
    packrow = torch.cat([p0, e1, e2, uv0, tri_attr[:, 20:22] - uv0,
                         tri_attr[:, 22:24] - uv0, tri_normal,
                         mat_id.to(torch.float32)[:, None]], 1).to(torch.float16)
    return offsets, total, packrow


def _stream_fills(offsets, total_samples, shard_idx, shard_count):
    """The sample stream's expansion over a shard's slice: (pid, tri_of,
    run_start), each int64 [S].  Scatter each run's start, seed the
    carry-in run at position 0, forward-fill with cummax."""
    dev = offsets.device
    n_tris = offsets.shape[0]
    tri_ids = torch.arange(n_tris, dtype=torch.int64, device=dev)
    assert total_samples % shard_count == 0, "shard_count must divide total_samples"
    s_len = total_samples // shard_count
    start = (shard_idx or 0) * s_len
    loc = offsets - start
    scat = torch.where((loc >= 0) & (loc < s_len), loc, s_len)
    carry_tri = (offsets <= start).sum() - 1     # a device scalar: no host sync
    fill = torch.full((s_len + 1,), -1, dtype=torch.int64, device=dev)
    fill.scatter_reduce_(0, scat, tri_ids, "amax")
    fill[0] = torch.maximum(fill[0], carry_tri)
    tri_of = torch.clamp(torch.cummax(fill[:s_len], 0).values, 0, n_tris - 1)
    fill = torch.full((s_len + 1,), -1, dtype=torch.int64, device=dev)
    fill.scatter_reduce_(0, scat, offsets, "amax")
    fill[0] = torch.maximum(fill[0], offsets[carry_tri])
    run_start = torch.clamp(torch.cummax(fill[:s_len], 0).values, min=0)
    pid = start + torch.arange(s_len, dtype=torch.int64, device=dev)
    return pid, tri_of, run_start


def voxelize_scene_plain(scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world,
                         sun_dir, sun_emission, samples_per_voxel_area=4.0,
                         total_samples=1 << 20, texture_lod=4.0, shard_idx=None, shard_count=1,
                         work=None):
    """The packed [D,D,D] int64 radiance grid (one u32 word per voxel, the
    brightest-luminance sample kept; decode with decode_voxel_grid) from
    sun-lit surface samples (lightgrid_voxelize.glsl:100-129): emissive +
    shadow * base_color * max(N.L, 0) * sun_emission, a 1-tap shadow compare
    with a (+1,+1) texel offset and z bias 1e-3.  Point density follows
    triangle area in voxel units; the per-sample triangle row is rounded
    through f16 as in the reference package.  The plain version of
    csrc/voxelize.cu's voxelize_kernel (and, decoded, of its
    voxelize_pass_kernel).

    Sharded (gi.py:181-200): (shard_idx, shard_count) takes only the samples
    [shard_idx * S, (shard_idx + 1) * S) of the same stream, S = total /
    count; the run in flight at the slice's start (the carry-in triangle)
    seeds its first position.  Each sample's word equals the unsharded one,
    so the elementwise max of the shards' grids is the unsharded grid.

    sun_emission: a [3] float32 tensor or 3 numbers (made a float32 tensor).
    work: an optional dict
    that receives the flat atlas row (int64 [S]) and the sun map's window
    base texel (iy * S + ix) each sample reads ("atlas_rows", "sun_texels")
    and its in-range mask ("in_range")."""
    dev = scene.tri_attr.device
    sun_emission = _emission(sun_emission, dev)
    offsets, total, packrow = _voxel_tables(scene.tri_attr, scene.mat_id, grid_size,
                                            lightgrid_scale, samples_per_voxel_area,
                                            total_samples)
    pid, tri_of, run_start = _stream_fills(offsets, total_samples, shard_idx, shard_count)
    local = (pid - run_start).to(torch.float32)
    in_range = pid < total

    # low-discrepancy barycentric points (R2 sequence folded into the triangle)
    r = torch.stack([torch.remainder(local * 0.7548776662466927 + 0.13, 1.0),
                     torch.remainder(local * 0.5698402909980532 + 0.29, 1.0)], -1)
    flip = (r[:, 0] + r[:, 1]) > 1.0
    r = torch.where(flip[:, None], 1.0 - r, r)

    row = packrow[tri_of].to(torch.float32)
    pos = row[:, 0:3] + r[:, 0:1] * row[:, 3:6] + r[:, 1:2] * row[:, 6:9]
    uv = row[:, 9:11] + r[:, 0:1] * row[:, 11:13] + r[:, 1:2] * row[:, 13:15]
    sample_normal = row[:, 15:18]
    mat = row[:, 18].to(torch.int64)

    lod = torch.full(pid.shape, texture_lod, dtype=torch.float32, device=dev)
    rows = [] if work is not None else None
    texel = sampling.sample_mip_atlas_array_window_nearest(
        scene.tex_packed, mat, uv, lod, 12, scale=scene.tex_scale, rows=rows)
    base_color = texel[..., 0:3]
    emissive = texel[..., 9:12]

    p_sun = m3.transform_points(sun_space_from_world, pos)[..., :3]
    uv_sun = p_sun[..., :2] * 0.5 + 0.5 + 1.0 / sun_depth.shape[0]
    wdepth = sampling.pack_depth_window_u16(sun_depth)
    shadow = sampling.sample_depth_compare_window(wdepth, sun_depth.shape[0], uv_sun,
                                                  p_sun[..., 2] - 0.001)
    if work is not None:
        s = sun_depth.shape[0]
        x0f, y0f = (torch.floor(uv_sun[..., k] * s - 0.5) for k in (0, 1))
        work.update(atlas_rows=rows[0], in_range=in_range,
                    sun_texels=sampling._clamp_index(y0f, s).to(torch.int64) * s
                    + sampling._clamp_index(x0f, s))
    l = -sun_dir
    ldotn = torch.clamp((sample_normal[:, 0] * l[0] + sample_normal[:, 1] * l[1])
                        + sample_normal[:, 2] * l[2], min=0.0)
    radiance = emissive + (shadow * ldotn)[..., None] * base_color * sun_emission

    uvw = pos * lightgrid_scale * 0.5 + 0.5
    coord = torch.floor(uvw * grid_size).to(torch.int64)
    inside = torch.all((coord >= 0) & (coord < grid_size), dim=-1) & in_range
    iz, iy, ix = coord[:, 2], coord[:, 1], coord[:, 0]
    flat_idx = torch.where(inside, (iz * grid_size + iy) * grid_size + ix, 0)
    packed = torch.where(inside, _pack_voxel_sample(radiance), 0)
    grid = torch.zeros((grid_size ** 3,), dtype=torch.int64, device=dev)
    grid.scatter_reduce_(0, flat_idx, packed, "amax")
    return grid.reshape(grid_size, grid_size, grid_size)


def _pack_voxel_sample(rgb):
    """radiance [...,3] -> one u32 scatter word (held in int64, whose order
    agrees below 2^32): 8-bit luma key x/(1+x) in the high byte, then
    sqrt-compressed rgb (8 bits each, clipped to 254); at least 1, so an
    occupied voxel is a non-zero word."""
    lum = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    key = torch.clamp(torch.round(lum / (1.0 + lum) * 255.0), 0.0, 255.0)
    pos = torch.clamp(rgb, min=0.0)
    q = torch.clamp(torch.round(m3.sqrt(pos / (1.0 + pos)) * 255.0), 0.0, 254.0)
    q = q.to(torch.int64)
    word = (key.to(torch.int64) << 24) + (q[..., 0] << 16) + (q[..., 1] << 8) + q[..., 2]
    return torch.clamp(word, min=1)


def decode_voxel_grid_plain(packed):
    """[D,D,D] packed words (voxelize_scene) -> [D,D,D,4] f32 radiance +
    occupancy.  The plain version of csrc/voxelize.cu's decode_voxel_kernel."""
    q = torch.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF],
                    -1).to(torch.float32) * (1.0 / 255.0)
    c2 = q * q
    rgb = c2 / torch.clamp(1.0 - c2, min=1.0 / 256.0)
    alpha = (packed != 0).to(torch.float32)[..., None]
    return torch.cat([rgb * alpha, alpha], -1)


# ---------------------------------------------------------------------------
# 1b. Voxelize and decode on the card: csrc/voxelize.cu behind a per-scene plan

VOXEL_ROW = 20             # halves a plan row: the 19 of the plain's row + 1 pad (40 bytes)


class _VoxelPlan:
    """What voxelize_scene and voxelize_lightgrid keep per scene and stream
    configuration, made once (Renderer keeps it in FrameState, the
    row-sharded frame in its own state) and passed in: the checks of the
    scene's tensors and of the stream's numbers (ValueError), and every
    table that does not depend on the sun, made by the plain version's own
    ops (_voxel_tables), so its bits are the plain's: each triangle's
    exclusive sample offset (int64, and int32 clamped to total_samples, the
    kernels': an offset past the stream's end is past every sample), the
    true total (a tensor, and as a host int clamped to total_samples), and
    the f16 rows padded to VOXEL_ROW halves (40 bytes, 8-byte aligned);
    on the card the one-launch pass's u32 word grid (`words`, zeroed when
    its first call makes it and left zero by every pass), which serves the
    stream of that call alone (`words_stream`; a call on another stream
    raises ValueError, since two passes at once would share the words).
    `one_sample`: every triangle has one sample and the stream holds them
    all (the true total is T; offsets[t] = t), so a kernel's sample pid is
    triangle pid with no search.  The total and the rows' material
    range come to the host here, once.  It serves every shard:
    (shard_idx, shard_count) only moves the slice."""

    def __init__(self, scene, grid_size, lightgrid_scale, samples_per_voxel_area=4.0,
                 total_samples=1 << 20):
        _scene_check(scene, grid_size, total_samples)
        ta, mid = scene.tri_attr, scene.mat_id
        offsets, total, packrow = _voxel_tables(ta, mid, grid_size, lightgrid_scale,
                                                samples_per_voxel_area, total_samples)
        mats = packrow[:, 18].to(torch.float32).to(torch.int64)
        lo, hi = int(mats.min()), int(mats.max())
        layers = scene.tex_packed.shape[0]
        if lo < 0 or hi >= layers:
            raise ValueError(f"voxelize: material ids {lo}..{hi} outside the atlas's {layers} "
                             f"layers")
        self.offsets, self.total = offsets, total
        self.offsets32 = torch.clamp(offsets, max=total_samples).to(torch.int32)
        self.rows = torch.zeros((packrow.shape[0], VOXEL_ROW), dtype=torch.float16,
                                device=ta.device)
        self.rows[:, :19] = packrow
        self.n_tris = packrow.shape[0]
        self.n_total = min(int(total), total_samples)
        # every count is 1 (each is at least 1) and the stream holds them all
        self.one_sample = int(total) == self.n_tris <= total_samples
        self.words = None   # the pass's u32 word grid on the card, made at its first call
        self.words_stream = None   # the stream the word grid serves
        self.key = (str(ta.device), self.n_tris, tuple(scene.tex_packed.shape), int(grid_size),
                    float(lightgrid_scale), float(samples_per_voxel_area), int(total_samples))

    def check(self, scene, grid_size, lightgrid_scale, samples_per_voxel_area, total_samples,
              fn):
        """Raise ValueError unless the call's scene shape and stream are the
        plan's, and the scene's atlas still starts on a 16-byte line."""
        ta, tp = scene.tri_attr, scene.tex_packed
        key = (str(ta.device), ta.shape[0], tuple(tp.shape), int(grid_size),
               float(lightgrid_scale), float(samples_per_voxel_area), int(total_samples))
        if key != self.key:
            raise ValueError(f"{fn}: the plan was made for (device, triangles, atlas, grid, "
                             f"scale, density, stream) {self.key}, not {key}")
        if tp.is_cuda and tp.data_ptr() % 16:
            raise ValueError(f"{fn}: scene.tex_packed must start on a 16-byte boundary")


def _scene_check(scene, grid_size, total_samples):
    """The checks of the scene's tensors and the stream's numbers
    (ValueError), which a plan runs once."""
    fn = "voxelize"
    ta, mid = scene.tri_attr, scene.mat_id
    if (not torch.is_tensor(ta) or ta.dtype != torch.float32 or ta.dim() != 2
            or ta.shape[0] < 1 or ta.shape[1] != 24):
        raise ValueError(f"{fn}: scene.tri_attr must be a float32 [T, 24] tensor, T >= 1")
    dev = ta.device
    if (not torch.is_tensor(mid) or mid.is_floating_point() or mid.dtype == torch.bool
            or tuple(mid.shape) != (ta.shape[0],) or mid.device != dev):
        raise ValueError(f"{fn}: scene.mat_id must be an integer [{ta.shape[0]}] tensor "
                         f"on {dev}")
    for what, v in (("grid_size", grid_size), ("total_samples", total_samples)):
        if not isinstance(v, (int, np.integer)) or not 1 <= v < 2 ** 31:
            raise ValueError(f"{fn}: {what} must be an int in [1, 2^31), got {v!r}")
    tp = scene.tex_packed
    if not torch.is_tensor(tp) or tp.dim() != 4 or tp.shape[3] != 48:
        raise ValueError(f"{fn}: scene.tex_packed must be [L, H, Wa, 48]")
    cuda_build.need(tp, "scene.tex_packed", fn, dev, dtype=torch.uint8)
    if tp.shape[2] != sampling.mip_offsets(tp.shape[1], tp.shape[1])[1]:
        raise ValueError(f"{fn}: scene.tex_packed's width {tp.shape[2]} is not the mip atlas "
                         f"width of {tp.shape[1]} rows")
    if tp.is_cuda and tp.data_ptr() % 16:
        raise ValueError(f"{fn}: scene.tex_packed must start on a 16-byte boundary")
    cuda_build.need(scene.tex_scale, "scene.tex_scale", fn, dev, shape=(12,))


def _sun_check(dev, sun_depth, sun_space_from_world, sun_dir, sun_emission, total_samples,
               shard_idx, shard_count, fn):
    """The checks of a call's sun inputs and shard (ValueError): all a call
    with a plan runs besides the plan's own."""
    if not isinstance(shard_count, (int, np.integer)) or not 1 <= shard_count < 2 ** 31:
        raise ValueError(f"{fn}: shard_count must be an int in [1, 2^31), got {shard_count!r}")
    if total_samples % shard_count:
        raise ValueError(f"{fn}: shard_count {shard_count} must divide total_samples "
                         f"{total_samples}")
    if shard_idx is not None and not 0 <= shard_idx < shard_count:
        raise ValueError(f"{fn}: shard_idx {shard_idx} outside [0, {shard_count})")
    if not torch.is_tensor(sun_depth) or sun_depth.dim() != 2 or (
            sun_depth.shape[0] != sun_depth.shape[1]) or sun_depth.shape[0] < 1:
        raise ValueError(f"{fn}: sun_depth must be a square [S, S] map")
    cuda_build.need(sun_depth, "sun_depth", fn, dev)
    cuda_build.need(sun_space_from_world, "sun_space_from_world", fn, dev, shape=(4, 4))
    cuda_build.need(sun_dir, "sun_dir", fn, dev, shape=(3,))
    if torch.is_tensor(sun_emission):
        cuda_build.need(sun_emission, "sun_emission", fn, dev, shape=(3,))
    elif np.shape(sun_emission) != (3,):
        raise ValueError(f"{fn}: sun_emission must be a [3] tensor or 3 numbers")


def _emission(sun_emission, dev):
    """sun_emission as the plain version multiplies by it: the tensor, or 3
    numbers as a float32 tensor on dev."""
    if torch.is_tensor(sun_emission):
        return sun_emission
    return torch.as_tensor(np.asarray(sun_emission, np.float32), device=dev)


def _voxel_plan_for(scene, grid_size, lightgrid_scale, samples_per_voxel_area, total_samples,
                    plan, fn):
    """The call's plan: the one passed in, held to the call's scene and
    stream, or a new one (the scene's checks included)."""
    if plan is None:
        return _VoxelPlan(scene, grid_size, lightgrid_scale, samples_per_voxel_area,
                          total_samples)
    plan.check(scene, grid_size, lightgrid_scale, samples_per_voxel_area, total_samples, fn)
    return plan


def _voxel_args(plan, scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world,
                sun_dir, sun_emission, total_samples, texture_lod, shard_idx, shard_count):
    """The kernels' struct (the word grids and the output left null)."""
    s_len = total_samples // shard_count
    s = sun_depth.shape[0]
    base_h = scene.tex_packed.shape[1]
    levels = sampling.n_mip_levels(base_h, base_h)
    offs, wa = sampling.mip_offsets(base_h, base_h, levels)
    # the plain's lod: the f32 lod clamped to the levels, rounded half to even
    lv = int(np.rint(np.clip(np.float32(texture_lod), np.float32(0.0),
                             np.float32(levels - 1))))
    em = sun_emission if torch.is_tensor(sun_emission) else None
    em_val = np.zeros(3, np.float32) if em is not None else np.asarray(sun_emission, np.float32)
    f32 = np.float32
    return _VoxelArgs(
        offsets=plan.offsets32.data_ptr(), rows=plan.rows.data_ptr(),
        atlas=scene.tex_packed.data_ptr(), tex_scale=scene.tex_scale.data_ptr(),
        sun_depth=sun_depth.data_ptr(), sun_from_world=sun_space_from_world.data_ptr(),
        sun_dir=sun_dir.data_ptr(), emission_ptr=_ptr(em),
        emission=(ctypes.c_float * 3)(*em_val), scale=f32(lightgrid_scale),
        # PyTorch on the card: a tensor divided by a Python number is a
        # product with the number's f32 reciprocal (scale.repeat(4) / 255.0);
        # a Python quotient (1.0 / S, 1.0 / 65535.0) is a double made f32
        deq=f32(1.0) / f32(255.0), uv_bias=f32(1.0 / s), inv65535=f32(1.0 / 65535.0),
        inv255=f32(1.0 / 255.0), n_tris=plan.n_tris, total=plan.n_total,
        start=(shard_idx or 0) * s_len, s_len=s_len, grid_size=grid_size, sun_size=s,
        base_h=base_h, atlas_wa=wa, level_size=max(1, base_h >> lv), level_off=offs[lv],
        one_sample=int(plan.one_sample))


def voxelize_scene(scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world,
                   sun_dir, sun_emission, samples_per_voxel_area=4.0,
                   total_samples=1 << 20, texture_lod=4.0, shard_idx=None, shard_count=1,
                   plan=None):
    """voxelize_scene_plain's packed [D,D,D] int64 grid: the row-sharded
    frame's route, whose ranks' words meet in a max before the decode.  A
    CUDA scene launches csrc/voxelize.cu once (the grid zeroed by a memset
    in the same C call, then voxelize_kernel over the shard's samples), or
    raises; a CPU scene takes the plain version.  plan: the scene's
    _VoxelPlan (made here where None); a call with a plan checks only its
    sun inputs and shard, and that the plan is the scene's.  sun_emission:
    a [3] float32 tensor on the scene's device, or 3 numbers (as float32;
    no copy to the card).  `voxelize_scene.launches` counts launches."""
    fn = "voxelize_scene"
    plan = _voxel_plan_for(scene, grid_size, lightgrid_scale, samples_per_voxel_area,
                           total_samples, plan, fn)
    dev = scene.tri_attr.device
    _sun_check(dev, sun_depth, sun_space_from_world, sun_dir, sun_emission, total_samples,
               shard_idx, shard_count, fn)
    if not scene.tri_attr.is_cuda:
        return voxelize_scene_plain(
            scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world, sun_dir,
            sun_emission, samples_per_voxel_area, total_samples, texture_lod, shard_idx,
            shard_count)
    grid = torch.empty((grid_size,) * 3, dtype=torch.int64, device=dev)
    args = _voxel_args(plan, scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world,
                       sun_dir, sun_emission, total_samples, texture_lod, shard_idx,
                       shard_count)
    args.grid = grid.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _voxel_library().voxelize_launch(ctypes.byref(args), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"voxelize_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(_voxel_library(), err)})")
    voxelize_scene.launches += 1
    return grid


voxelize_scene.launches = 0


def voxelize_lightgrid(scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world,
                       sun_dir, sun_emission, samples_per_voxel_area=4.0,
                       total_samples=1 << 20, texture_lod=4.0, plan=None):
    """The frame's voxelize pass: the decoded [D,D,D,4] f32 lightgrid,
    decode_voxel_grid_plain(voxelize_scene_plain(...)).  A CUDA scene makes
    one cooperative launch of csrc/voxelize.cu's voxelize_pass_kernel (the
    samples' atomicMax into the plan's u32 word grid, zero between passes,
    then each word decoded and zeroed again, split by a grid-wide barrier),
    or raises; a CPU scene takes the plain chain.  plan, sun_emission: as
    voxelize_scene (a plan's word grid serves the stream of its first pass
    alone: ValueError on another).  `voxelize_lightgrid.launches` counts
    launches."""
    fn = "voxelize_lightgrid"
    plan = _voxel_plan_for(scene, grid_size, lightgrid_scale, samples_per_voxel_area,
                           total_samples, plan, fn)
    dev = scene.tri_attr.device
    _sun_check(dev, sun_depth, sun_space_from_world, sun_dir, sun_emission, total_samples,
               None, 1, fn)
    if not scene.tri_attr.is_cuda:
        return decode_voxel_grid_plain(voxelize_scene_plain(
            scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world, sun_dir,
            sun_emission, samples_per_voxel_area, total_samples, texture_lod))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.words is None:
        plan.words = torch.zeros((grid_size,) * 3, dtype=torch.int32, device=dev)
        plan.words_stream = stream
    elif stream != plan.words_stream:
        raise ValueError(f"{fn}: the plan's word grid serves stream {plan.words_stream:#x}, "
                         f"not {stream:#x}: make a plan for each stream")
    out = torch.empty((grid_size,) * 3 + (4,), dtype=torch.float32, device=dev)
    args = _voxel_args(plan, scene, grid_size, lightgrid_scale, sun_depth, sun_space_from_world,
                       sun_dir, sun_emission, total_samples, texture_lod, None, 1)
    args.words, args.out = plan.words.data_ptr(), out.data_ptr()
    err = _voxel_library().voxelize_pass_launch(ctypes.byref(args), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"voxelize_pass_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(_voxel_library(), err)})")
    voxelize_lightgrid.launches += 1
    return out


voxelize_lightgrid.launches = 0


def decode_voxel_grid(packed):
    """decode_voxel_grid_plain's [..., 4] f32 grid of packed int64 words.  A
    CUDA tensor launches csrc/voxelize.cu's decode_voxel_kernel once (a
    thread a voxel, 16-byte stores), or raises; a CPU tensor takes the
    plain version.  `decode_voxel_grid.launches` counts launches."""
    fn = "decode_voxel_grid"
    if not torch.is_tensor(packed) or packed.dtype != torch.int64:
        raise ValueError(f"{fn}: packed must be an int64 tensor")
    if not packed.is_cuda:
        return decode_voxel_grid_plain(packed)
    if not packed.is_contiguous():
        raise ValueError(f"{fn}: packed must be contiguous")
    out = torch.empty(packed.shape + (4,), dtype=torch.float32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = _voxel_library().decode_voxel_launch(
        packed.data_ptr(), out.data_ptr(), packed.numel(), float(np.float32(1.0 / 255.0)),
        packed.device.index, stream)
    if err != 0:
        raise RuntimeError(f"decode_voxel_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(_voxel_library(), err)})")
    decode_voxel_grid.launches += 1
    return out


decode_voxel_grid.launches = 0


class _VoxelArgs(ctypes.Structure):
    """struct VoxelArgs of csrc/voxelize.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "offsets", "rows", "atlas", "tex_scale", "sun_depth", "sun_from_world", "sun_dir",
        "emission_ptr", "grid", "words", "out")] + [("emission", ctypes.c_float * 3)] + [
        (n, ctypes.c_float) for n in ("scale", "deq", "uv_bias", "inv65535", "inv255")] + [
        (n, ctypes.c_int) for n in ("n_tris", "total", "start", "s_len", "grid_size",
                                    "sun_size", "base_h", "atlas_wa", "level_size",
                                    "level_off", "one_sample")]


@functools.cache
def _voxel_library():
    """The built voxelize library (csrc/voxelize.cu)."""
    lib = cuda_build.load_library("voxelize")
    lib.voxelize_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.voxelize_launch.restype = ctypes.c_int
    lib.decode_voxel_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.decode_voxel_launch.restype = ctypes.c_int
    lib.voxelize_pass_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.voxelize_pass_launch.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# grid packs and samplers


def quantize_grid_u8(grid):
    """[D,H,W,4] grid -> uint8 [D,H,W,4] levels: rgb stored as
    c = sqrt(x/(1+x)), alpha raw, both round(v*255) clipped to 254.  These
    are the corners pack_grid_u8 stores, and the alpha channel is the level
    pack_grid_alpha_u16 stores, so one table serves every fetch of the fast
    GI (read by sampling.sample_trilinear_table)."""
    rgb = torch.clamp(grid[..., :3], min=0.0)
    q = torch.cat([m3.sqrt(rgb / (1.0 + rgb)), grid[..., 3:4]], -1)
    return torch.clamp(torch.round(q * 255.0), 0.0, 254.0).to(torch.uint8)


def pack_grid_u8(grid):
    """[D,H,W,4] grid -> uint8 2x2x2 window pack [D,H,W,32] of
    quantize_grid_u8's levels."""
    return sampling.window_pack3d(quantize_grid_u8(grid))


def pack_grid_alpha_u16(grid):
    """[D,H,W,4] grid -> alpha-only 2x2x2 window pack [D,H,W,8], quantized as
    pack_grid_u8's alpha (levels 0..254, stored as int16)."""
    a = torch.clamp(torch.round(grid[..., 3:4] * 255.0), 0.0, 254.0).to(torch.int16)
    return sampling.window_pack3d(a)


def pack_grid_f16_nearest(grid):
    """[D,H,W,4] grid -> f16 rgba for nearest-sampled marches."""
    return grid.to(torch.float16)


def _sample_nearest_grid(fgrid, ro):
    """One rgba voxel at grid-NDC ro (uvw = ro*0.5+0.5), nearest, clamped."""
    d, h, w = fgrid.shape[:3]
    uvw = ro * 0.5 + 0.5
    iz = sampling._clamp_index(torch.trunc(uvw[..., 2] * d), d)
    iy = sampling._clamp_index(torch.trunc(uvw[..., 1] * h), h)
    ix = sampling._clamp_index(torch.trunc(uvw[..., 0] * w), w)
    flat = fgrid.reshape(d * h * w, -1)
    return sampling.take_rows(flat, (iz * h + iy) * w + ix).to(torch.float32)


def _decode_grid_u8(v):
    """Per-corner decode of pack_grid_u8 values (as f32) -> radiance +
    alpha; runs BEFORE the trilinear lerp."""
    s = v * (1.0 / 255.0)
    c2 = s[..., :3] * s[..., :3]
    rgb = c2 / torch.clamp(1.0 - c2, min=1.0 / 256.0)
    return torch.cat([rgb, s[..., 3:]], -1)


def _decode_alpha(v):
    return v * (1.0 / 255.0)


def _is_table_u8(vol):
    return vol.dtype == torch.uint8 and vol.shape[-1] == 4


def _gs_uvw(vol, uvw):
    """Trilinear fetch of a raw [D,H,W,4] grid, a [D,H,W,32] window pack
    (uint8 packs decoded per corner) or a quantize_grid_u8 table."""
    if _is_table_u8(vol):
        return sampling.sample_trilinear_table(vol, uvw, decode=_decode_grid_u8)
    if vol.shape[-1] == 32:
        if vol.dtype == torch.uint8:
            return sampling.sample_trilinear_window(vol, uvw, 4, decode=_decode_grid_u8)
        return sampling.sample_trilinear_window(vol, uvw, 4)
    return sampling.sample_trilinear_3d(vol, uvw)


def grid_sample(grid, ro_grid):
    """Trilinear lightgrid fetch at grid-NDC position ro (uvw = ro*0.5+0.5)."""
    return _gs_uvw(grid, ro_grid * 0.5 + 0.5)


def _alpha_uvw(agrid, uvw):
    """Trilinear alpha at uvw from a pack_grid_alpha_u16 table or the alpha
    channel of a quantize_grid_u8 table (the same levels)."""
    if _is_table_u8(agrid):
        return sampling.sample_trilinear_table(agrid, uvw, decode=_decode_alpha,
                                               channels=[3])[..., 0]
    return sampling.sample_trilinear_window(agrid, uvw, 1, decode=_decode_alpha)[..., 0]


def _sample_alpha_u16(agrid, ro):
    """Trilinear alpha at grid-NDC ro from a pack_grid_alpha_u16 table."""
    return _alpha_uvw(agrid, ro * 0.5 + 0.5)


def _count(work, key, mask, per=1):
    """Add `per` to work[key], an int32 count per lane of the lanes' shape,
    for each lane of `mask`: no host sync."""
    if work is not None:
        work[key] = work.get(key, 0) + mask.to(torch.int32) * per


def _tone(sum4):
    """sum/=w then luminance-sqrt compression (glsl:267-270)."""
    mean = sum4[..., :3] / torch.clamp(sum4[..., 3:4], min=1e-4)
    return colorlib.tone_compress_sqrt(mean)


# ---------------------------------------------------------------------------
# 3. Marches


def sample_radiance_fog(fgrid, ro_world, rd_unit, lightgrid_scale, skip_steps=4,
                        open_thresh=0.3, march_steps=8, hit_thresh=0.3, step_scale=1.0,
                        foggyness=0.5, noise=None, trilinear_grid=None, jitter_scale=1.0,
                        work=None):
    """Phase A + phase C of the reference march (lighting_pass.glsl:280-288,
    399-418): skip the initial blockage (the first voxel with alpha <
    open_thresh seeds the sum), then fog-march, folding each open voxel into
    sum = sum*foggyness + (rgb, 1) until a voxel with alpha > hit_thresh
    stops the lane.  Samples the nearest f16 grid `fgrid`, or trilinearly the
    u8 window pack or quantize_grid_u8 table `trilinear_grid` when given
    (fgrid may then be None).  foggyness is a scalar or a per-lane tensor.
    noise jitters the march start by jitter_scale march steps.  work: an
    optional dict that gathers each lane's count of its live skip and march
    steps ("skip", "march"; int32 of the lanes' shape, on the device).
    Returns (rgb, ro_open, ro_stop, hit & found, found)."""
    table = trilinear_grid if trilinear_grid is not None else fgrid
    voxel = 2.0 / table.shape[0]
    rd = rd_unit * voxel
    ro = ro_world * lightgrid_scale
    if trilinear_grid is None:
        def fetch(p):
            return _sample_nearest_grid(fgrid, p)
    else:
        def fetch(p):
            return grid_sample(trilinear_grid, p)

    found = torch.zeros(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    seed = torch.zeros(ro.shape[:-1] + (3,), dtype=torch.float32, device=ro.device)
    ro_c = ro
    for _ in range(skip_steps):
        _count(work, "skip", ~found)
        ro_c = torch.where(found[..., None], ro_c, ro_c + rd)
        s = fetch(ro_c)
        newly = ~found & (s[..., 3] < open_thresh)
        seed = torch.where(newly[..., None], s[..., :3], seed)
        found = found | newly
    ro_open = ro_c

    sum4 = torch.cat([seed, found[..., None].to(torch.float32) + 1e-4], -1)
    rdm = rd * step_scale
    ro_c = ro_open if noise is None else ro_open + rdm * (jitter_scale * noise[..., None])
    fog = foggyness[..., None] if torch.is_tensor(foggyness) else foggyness
    hit = torch.zeros_like(found)
    for _ in range(march_steps):
        live = found & ~hit
        _count(work, "march", live)
        ro_c = torch.where(live[..., None], ro_c + rdm, ro_c)
        s = fetch(ro_c)
        hits = s[..., 3] > hit_thresh
        open_live = live & ~hits
        add = torch.cat([s[..., :3], torch.ones_like(s[..., 3:])], -1)
        sum4 = torch.where(open_live[..., None], sum4 * fog + add, sum4)
        hit = hit | (hits & live)
    rgb = torch.where(found[..., None], _tone(sum4), 0.0)
    return rgb, ro_open, ro_c, hit & found, found


def screen_trace_linear(depth_tex, alpha_grid, p0_vs, open_vs, clip_from_view,
                        world_from_view, lightgrid_scale, noise_01, steps=16, rounds=2,
                        steps2=6, solid_taps=3, work=None):
    """The bounded linear screen trace of the fast GI (gi.py:915-1104, the
    reference's lighting_pass.glsl:301-397): the lane marches the travelled
    distance s in |to_open.xy|-normalized units, the step growing 1.2x
    before each depth fetch, and freezes at its first depth crossing
    (|surface|^2 < |ray|^2 in view space, surface depth by the closed-form
    inverse z = P23/(d - P22)).  After each round the crossing's lightgrid
    solidity is tested once per frozen lane: solid resolves, translucent
    re-arms with the (2+noise)x boosted step for `steps2` more steps.

    Returns (status, res_uv, res_slen): status 2 = fall through to the march
    result, 1 = off-screen fallback, 3 = screen-resolved (sample the previous
    frame at res_uv, lod res_slen*5).  Loop counts are static Python ints.
    alpha_grid: a pack_grid_alpha_u16 table or a quantize_grid_u8 table.
    work: as sample_radiance_fog's, for the marching lanes of each step
    ("trace") and the solidity taps ("taps")."""
    to_open = open_vs - p0_vs
    step_len0 = torch.clamp(p0_vs[..., 2], min=1.0) * (1.0 + noise_01) / 100.0
    xy_len = m3.sqrt(to_open[..., 0] * to_open[..., 0]
                     + to_open[..., 1] * to_open[..., 1])
    ss_dir = to_open / torch.clamp(xy_len, min=1e-8)[..., None]
    dist_to_travel = _norm3(to_open)

    m = clip_from_view
    p00, p11, p22, p23 = m[0, 0], m[1, 1], m[2, 2], m[2, 3]
    inv00 = 1.0 / (p00 * p00)
    inv11 = 1.0 / (p11 * p11)
    c0x, cdx = p00 * p0_vs[..., 0], p00 * ss_dir[..., 0]
    c0y, cdy = p11 * p0_vs[..., 1], p11 * ss_dir[..., 1]
    c0w, cdw = p0_vs[..., 2], ss_dir[..., 2]

    def dot3(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    a2 = dot3(p0_vs, p0_vs)
    b2 = 2.0 * dot3(p0_vs, ss_dir)
    c2 = dot3(ss_dir, ss_dir)

    slen = step_len0
    trav = torch.zeros_like(step_len0)
    # 0 marching, 1 offscreen-fallback, 2 exhausted, 3 resolved,
    # 4 frozen at a depth crossing (solidity pending)
    status = torch.zeros(step_len0.shape, dtype=torch.int32, device=step_len0.device)
    res_uv = torch.zeros(step_len0.shape + (2,), dtype=torch.float32,
                         device=step_len0.device)
    res_d = torch.ones_like(step_len0)

    def step(slen, trav, status, res_uv, res_d):
        active = status == 0
        _count(work, "trace", active)
        s = torch.where(active, trav + slen, trav)
        cx = c0x + s * cdx
        cy = c0y + s * cdy
        cw = c0w + s * cdw
        iw = 1.0 / torch.where(torch.abs(cw) < 1e-8, 1e-8, cw)
        nx = cx * iw
        ny = cy * iw
        offscreen = (torch.maximum(torch.abs(nx), torch.abs(ny)) > 1.0) & active
        status = torch.where(offscreen, 1, status)
        slen = torch.where(active, slen * 1.2, slen)
        uv = torch.stack([nx * 0.5 + 0.5, ny * 0.5 + 0.5], -1)
        d = sampling.sample_nearest(depth_tex, uv)
        zv = p23 / (d - p22)          # d <= 1 < P22: the denominator is < 0
        surf2 = zv * zv * (nx * nx * inv00 + ny * ny * inv11 + 1.0)
        pos2 = a2 + (b2 + c2 * s) * s
        hit = (surf2 < pos2) & active & ~offscreen
        status = torch.where(hit, 4, status)
        res_uv = torch.where(hit[..., None], uv, res_uv)
        res_d = torch.where(hit, d, res_d)
        done = (s > dist_to_travel) & active & ~offscreen & ~hit
        status = torch.where(done, 2, status)
        return slen, s, status, res_uv, res_d

    fracs = ((0.2, 0.4, 0.6) if solid_taps >= 3 else
             (0.4,) if solid_taps == 1 else (0.3, 0.5))
    noff = noise_01 * 0.2

    def solidity(slen, trav, status, res_uv, res_d):
        pending = status == 4
        _count(work, "taps", pending, len(fracs))
        pos = p0_vs + ss_dir * trav[..., None]
        rn = res_uv * 2.0 - 1.0
        rzv = p23 / (res_d - p22)
        surf_vs = torch.stack([rn[..., 0] * rzv / p00, rn[..., 1] * rzv / p11, rzv], -1)
        t_start = (m3.transform_points(world_from_view, surf_vs)[..., :3]
                   * (lightgrid_scale * 0.5) + 0.5)
        t_end = (m3.transform_points(world_from_view, pos)[..., :3]
                 * (lightgrid_scale * 0.5) + 0.5)
        asum = 0.0
        for k in fracs:
            mixk = t_start + (t_end - t_start) * (noff + k)[..., None]
            asum = asum + _alpha_uvw(alpha_grid, mixk)
        solid = asum >= 0.5 * len(fracs)
        boost = pending & ~solid
        status = torch.where(pending & solid, 3, torch.where(boost, 0, status))
        slen = torch.where(boost, slen * (2.0 + noise_01), slen)
        return slen, trav, status, res_uv, res_d

    st = (slen, trav, status, res_uv, res_d)
    for _ in range(steps):
        st = step(*st)
    st = solidity(*st)
    for _ in range(max(0, rounds - 1)):
        for _ in range(steps2):
            st = step(*st)
        st = solidity(*st)
    slen, _, status, res_uv, _ = st
    # lanes still marching at the budget fall through to the voxel march
    return torch.where(status == 0, 2, status), res_uv, slen


# ---------------------------------------------------------------------------
# 3b. One fast-GI ray: march, trace and resolve (the JAX package's
#     gi_modes.py:229-291, the "trace" branch), and its CUDA kernel


class RayParams(NamedTuple):
    """The scalars of one fast-GI ray (RenderConfig's values; ray_params
    builds them)."""
    lightgrid_scale: float
    voxel_step: float        # 2 / lightgrid_size: the fallback's camera-ward unit
    skip_steps: int
    open_thresh: float
    march_steps: int
    step_scale: float
    jitter_scale: float
    ss_intensity: float
    screen: bool             # the screen term: trace + resolve
    trace_steps: int
    trace_rounds: int
    trace_steps2: int
    solid_taps: int
    prev_h: int              # the previous-frame pyramid's level 0
    prev_w: int
    prev_levels: int
    fog_march: bool = True   # False: the wave-9 march (no kernel)
    rgb_samples: int = 2     # its rgb samples


def ray_params(cfg, march_steps, step_scale, ss_intensity, prev_h, prev_w):
    """RayParams of one ray of the fast GI under `cfg` (the fog march, or
    the wave-9 march where cfg.gi_fast_fog_march is False)."""
    return RayParams(
        lightgrid_scale=cfg.lightgrid_scale, voxel_step=2.0 / cfg.lightgrid_size,
        skip_steps=cfg.gi_fast_skip_steps, open_thresh=cfg.gi_fast_open_thresh,
        march_steps=march_steps, step_scale=step_scale,
        jitter_scale=cfg.gi_fast_jitter_scale, ss_intensity=ss_intensity,
        screen=cfg.gi_fast_screen_probe, trace_steps=cfg.gi_trace_steps,
        trace_rounds=cfg.gi_trace_rounds, trace_steps2=cfg.gi_trace_steps2,
        solid_taps=cfg.gi_trace_solid_taps, prev_h=prev_h, prev_w=prev_w,
        prev_levels=cfg.bloom_pass_count, fog_march=cfg.gi_fast_fog_march,
        rgb_samples=cfg.gi_fast_samples)


def fast_ray_resolve_plain(table, fgrid, trace_tbl, prev_atlas, view_from_world,
                           clip_from_view, world_from_view, camera_pos, pw, rd_unit, pv, noise,
                           foggyness, rp, work=None):
    """The fast-GI radiance of one ray per lane: the fog march
    (sample_radiance_fog; with rp.fog_march False the wave-9 march
    sample_radiance_march) from world position pw along rd_unit, then, with
    rp.screen, the camera-ward lightgrid fallback, the linear screen trace
    from view position pv toward the march's open point
    (screen_trace_linear) and the previous-frame pyramid at the resolved uv.

    table: quantize_grid_u8 [D,H,W,4] (the trilinear march, the fallback and
    the solidity taps); fgrid: pack_grid_f16_nearest [D,H,W,4] for the
    nearest march, or None for the trilinear one; trace_tbl [Ht,Wt] f32;
    prev_atlas [H/2,Wa,3] bf16.  pw, rd_unit, pv [...,3] f32; noise [...]
    f32; foggyness a float or [...] f32; rp a RayParams.  work: as
    sample_radiance_fog's, plus the fallback fetches ("fallback") and the
    pyramid samples ("resolve").

    Returns (rgb [...,3] f32, status [...] int32): 1 the off-screen
    fallback, 3 resolved on screen, 2 the march result (always 2 without the
    screen term)."""
    scale = rp.lightgrid_scale
    if rp.fog_march:
        rgb, ro_open, _, _, _ = sample_radiance_fog(
            fgrid, pw, rd_unit, scale, skip_steps=rp.skip_steps, open_thresh=rp.open_thresh,
            march_steps=rp.march_steps, step_scale=rp.step_scale, noise=noise,
            foggyness=foggyness, trilinear_grid=table if fgrid is None else None,
            jitter_scale=rp.jitter_scale, work=work)
    else:
        rgb, ro_open, _, _, _ = sample_radiance_march(
            table, table, pw, rd_unit, scale, skip_steps=rp.skip_steps,
            open_thresh=rp.open_thresh, hit_steps=rp.march_steps, step_scale=rp.step_scale,
            noise=noise, rgb_samples=rp.rgb_samples, work=work)
    if not rp.screen:
        return rgb, torch.full(pw.shape[:-1], 2, dtype=torch.int32, device=pw.device)
    open_vs = m3.transform_points(view_from_world, ro_open / scale)[..., :3]
    v_cam = m3.normalize(camera_pos - pw)
    fb = grid_sample(table, pw * scale + 2.5 * v_cam * rp.voxel_step)
    fb_rgb = colorlib.tone_compress_sqrt(fb[..., :3])
    status, res_uv, res_slen = screen_trace_linear(
        trace_tbl, table, pv, open_vs, clip_from_view, world_from_view, scale, noise,
        steps=rp.trace_steps, rounds=rp.trace_rounds, steps2=rp.trace_steps2,
        solid_taps=rp.solid_taps, work=work)
    lod = torch.clamp(res_slen * 5.0, max=5.0)
    prev = sampling.sample_mip_atlas(prev_atlas, rp.prev_h, rp.prev_w, res_uv, lod,
                                     levels=rp.prev_levels)[..., :3]
    _count(work, "fallback", status == 1)
    _count(work, "resolve", status == 3)
    rgb = torch.where((status == 1)[..., None], fb_rgb, rgb)
    return torch.where((status == 3)[..., None], prev * rp.ss_intensity, rgb), status


def _check_ray_inputs(table, fgrid, trace_tbl, prev_atlas, mats, camera_pos, pw, rd_unit, pv,
                      noise, foggyness, rp):
    """Raise ValueError unless the inputs are what the kernel takes."""
    dev = pw.device

    def need(t, what, dtype, shape=None):
        if not torch.is_tensor(t) or t.dtype != dtype or t.device != dev:
            raise ValueError(f"fast_ray_resolve: {what} must be a {dtype} tensor on {dev}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"fast_ray_resolve: {what} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fast_ray_resolve: {what} must be contiguous")

    if pw.dim() < 1 or pw.shape[-1] != 3:
        raise ValueError(f"fast_ray_resolve: pw must be [..., 3], got {tuple(pw.shape)}")
    for t, what in ((pw, "pw"), (rd_unit, "rd_unit"), (pv, "pv")):
        need(t, what, torch.float32, pw.shape)
    need(noise, "noise", torch.float32, pw.shape[:-1])
    if torch.is_tensor(foggyness):
        need(foggyness, "foggyness", torch.float32, pw.shape[:-1])
    if table.dim() != 4 or table.shape[-1] != 4:
        raise ValueError(f"fast_ray_resolve: table must be [D,H,W,4], got {tuple(table.shape)}")
    need(table, "table", torch.uint8)
    if fgrid is not None:
        need(fgrid, "fgrid", torch.float16, table.shape)
    for t, what in zip(mats, ("view_from_world", "clip_from_view", "world_from_view")):
        need(t, what, torch.float32, (4, 4))
    need(camera_pos, "camera_pos", torch.float32, (3,))
    if rp.screen:
        if trace_tbl is None or trace_tbl.dim() != 2:
            raise ValueError("fast_ray_resolve: trace_tbl must be [Ht, Wt]")
        need(trace_tbl, "trace_tbl", torch.float32)
        if not 1 <= rp.prev_levels <= MAX_LEVELS:
            raise ValueError(f"fast_ray_resolve: the pyramid has {rp.prev_levels} levels; the "
                             f"kernel takes 1 to {MAX_LEVELS}")
        _, wa = sampling.mip_offsets(rp.prev_h, rp.prev_w, rp.prev_levels)
        if (prev_atlas is None or prev_atlas.dim() != 3 or prev_atlas.shape[0] < rp.prev_h
                or prev_atlas.shape[1] < wa or prev_atlas.shape[2] != 3):
            raise ValueError(f"fast_ray_resolve: prev_atlas must be [>={rp.prev_h}, >={wa}, "
                             f"3] for the pyramid of {rp.prev_levels} levels")
        need(prev_atlas, "prev_atlas", torch.bfloat16)


def fast_ray_resolve(table, fgrid, trace_tbl, prev_atlas, view_from_world, clip_from_view,
                     world_from_view, camera_pos, pw, rd_unit, pv, noise, foggyness, rp):
    """fast_ray_resolve_plain's function.  The inputs are checked first
    (ValueError); then a CUDA tensor launches the kernel
    csrc/gi_fast_ray.cu (or raises) and a CPU tensor takes the plain version.
    No host sync: the matrices and the camera position stay on the device.
    `fast_ray_resolve.launches` counts kernel launches, one per call."""
    mats = (view_from_world, clip_from_view, world_from_view)
    _check_ray_inputs(table, fgrid, trace_tbl, prev_atlas, mats, camera_pos, pw, rd_unit, pv,
                      noise, foggyness, rp)
    if not pw.is_cuda:
        return fast_ray_resolve_plain(table, fgrid, trace_tbl, prev_atlas, *mats, camera_pos,
                                      pw, rd_unit, pv, noise, foggyness, rp)
    if not rp.fog_march:
        raise ValueError("fast_ray_resolve: the wave-9 march (rp.fog_march False) has no "
                         "kernel; fast_ray_resolve_plain runs it")
    out = run_fast_ray(_ray_library(), table, fgrid, trace_tbl, prev_atlas, mats, camera_pos,
                       pw, rd_unit, pv, noise, foggyness, rp)
    fast_ray_resolve.launches += 1
    return out


fast_ray_resolve.launches = 0


class _RayArgs(ctypes.Structure):
    """struct RayArgs of csrc/gi_fast_ray.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "table", "fgrid", "depth", "atlas", "view_from_world", "clip_from_view",
        "world_from_view", "camera_pos", "pw", "rd", "pv", "noise", "fog_lane", "out_rgb",
        "out_status")] + [(n, ctypes.c_float) for n in (
            "fog", "scale", "inv_scale", "voxel", "voxel_step", "open_thresh", "step_scale",
            "jitter_scale", "ss_intensity", "half_scale")] + [(n, ctypes.c_int) for n in (
                "n", "gd", "gh", "gw", "th", "tw", "atlas_wa", "prev_h", "prev_w",
                "prev_levels", "skip_steps", "march_steps", "screen", "trace_steps",
                "trace_rounds", "trace_steps2", "solid_taps", "width", "tile_h")]


def _ptr(t):
    return None if t is None else t.data_ptr()


def run_fast_ray(lib, table, fgrid, trace_tbl, prev_atlas, mats, camera_pos, pw, rd_unit, pv,
                 noise, foggyness, rp, tile_h=None):
    """Launch a built gi_fast_ray library on checked CUDA inputs, on the
    current stream with no host sync.  tile_h: the rows of a warp's lane
    tile (lane_tile_h's choice by default).  Returns (rgb, status)."""
    if table.data_ptr() % 4 or (fgrid is not None and fgrid.data_ptr() % 8):
        raise ValueError("fast_ray_resolve: the kernel reads a grid texel as one aligned word: "
                         "table must be 4-byte and fgrid 8-byte aligned")
    n = pw.numel() // 3
    rows, width = lane_grid(pw.shape[:-1])
    if tile_h is None:
        tile_h = lane_tile_h(rows)
    rgb = torch.empty(pw.shape, dtype=torch.float32, device=pw.device)
    status = torch.empty(pw.shape[:-1], dtype=torch.int32, device=pw.device)
    fog_lane = foggyness if torch.is_tensor(foggyness) else None
    screen = bool(rp.screen)
    args = _RayArgs(
        table=_ptr(table), fgrid=_ptr(fgrid), depth=_ptr(trace_tbl) if screen else None,
        atlas=_ptr(prev_atlas) if screen else None, view_from_world=_ptr(mats[0]),
        clip_from_view=_ptr(mats[1]), world_from_view=_ptr(mats[2]),
        camera_pos=_ptr(camera_pos), pw=_ptr(pw), rd=_ptr(rd_unit), pv=_ptr(pv),
        noise=_ptr(noise), fog_lane=_ptr(fog_lane), out_rgb=_ptr(rgb), out_status=_ptr(status),
        fog=0.0 if fog_lane is not None else float(foggyness), scale=rp.lightgrid_scale,
        # PyTorch on the card divides by a Python number as a product with its
        # f32 reciprocal (ro_open / scale, (..) / 100.0): the kernel does too
        inv_scale=float(np.float32(1.0) / np.float32(rp.lightgrid_scale)),
        voxel=2.0 / table.shape[0], voxel_step=rp.voxel_step, open_thresh=rp.open_thresh,
        step_scale=rp.step_scale, jitter_scale=rp.jitter_scale, ss_intensity=rp.ss_intensity,
        half_scale=rp.lightgrid_scale * 0.5, n=n, gd=table.shape[0], gh=table.shape[1],
        gw=table.shape[2], th=trace_tbl.shape[0] if screen else 0,
        tw=trace_tbl.shape[1] if screen else 0,
        atlas_wa=prev_atlas.shape[1] if screen else 0, prev_h=rp.prev_h, prev_w=rp.prev_w,
        prev_levels=rp.prev_levels, skip_steps=rp.skip_steps, march_steps=rp.march_steps,
        screen=int(screen), trace_steps=rp.trace_steps, trace_rounds=rp.trace_rounds,
        trace_steps2=rp.trace_steps2, solid_taps=rp.solid_taps, width=max(width, 1),
        tile_h=tile_h)
    with torch.cuda.device(pw.device):
        err = lib.gi_fast_ray_launch(ctypes.byref(args),
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gi_fast_ray kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return rgb, status


def _ray_library(defines=(), source=None):
    """The built gi_fast_ray library (with `defines`, a variant's -D values;
    from `source`, another tree's csrc/gi_fast_ray.cu, if given)."""
    lib = cuda_build.load_library("gi_fast_ray", tuple(defines), source)
    lib.gi_fast_ray_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gi_fast_ray_launch.restype = ctypes.c_int
    return lib


def ray_kernel_occupancy(lib=None):
    """(registers a thread, resident blocks an SM, threads a block) of a
    built gi_fast_ray library's kernel on the current card."""
    lib = lib or _ray_library()
    regs, blocks, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fn = lib.gi_fast_ray_occupancy
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(regs), ctypes.byref(blocks), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"gi_fast_ray occupancy query failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return regs.value, blocks.value, threads.value


# ---------------------------------------------------------------------------
# 3c. The kernel's lane order: warp tiles of the lane grid


TILE_H = 8            # rows of a warp's lane tile: 8 x 4 lanes
MAX_LEVELS = 16       # the pyramid levels the kernel keeps offsets for


def lane_grid(lane_shape):
    """(rows, width) of the lanes' grid: the last lane dimension is a row
    (a 1-D lane tensor is one row); the leading ones stack rows."""
    n = math.prod(lane_shape)
    if len(lane_shape) < 2:
        return (1 if n else 0), n
    width = int(lane_shape[-1])
    return (n // width if width else 0), width


def lane_tile_h(rows, tile_h=TILE_H):
    """The rows of a warp's lane tile for a grid of `rows` rows: tile_h,
    halved until it is no taller than the grid."""
    while tile_h > 1 and tile_h > rows:
        tile_h //= 2
    return tile_h


def lane_tiles(rows, width, tile_h):
    """[tiles, 32] int64 flat lane indices of the kernel's warp tiles: tile
    t covers rows (t // tiles_x) * tile_h + slot // (32 // tile_h) and
    columns (t % tiles_x) * (32 // tile_h) + slot % (32 // tile_h); -1 where
    a tile runs past the grid's edge.  Its valid entries are a permutation
    of range(rows * width)."""
    tw = 32 // tile_h
    tiles_x, tiles_y = -(-width // tw), -(-rows // tile_h)
    t = torch.arange(tiles_x * tiles_y)[:, None]
    slot = torch.arange(32)[None, :]
    row = (t // tiles_x) * tile_h + slot // tw
    col = (t % tiles_x) * tw + slot % tw
    return torch.where((row < rows) & (col < width), row * width + col, -1)


def simt_efficiency(lane_work, tiles):
    """The share of a warp's lane slots that do work, for lanes taken in
    `tiles` ([tiles, 32] lane indices, -1 empty): per-lane step counts
    (the `work` of fast_ray_resolve_plain) summed over the step kinds,
    over 32 x the sum over tiles and kinds of the tile's longest lane.  A
    kernel that runs each kind's loop until its longest lane is done issues
    that many steps."""
    done, issued = 0, 0
    for kind in ("skip", "march", "trace", "taps"):
        if kind in lane_work:
            d, i = _issued(lane_work[kind], tiles)
            done, issued = done + d, issued + i
    return done / issued if issued else 1.0


def _issued(counts, warps):
    """(steps done, lane slots issued) of per-lane step counts [n] run by
    warps ([warps, 32] lane indices, -1 empty), each to its longest lane."""
    counts = torch.cat([counts.reshape(-1).to(torch.int64), counts.new_zeros(1, dtype=torch.int64)])
    per_slot = counts[warps.to(counts.device)]                         # slot -1 reads 0
    return int(per_slot.sum()), 32 * int(per_slot.amax(-1).sum()) if len(per_slot) else 0


def compact_tiles(mask, tiles, block_tiles):
    """[warps, 32] lane indices of a block queue's drain: the lanes of
    `tiles` ([tiles, 32], -1 empty) where `mask` holds, block by block
    (`block_tiles` consecutive tiles a block), in tile then slot order,
    each block's run cut into warps of 32 (-1 past its end); blocks with
    no such lane give no warp."""
    pad = (-tiles.shape[0]) % block_tiles
    flat = torch.cat([tiles, tiles.new_full((pad, 32), -1)]).reshape(-1, block_tiles * 32)
    m = torch.cat([mask.reshape(-1).to(torch.bool), mask.new_zeros(1, dtype=torch.bool)])
    keep = m[flat.to(m.device)].cpu()
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    packed = torch.where(torch.gather(keep, 1, order), torch.gather(flat, 1, order), -1)
    warps = packed.reshape(-1, 32)
    return warps[warps[:, 0] >= 0]


REF_PHASES = ("skip", "trace", "taps", "march")
REF_BLOCK_TILES = 4   # csrc/gi_reference_ray.cu's warp tiles a block (kThreads / 32)


def reference_simt(lane_work, tiles, queue=False):
    """Per-phase SIMT efficiency of reference-GI lanes (the `work` counts of
    reference_ray_resolve_plain) and of all four together ("all"): steps
    done over 32 x the steps the warps issue, each warp running each loop
    to its longest lane, each lane in its tile's warp (`tiles`,
    gi.lane_tiles).  queue=False: the first design, three alpha taps a
    crossing.  queue=True: csrc/gi_reference_ray.cu, whose blocks of
    REF_BLOCK_TILES tiles drain the lanes that march (an open sample
    fetched) from a queue 32 a warp (compact_tiles), and whose crossings
    take the taps the outcome needs ("taps").  A model: the kernel's queue
    takes the warps in the order they arrive, not always the tiles'."""
    out, done, issued = {}, 0, 0
    for kind in REF_PHASES:
        counts = lane_work[kind].reshape(-1).to(torch.int64)
        warps = tiles
        if kind == "taps" and not queue:
            counts = 3 * lane_work["crossing"].reshape(-1).to(torch.int64)
        if kind == "march" and queue:
            warps = compact_tiles(lane_work["seed"] > 0, tiles, REF_BLOCK_TILES)
        d, i = _issued(counts, warps)
        out[kind] = d / i if i else 1.0
        done, issued = done + d, issued + i
    out["all"] = done / issued if issued else 1.0
    return out


# ---------------------------------------------------------------------------
# 4. The reference march (gi.py:560-639, 1504-1692)


def _skip_blockage(grid, ro, rd, steps, open_thresh, alpha_grid=None, work=None):
    """Advance until the first non-solid voxel (glsl:243-251 / 280-288).
    Returns (ro_after, sum4, found): sum4 holds (rgb, 1) of the first open
    sample plus 1e-4 in w, so sum4.w stays ~0 where no opening was found.

    With alpha_grid (pack_grid_alpha_u16) the march reads the alpha-only
    rows and fetches one rgb row at the stop position, which is the
    first-open sample point (ro freezes once found): the same result.
    work: as sample_radiance_fog's, the live steps ("skip")."""
    found = torch.zeros(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    if alpha_grid is not None:
        for _ in range(steps):
            _count(work, "skip", ~found)
            ro = torch.where(found[..., None], ro, ro + rd)
            found = found | (_sample_alpha_u16(alpha_grid, ro) < open_thresh)
        s = grid_sample(grid, ro)
        sum4 = torch.cat([torch.where(found[..., None], s[..., :3], 0.0),
                          1e-4 + found[..., None].to(ro.dtype)], -1)
        return ro, sum4, found
    sum4 = torch.zeros(ro.shape[:-1] + (4,), dtype=ro.dtype, device=ro.device)
    sum4[..., 3] = 1e-4
    for _ in range(steps):
        _count(work, "skip", ~found)
        ro = torch.where(found[..., None], ro, ro + rd)
        s = grid_sample(grid, ro)
        newly = ~found & (s[..., 3] < open_thresh)
        add = torch.cat([s[..., :3], torch.ones_like(s[..., 3:])], -1)
        sum4 = sum4 + torch.where(newly[..., None], add, 0.0)
        found = found | newly
    return ro, sum4, found


def _voxel_march(grid, ro, rd, sum4, num_steps, foggyness, accumulate_fog, work=None):
    """March until a voxel with alpha > 0.3 stops the lane (glsl:257-265 /
    409-418), folding each open sample (rgb, 1) into sum4: as
    sum*foggyness + sample with accumulate_fog, else as a plain sum.
    foggyness is a scalar or a [..., 1] tensor.  work: as
    sample_radiance_fog's, the fetches of the lanes not yet stopped
    ("march")."""
    stopped = torch.zeros(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    for _ in range(num_steps):
        _count(work, "march", ~stopped)
        ro = torch.where(stopped[..., None], ro, ro + rd)
        s = grid_sample(grid, ro)
        hit = s[..., 3] > 0.3
        live = ~stopped & ~hit
        add = torch.cat([s[..., :3], torch.ones_like(s[..., 3:])], -1)
        if accumulate_fog:
            sum4 = torch.where(live[..., None], sum4 * foggyness + add, sum4)
        else:
            sum4 = sum4 + torch.where(live[..., None], add, 0.0)
        stopped = stopped | hit
    return sum4


def sample_radiance(grid, ro_world, rd_unit, lightgrid_scale, num_steps=12,
                    step_scale=1.0, alpha_grid=None):
    """Pure voxel-space GI march, SampleRadiance (lighting_pass.glsl:236-271)."""
    voxel_scale = 2.0 / grid.shape[0]
    rd = rd_unit * voxel_scale
    ro = ro_world * lightgrid_scale
    ro, sum4, _ = _skip_blockage(grid, ro, rd, steps=12, open_thresh=0.1,
                                 alpha_grid=alpha_grid)
    no_open = sum4[..., 3] < 0.5
    sum4 = _voxel_march(grid, ro, rd * step_scale, sum4, num_steps, 0.0, False)
    return torch.where(no_open[..., None], 0.0, _tone(sum4))


def _norm2(v):
    return m3.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _safe_w(v4):
    """v4[..., :3] / w, with |w| < 1e-8 replaced by 1e-8."""
    w = v4[..., 3:4]
    return v4[..., :3] / torch.where(torch.abs(w) < 1e-8, 1e-8, w)


def sample_radiance_with_screen_trace(grid, depth_tex, prev_frame_atlas, view_from_world,
                                      clip_from_view, view_from_clip, world_from_view,
                                      v_dir, p0_view, ro_world, rd_unit, lightgrid_scale,
                                      num_steps, step_scale, noise_01, foggyness,
                                      ss_intensity, max_ss_steps=24, prev_base=None,
                                      prev_levels=None, alpha_grid=None):
    """The hybrid screen-space + voxel GI march of the reference mode,
    SampleRadianceWithScreenSpaceTrace (lighting_pass.glsl:273-424).

    Phase A skips the initial blockage (4 steps, open threshold 0.3).  Phase
    B traces screen space toward the first open point for max_ss_steps
    steps, each lane carrying a status: 0 marching, 1 off screen (the
    lightgrid fallback 2.5 voxels camera-ward), 2 fall through to the voxel
    march, 3 resolved on screen (the previous frame's pyramid sampled once
    after the loop at the recorded uv, lod = min(5 * step, 5)).  Each step
    fetches the nearest depth, and a crossing is solid when three lightgrid
    alpha taps between surface and ray sum to >= 1.5; a translucent one
    boosts the step by 2 + noise.  Phase C fog-marches the grid from the
    open point.  grid: a quantize_grid_u8 table, a pack_grid_u8 window pack
    or a raw [D,H,W,4] grid; alpha_grid: pack_grid_alpha_u16 or None (the
    alpha from grid); p0_view: view-space start [..., 3] (a 4th column is
    ignored); foggyness a scalar or a per-lane tensor; prev_base = (h, w)
    of the pyramid's level 0."""
    return _hybrid_march(grid, depth_tex, prev_frame_atlas, view_from_world, clip_from_view,
                         view_from_clip, world_from_view, v_dir, p0_view, ro_world, rd_unit,
                         lightgrid_scale, num_steps, step_scale, noise_01, foggyness,
                         ss_intensity, max_ss_steps, prev_base, prev_levels, alpha_grid)[0]


def _hybrid_march(grid, depth_tex, prev_frame_atlas, view_from_world, clip_from_view,
                  view_from_clip, world_from_view, v_dir, p0_view, ro_world, rd_unit,
                  lightgrid_scale, num_steps, step_scale, noise_01, foggyness, ss_intensity,
                  max_ss_steps=24, prev_base=None, prev_levels=None, alpha_grid=None,
                  work=None):
    """sample_radiance_with_screen_trace's (rgb, status): status 1 the
    off-screen fallback, 2 the voxel march, 3 resolved on screen.  work: as
    sample_radiance_fog's, each lane's count of the steps and fetches it
    needs: the skip's steps ("skip"), the trace's steps ("trace"), its
    crossings ("crossing") and the alpha taps their outcome needs ("taps":
    two a crossing, and the third where the first two sum to [0.45, 1.5),
    below which no third reaches 1.5 and above which none is needed), the
    fallback ("fallback") and resolve ("resolve") fetches, and, of a lane
    that marches the grid (status 2 where a voxel opened), the open sample
    ("seed") and the march's fetches ("march")."""
    voxel_scale = 2.0 / grid.shape[0]
    if prev_base is None:
        prev_base = (prev_frame_atlas.shape[0], prev_frame_atlas.shape[0])
    rd = rd_unit * voxel_scale
    ro0 = ro_world * lightgrid_scale

    # -- phase A: skip the initial blockage
    ro, sum4, _ = _skip_blockage(grid, ro0, rd, steps=4, open_thresh=0.3,
                                 alpha_grid=alpha_grid, work=work)

    # -- phase B: screen-space trace toward the first open point
    open_vs = m3.transform_points(view_from_world, ro / lightgrid_scale)[..., :3]
    p0_vs = p0_view[..., :3]
    to_open = open_vs - p0_vs
    step_len0 = torch.clamp(p0_vs[..., 2], min=1.0) * (1.0 + noise_01) / 100.0
    ss_dir = to_open / torch.clamp(_norm2(to_open), min=1e-8)[..., None]
    dist_to_travel = _norm3(to_open)

    pos = p0_vs
    step = ss_dir * step_len0[..., None]
    slen = step_len0
    trav = torch.zeros_like(step_len0)
    status = torch.zeros(step_len0.shape, dtype=torch.int32, device=step_len0.device)
    res_uv = torch.zeros(step_len0.shape + (2,), dtype=torch.float32,
                         device=step_len0.device)
    res_slen = torch.zeros_like(step_len0)

    fb = grid_sample(grid, ro0 + 2.5 * v_dir * voxel_scale)
    fb_rgb = colorlib.tone_compress_sqrt(fb[..., :3])
    noff = noise_01 * 0.2
    bf = (2.0 + noise_01)[..., None]
    half_scale = lightgrid_scale * 0.5

    for _ in range(max_ss_steps):
        active = status == 0
        _count(work, "trace", active)
        pos = torch.where(active[..., None], pos + step, pos)
        trav = torch.where(active, trav + slen, trav)
        ndc = _safe_w(m3.transform_points(clip_from_view, pos))
        offscreen = torch.any(torch.abs(ndc[..., :2]) > 1.0, dim=-1) & active
        status = torch.where(offscreen, 1, status)
        step = torch.where(active[..., None], step * 1.2, step)
        slen = torch.where(active, slen * 1.2, slen)

        uv = ndc[..., :2] * 0.5 + 0.5
        d = sampling.sample_nearest(depth_tex, uv)
        surf_vs = _safe_w(m3.transform_points(
            view_from_clip, torch.cat([ndc[..., :2], d[..., None]], -1)))
        hit = (_norm3(surf_vs) < _norm3(pos)) & active & ~offscreen
        _count(work, "crossing", hit)
        _count(work, "taps", hit, 2)

        # solidity: 3 lightgrid alpha taps between surface and ray position
        t_start = m3.transform_points(world_from_view, surf_vs)[..., :3] * half_scale + 0.5
        t_end = m3.transform_points(world_from_view, pos)[..., :3] * half_scale + 0.5
        asum = 0.0
        for k in (0.2, 0.4, 0.6):
            if k == 0.6 and work is not None:   # an alpha lies in [0, 1.0000003]
                _count(work, "taps", hit & ~((asum >= 1.5) | (asum < 0.45)))
            mixk = t_start + (t_end - t_start) * (noff + k)[..., None]
            if alpha_grid is not None:
                asum = asum + sampling.sample_trilinear_window(
                    alpha_grid, mixk, 1, decode=_decode_alpha)[..., 0]
            else:
                asum = asum + _gs_uvw(grid, mixk)[..., 3]
        solid = asum >= 1.5

        # translucent surface: boost the step and keep going (glsl:357-361)
        boost = hit & ~solid
        step = torch.where(boost[..., None], step * bf, step)
        slen = torch.where(boost, slen * bf[..., 0], slen)

        # solid hit: record the resolve uv and step length (glsl:371-384)
        resolve = hit & solid
        status = torch.where(resolve, 3, status)
        res_uv = torch.where(resolve[..., None], uv, res_uv)
        res_slen = torch.where(resolve, slen, res_slen)

        # distance exhausted: on to the voxel march (glsl:392)
        done = (trav > dist_to_travel) & active & ~offscreen & ~resolve & ~boost
        status = torch.where(done, 2, status)

    # lanes that ran out of steps fall through like distance-exhausted ones
    status = torch.where(status == 0, 2, status)
    lod = torch.clamp(res_slen * 5.0, max=5.0)
    prev = sampling.sample_mip_atlas(prev_frame_atlas, prev_base[0], prev_base[1], res_uv,
                                     lod, levels=prev_levels)[..., :3]
    result = torch.where((status == 1)[..., None], fb_rgb, prev * ss_intensity)

    # -- phase C: continue in voxel space (glsl:399-423)
    no_open = sum4[..., 3] < 0.5
    rd2 = rd * step_scale
    fog = foggyness[..., None] if torch.is_tensor(foggyness) else foggyness
    march = {} if work is not None else None
    sum_c = _voxel_march(grid, ro + rd2 * noise_01[..., None], 0.5 * rd2, sum4, num_steps,
                         fog, True, work=march)
    voxel_rgb = torch.where(no_open[..., None], 0.0, _tone(sum_c))
    if work is not None:
        _count(work, "fallback", status == 1)
        _count(work, "resolve", status == 3)
        marches = (status == 2) & ~no_open
        _count(work, "seed", marches)
        work["march"] = march.get("march", torch.zeros_like(status)) * marches.to(torch.int32)
    rgb = torch.where(((status == 1) | (status == 3))[..., None], result, voxel_rgb)
    return rgb, status


# ---------------------------------------------------------------------------
# 4b. One reference-GI ray: the hybrid march on the u8 table, and its CUDA
#     kernel


class ReferenceRayParams(NamedTuple):
    """The scalars of one reference-GI ray (RenderConfig's values;
    reference_ray_params builds them)."""
    lightgrid_scale: float
    num_steps: int           # the voxel march's fetches (gi_diffuse_steps / gi_specular_steps)
    step_scale: float
    ss_intensity: float
    max_ss_steps: int        # the screen trace's steps (gi_screen_trace_steps)
    prev_h: int              # the previous-frame pyramid's level 0
    prev_w: int
    prev_levels: int


def reference_ray_params(cfg, num_steps, step_scale, ss_intensity, prev_h, prev_w):
    """ReferenceRayParams of one ray of the reference GI under `cfg`."""
    return ReferenceRayParams(
        lightgrid_scale=cfg.lightgrid_scale, num_steps=num_steps, step_scale=step_scale,
        ss_intensity=ss_intensity, max_ss_steps=cfg.gi_screen_trace_steps, prev_h=prev_h,
        prev_w=prev_w, prev_levels=cfg.bloom_pass_count)


def reference_ray_resolve_plain(table, trace_depth, prev_atlas, view_from_world, clip_from_view,
                                view_from_clip, world_from_view, vd, pv, pw, rd_unit, noise,
                                foggyness, rp, work=None):
    """The reference-GI radiance of one ray per lane: the hybrid screen +
    voxel march (sample_radiance_with_screen_trace) on the u8 table.

    table: quantize_grid_u8 [D,H,W,4] (every lightgrid fetch); trace_depth
    [Ht,Wt] f32; prev_atlas [H/2,Wa,3] bf16; the four matrices [4,4] f32;
    vd (unit vector toward the camera), pv (view position), pw (world
    position), rd_unit [...,3] f32; noise [...] f32; foggyness a float or
    [...] f32; rp a ReferenceRayParams.  work: an optional dict of each
    lane's step and fetch counts (_hybrid_march's).

    Returns (rgb [...,3] f32, status [...] int32): 1 the off-screen
    fallback, 2 the voxel march, 3 resolved on screen."""
    return _hybrid_march(table, trace_depth, prev_atlas, view_from_world, clip_from_view,
                         view_from_clip, world_from_view, vd, pv, pw, rd_unit,
                         rp.lightgrid_scale, rp.num_steps, rp.step_scale, noise, foggyness,
                         rp.ss_intensity, rp.max_ss_steps, (rp.prev_h, rp.prev_w),
                         rp.prev_levels, work=work)


def _ref_shapes(pw_shape, table_shape, depth_shape, atlas_shape, rp):
    """The checks of reference_ray_resolve's shapes and rp that a plan is
    made from (ValueError); None stands for an input that is no tensor."""
    fn = "reference_ray_resolve"
    if pw_shape is None or len(pw_shape) < 1 or pw_shape[-1] != 3:
        raise ValueError(f"{fn}: pw must be a [..., 3] tensor")
    if table_shape is None or len(table_shape) != 4 or table_shape[-1] != 4 or min(
            table_shape) < 1:
        raise ValueError(f"{fn}: table must be a [D, H, W, 4] tensor")
    if depth_shape is None or len(depth_shape) != 2 or min(depth_shape) < 1:
        raise ValueError(f"{fn}: trace_depth must be an [Ht, Wt] tensor")
    for what in ("num_steps", "max_ss_steps", "prev_h", "prev_w", "prev_levels"):
        v = getattr(rp, what)
        if not isinstance(v, (int, np.integer)) or v < (0 if "steps" in what else 1):
            raise ValueError(f"{fn}: rp.{what} must be an int >= "
                             f"{0 if 'steps' in what else 1}, got {v!r}")
    if rp.prev_levels > MAX_LEVELS:
        raise ValueError(f"{fn}: the pyramid has {rp.prev_levels} levels; the kernel takes 1 "
                         f"to {MAX_LEVELS}")
    _, wa = sampling.mip_offsets(rp.prev_h, rp.prev_w, rp.prev_levels)
    if (atlas_shape is None or len(atlas_shape) != 3 or atlas_shape[0] < rp.prev_h
            or atlas_shape[1] < wa or atlas_shape[2] != 3):
        raise ValueError(f"{fn}: prev_atlas must be [>={rp.prev_h}, >={wa}, 3] for the "
                         f"pyramid of {rp.prev_levels} levels")


def _shape(t):
    return tuple(t.shape) if torch.is_tensor(t) else None


def _ref_check(table, trace_depth, prev_atlas, mats, lanes, noise, foggyness, rp):
    """The full checks of reference_ray_resolve's inputs (ValueError)."""
    fn = "reference_ray_resolve"
    pw = lanes[2]
    _ref_shapes(_shape(pw), _shape(table), _shape(trace_depth), _shape(prev_atlas), rp)
    dev = pw.device
    for t, what in zip(lanes, ("vd", "pv", "pw", "rd_unit")):
        cuda_build.need(t, what, fn, dev, pw.shape)
    cuda_build.need(noise, "noise", fn, dev, pw.shape[:-1])
    if torch.is_tensor(foggyness):
        cuda_build.need(foggyness, "foggyness", fn, dev, pw.shape[:-1])
    elif not isinstance(foggyness, (int, float, np.floating)):
        raise ValueError(f"{fn}: foggyness must be a number or a tensor of the lanes' shape")
    cuda_build.need(table, "table", fn, dev, dtype=torch.uint8)
    if table.is_cuda and table.data_ptr() % 4:
        raise ValueError(f"{fn}: table must start on a 4-byte boundary (read as words)")
    for t, what in zip(mats, ("view_from_world", "clip_from_view", "view_from_clip",
                              "world_from_view")):
        cuda_build.need(t, what, fn, dev, (4, 4))
    cuda_build.need(trace_depth, "trace_depth", fn, dev)
    cuda_build.need(prev_atlas, "prev_atlas", fn, dev, dtype=torch.bfloat16)


class _RayPlan:
    """What the ray kernels' plans (_RefPlan, _ScreenPlan) share: the lane
    shape and grid, the lock a call holds while it sets the struct's
    pointers, the inputs' specs that each call's inputs are compared with
    (`matches`), and the outputs' layout in one allocation (rgb, then the
    status on a 128-byte line).  A spec is (dtype, shape) for a contiguous
    tensor on the plan's card, "none" where the call passes None, and None
    where the kernel does not read the input."""

    def __init__(self, device, lane_shape, specs):
        lane_shape = tuple(lane_shape)
        rows, width = lane_grid(lane_shape)
        n = math.prod(lane_shape)
        self.device, self.lock, self.lane_shape, self.specs = (
            device, threading.Lock(), lane_shape, tuple(specs))
        self.width = max(width, 1)
        self.status_off = -(-3 * n // 32) * 32
        self.total = self.status_off + n
        self.tile_h = lane_tile_h(rows)

    def matches(self, ts):
        """Whether the inputs ts meet the plan's specs, one for one."""
        if len(ts) != len(self.specs):
            return False
        for t, spec in zip(ts, self.specs):
            if spec is None:
                continue
            if spec == "none":
                if t is not None:
                    return False
                continue
            dtype, shape = spec
            if (not torch.is_tensor(t) or t.dtype is not dtype or t.shape != shape
                    or not t.is_contiguous() or t.device != self.device):
                return False
        return True

    def outputs(self):
        """A fresh (rgb, status): views of one new allocation."""
        buf = torch.empty(self.total, dtype=torch.float32, device=self.device)
        n = self.total - self.status_off
        return (buf[:3 * n].view(self.lane_shape + (3,)),
                buf[self.status_off:].view(torch.int32).view(self.lane_shape))


class _RefArgs(ctypes.Structure):
    """struct RefArgs of csrc/gi_reference_ray.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "table", "depth", "atlas", "view_from_world", "clip_from_view", "view_from_clip",
        "world_from_view", "vd", "pv", "pw", "rd", "noise", "fog_lane", "out_rgb",
        "out_status")] + [(n, ctypes.c_float) for n in (
            "fog", "scale", "inv_scale", "voxel", "half_scale", "step_scale",
            "ss_intensity")] + [(n, ctypes.c_int) for n in (
                "n", "gd", "gh", "gw", "th", "tw", "atlas_wa", "prev_h", "prev_w",
                "prev_levels", "num_steps", "max_ss_steps", "width", "tile_h")]


class _RefPlan(_RayPlan):
    """What a reference-ray launch of one shape keeps between calls
    (_RayPlan's lane grid, specs, lock and output layout): the struct with
    every per-shape field set (the grid's, the trace table's and the
    pyramid's sizes, the lane grid and its tiles, rp's scalars).  A call
    allocates the outputs anew and sets the data pointers and the scalar
    foggyness under the plan's lock.  The constructor raises _ref_shapes'
    ValueErrors."""

    def __init__(self, device, pw_shape, table_shape, depth_shape, atlas_shape, rp, fog_lane):
        _ref_shapes(pw_shape, table_shape, depth_shape, atlas_shape, rp)
        lane_shape = pw_shape[:-1]
        super().__init__(device, lane_shape, [
            (torch.uint8, table_shape), (torch.float32, depth_shape),
            (torch.bfloat16, atlas_shape)] + [(torch.float32, (4, 4))] * 4
            + [(torch.float32, pw_shape)] * 4
            + [(torch.float32, lane_shape)] * (2 if fog_lane else 1))
        f32 = np.float32
        self.fog_lane = fog_lane
        self.args = _RefArgs(
            scale=rp.lightgrid_scale,
            # PyTorch on the card divides by a Python number as a product with
            # its f32 reciprocal (ro / lightgrid_scale): the kernel does too
            inv_scale=float(f32(1.0) / f32(rp.lightgrid_scale)),
            voxel=2.0 / table_shape[0], half_scale=rp.lightgrid_scale * 0.5,
            step_scale=rp.step_scale, ss_intensity=rp.ss_intensity, n=math.prod(lane_shape),
            gd=table_shape[0], gh=table_shape[1], gw=table_shape[2], th=depth_shape[0],
            tw=depth_shape[1], atlas_wa=atlas_shape[1], prev_h=rp.prev_h, prev_w=rp.prev_w,
            prev_levels=rp.prev_levels, num_steps=rp.num_steps, max_ss_steps=rp.max_ss_steps,
            width=self.width, tile_h=self.tile_h)

    def accepts(self, ts, foggyness):
        """Whether the inputs ts (table, trace depth, pyramid, the four
        matrices, vd, pv, pw, rd_unit, noise[, foggyness]) meet the plan's
        specs, the table starts on a 4-byte boundary, and a scalar
        foggyness is a number."""
        if not self.fog_lane and not isinstance(foggyness, (int, float, np.floating)):
            return False
        return self.matches(ts) and ts[0].data_ptr() % 4 == 0


@functools.lru_cache(maxsize=16)
def _ref_plan(device, pw_shape, table_shape, depth_shape, atlas_shape, rp, fog_lane):
    return _RefPlan(device, pw_shape, table_shape, depth_shape, atlas_shape, rp, fog_lane)


def reference_ray_resolve(table, trace_depth, prev_atlas, view_from_world, clip_from_view,
                          view_from_clip, world_from_view, vd, pv, pw, rd_unit, noise, foggyness,
                          rp):
    """reference_ray_resolve_plain's (rgb, status).  A CUDA tensor launches
    csrc/gi_reference_ray.cu's kernel once through a plan cached per shape
    (_RefPlan), or raises; a CPU tensor takes the plain version.  On the
    card a call's inputs are compared with its plan's; the full checks
    (ValueError) run on the CPU and where that comparison fails.  No host
    sync: the matrices stay on the device.  The outputs are views of one
    fresh allocation a call.
    `reference_ray_resolve.launches` counts launches."""
    mats = (view_from_world, clip_from_view, view_from_clip, world_from_view)
    lanes = (vd, pv, pw, rd_unit)
    if not torch.is_tensor(pw) or not pw.is_cuda:
        _ref_check(table, trace_depth, prev_atlas, mats, lanes, noise, foggyness, rp)
        return reference_ray_resolve_plain(table, trace_depth, prev_atlas, *mats, *lanes, noise,
                                           foggyness, rp)
    rgb, status = run_reference_ray(_ref_library(), table, trace_depth, prev_atlas, *mats,
                                    *lanes, noise, foggyness, rp)
    reference_ray_resolve.launches += 1
    return rgb, status


reference_ray_resolve.launches = 0


def run_reference_ray(lib, table, trace_depth, prev_atlas, view_from_world, clip_from_view,
                      view_from_clip, world_from_view, vd, pv, pw, rd_unit, noise, foggyness, rp,
                      tile_h=None):
    """One launch of a built reference-ray library's gi_reference_ray_launch
    (the package's csrc/gi_reference_ray.cu, or a variant's) on CUDA
    tensors through the plan of their shape (_RefPlan): reference_ray_resolve
    without its CPU route and launch count.  tile_h: rows of a warp's lane
    tile for this launch (default the plan's, lane_tile_h of the rows)."""
    mats = (view_from_world, clip_from_view, view_from_clip, world_from_view)
    lanes = (vd, pv, pw, rd_unit)
    fog_lane = torch.is_tensor(foggyness)
    ts = (table, trace_depth, prev_atlas, *mats, *lanes, noise) + ((foggyness,) if fog_lane
                                                                    else ())
    plan = _ref_plan(pw.device, tuple(pw.shape), _shape(table), _shape(trace_depth),
                     _shape(prev_atlas), rp, fog_lane)
    if not plan.accepts(ts, foggyness):
        # raises: inputs that pass have the plan's specs
        _ref_check(table, trace_depth, prev_atlas, mats, lanes, noise, foggyness, rp)
    rgb, status = plan.outputs()
    with plan.lock:
        args = plan.args
        (args.table, args.depth, args.atlas, args.view_from_world, args.clip_from_view,
         args.view_from_clip, args.world_from_view, args.vd, args.pv, args.pw, args.rd,
         args.noise) = (t.data_ptr() for t in ts[:12])
        args.fog_lane = foggyness.data_ptr() if fog_lane else None
        args.fog = 0.0 if fog_lane else float(foggyness)
        args.out_rgb, args.out_status = rgb.data_ptr(), status.data_ptr()
        args.tile_h = tile_h or plan.tile_h
        err = _ref_launcher(lib)(ctypes.byref(args), pw.device.index,
                                 torch.cuda.current_stream(pw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gi_reference_ray_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return rgb, status


def _ref_library(defines=(), source=None):
    """The built reference-ray library: csrc/gi_reference_ray.cu, or the
    file `source` with `defines` (a variant's -D values)."""
    return cuda_build.load_library("gi_reference_ray", tuple(defines), source)


@functools.cache
def _ref_launcher(lib):
    """lib's gi_reference_ray_launch(args, device, stream)."""
    fn = lib.gi_reference_ray_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def reference_ray_occupancy(lib=None, table_shape=(128, 128, 128)):
    """{registers, local_bytes, blocks_per_sm, threads, shared_bytes} of a
    built reference-ray library's kernel (the package's by default) for a
    table of table_shape's [D, H, W] texels (the kernel has its own
    instance for 128^3) on the current card."""
    lib = lib or _ref_library()
    names = ("registers", "local_bytes", "blocks_per_sm", "threads", "shared_bytes")
    vals = [ctypes.c_int() for _ in names]
    fn = lib.gi_reference_ray_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * len(names)
    fn.restype = ctypes.c_int
    err = fn(*(int(d) for d in table_shape[:3]), *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"gi_reference_ray_occupancy failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return {n: v.value for n, v in zip(names, vals)}


# ---------------------------------------------------------------------------
# 5. The fast GI's other marches and screen terms (gi.py:648-857,
#    1232-1504): the economy mode's quadrature (sample_radiance_fast) and
#    its alpha march to a hit (march_to_hit), the wave-9 march
#    (sample_radiance_march), the screen probes (screen_probe,
#    screen_probe_multi) and the hierarchical-z trace (build_hiz_atlas,
#    hiz_trace, screen_trace_hiz).  The grids are the u8 table (or its
#    window packs); the previous frame is the f16 window pack of
#    probe_prev_pack.  A tensor divided by a Python number is written as
#    such: on the card PyTorch multiplies by the number's f32 reciprocal, and
#    a Python number divided by a tensor is the tensor's reciprocal times
#    the number (Tensor.__rtruediv__), which the kernels mirror.


def sample_radiance_fast(grid, ro_world, rd_unit, lightgrid_scale, dist_voxels=2.5,
                         skip_steps=4, open_thresh=0.3, n_samples=1, sample_spread=3.5,
                         alpha_grid=None, work=None):
    """The economy mode's irradiance-cache GI (gi.py:648): the blockage skip
    (_skip_blockage, its first open sample the seed), then n_samples
    trilinear samples dist_voxels - 2 + k * sample_spread voxels past the
    open point, each weighted by its openness and the openness of those
    before it; zero where no voxel opened.  work: the live skip steps
    ("skip") and the samples of the lanes that opened ("sample").  Returns (rgb, ro_open)."""
    voxel_scale = 2.0 / grid.shape[0]
    rd = rd_unit * voxel_scale
    ro = ro_world * lightgrid_scale
    ro, sum4, found = _skip_blockage(grid, ro, rd, skip_steps, open_thresh, alpha_grid, work)
    acc_rgb = sum4[..., :3]
    acc_w = torch.clamp(sum4[..., 3:4], max=1.0)
    trans = 1.0
    for k in range(max(1, n_samples)):
        _count(work, "sample", found)
        s = grid_sample(grid, ro + rd * (dist_voxels - 2.0 + k * sample_spread))
        open_k = torch.clamp((0.5 - s[..., 3:4]) * 4.0, 0.0, 1.0)
        acc_rgb = acc_rgb + trans * open_k * s[..., :3]
        acc_w = acc_w + trans * open_k
        trans = trans * open_k
    rgb = colorlib.tone_compress_sqrt(acc_rgb / torch.clamp(acc_w, min=1e-4))
    blocked = sum4[..., 3:4] < 0.5
    return torch.where(blocked, 0.0, rgb * torch.clamp(acc_w, max=1.0)), ro


def sample_radiance_march(grid, alpha_grid, ro_world, rd_unit, lightgrid_scale, skip_steps=3,
                          open_thresh=0.3, hit_steps=6, hit_thresh=0.3, step_scale=1.0,
                          noise=None, rgb_samples=2, work=None):
    """The wave-9 march (gi.py:685): the blockage skip on the alpha rows, an
    alpha march of hit_steps step_scale-voxel steps (from the open point
    jittered by noise steps) to the next voxel above hit_thresh, then the
    fog average rebuilt from rgb_samples samples 1 / 2.5 / 5 steps behind
    the stop plus the open seed.  work: "skip" and "march" (live steps).
    Returns (rgb, ro_open, ro_stop, hit & found, found)."""
    rd = rd_unit * (2.0 / grid.shape[0])
    ro = ro_world * lightgrid_scale
    found = torch.zeros(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    for _ in range(skip_steps):
        _count(work, "skip", ~found)
        ro = torch.where(found[..., None], ro, ro + rd)
        found = found | (_sample_alpha_u16(alpha_grid, ro) < open_thresh)
    ro_open = ro
    rdm = rd * step_scale
    ro_c = ro_open if noise is None else ro_open + rdm * noise[..., None]
    hit = torch.zeros_like(found)
    for _ in range(hit_steps):
        _count(work, "march", found & ~hit)
        ro_c = torch.where((hit | ~found)[..., None], ro_c, ro_c + rdm)
        hit = hit | (_sample_alpha_u16(alpha_grid, ro_c) > hit_thresh)
    dists = [1.0, 2.5, 5.0][:max(1, rgb_samples)]
    wgts = [1.0, 0.45, 0.15][:max(1, rgb_samples)]
    s0 = grid_sample(grid, ro_open)
    o0 = torch.clamp((0.5 - s0[..., 3:4]) * 4.0, 0.0, 1.0)
    acc = 0.35 * o0 * s0[..., :3]
    den = 0.35 * o0
    for d, wk in zip(dists, wgts):
        sk = grid_sample(grid, ro_c - rdm * d)
        ok = torch.clamp((0.5 - sk[..., 3:4]) * 4.0, 0.0, 1.0)
        acc = acc + wk * ok * sk[..., :3]
        den = den + wk * ok
    rgb = colorlib.tone_compress_sqrt(acc / torch.clamp(den, min=1e-4))
    rgb = torch.where(found[..., None], rgb, 0.0)
    return rgb, ro_open, ro_c, hit & found, found


def march_to_hit(alpha_grid, ro, rd, steps, thresh=0.3, work=None):
    """March the alpha rows by rd until alpha > thresh (gi.py:778).  work:
    the live steps ("hit").  Returns (ro at the hit, frozen there; hit)."""
    hit = torch.zeros(ro.shape[:-1], dtype=torch.bool, device=ro.device)
    for _ in range(steps):
        _count(work, "hit", ~hit)
        ro = torch.where(hit[..., None], ro, ro + rd)
        hit = hit | (_sample_alpha_u16(alpha_grid, ro) > thresh)
    return ro, hit


def _project(m, p):
    """(ndc [..., 3], w) of points p under m, |w| < 1e-8 divided as 1e-8."""
    p4 = m3.transform_points(m, p)
    w = p4[..., 3]
    return p4[..., :3] / torch.where(torch.abs(w[..., None]) < 1e-8, 1e-8, w[..., None]), w


def _onscreen(ndc, w):
    return (w > 0.0) & (torch.abs(ndc[..., 0]) < 1.0) & (torch.abs(ndc[..., 1]) < 1.0)


def screen_probe(open_grid_ndc, lightgrid_scale, clip_from_world, depth_tex, wprev, prev_hw,
                 ss_intensity, z_margin=2e-4):
    """One-point screen probe (gi.py:1470): the open point's projection hits
    where it lies on screen behind the visible surface (nearest depth +
    z_margin); the previous frame's window pack wprev (prev_hw its texels)
    is sampled there.  Returns (hit, rgb * ss_intensity)."""
    ndc, w = _project(clip_from_world, open_grid_ndc / lightgrid_scale)
    uv = ndc[..., :2] * 0.5 + 0.5
    d_scene = sampling.sample_nearest(depth_tex, uv)
    hit = _onscreen(ndc, w) & (ndc[..., 2] > d_scene + z_margin) & (d_scene < 1.0)
    prev = sampling.sample_bilinear_window(wprev, prev_hw[0], prev_hw[1], uv, 3)
    return hit, prev * ss_intensity


def probe_fractions(k_points, spacing_gamma=1.0, spacing_growth=0.0):
    """The k-point probe's fractions along its segment, host floats:
    (g^k - 1) / (g^K - 1) for spacing_growth g > 1, else (k/K)^gamma."""
    if spacing_growth > 1.0:
        return tuple((spacing_growth ** k - 1.0) / (spacing_growth ** k_points - 1.0)
                     for k in range(1, k_points + 1))
    return tuple((k / k_points) ** spacing_gamma for k in range(1, k_points + 1))


def screen_probe_multi(ro_grid_ndc, open_grid_ndc, lightgrid_scale, clip_from_world, depth_tex,
                       wprev, prev_hw, ss_intensity, z_margin=2e-4, k_points=3, prev_levels=0,
                       dist_mip=0.0, want_offscreen=False, solid_taps=0, alpha_grid=None,
                       world_from_clip=None, noise=None, spacing_gamma=1.0, point_jitter=0.0,
                       spacing_growth=0.0, work=None):
    """K-point screen probe of the segment [ro, open] in grid NDC
    (gi.py:806): each point (probe_fractions, dithered by +-point_jitter/K
    of noise) is projected; an off-screen point ends the lane's search, and
    the first point on screen behind the surface (and, with solid_taps,
    whose taps between it and the surface reach 0.5 alpha a tap on
    alpha_grid) resolves.  The previous frame is sampled at its uv: with
    dist_mip > 0 from the whole pyramid's window pack (prev_levels levels)
    at level round(distance * dist_mip), where the distance is the segment's
    world length times the resolved fraction (the last solidity tap's
    fraction when solid_taps > 0, as the reference package's loop rebinds
    it), else from the one-level pack.  work: the points tested ("probe")
    and the taps ("taps").  Returns (hit, rgb * ss_intensity[, the lanes
    whose first off-screen point came before any hit])."""
    seg = open_grid_ndc - ro_grid_ndc
    seg_world = _norm3(seg) / max(lightgrid_scale, 1e-8)
    shape = ro_grid_ndc.shape[:-1]
    dev = ro_grid_ndc.device
    best_hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    first_off = torch.zeros_like(best_hit)
    best_uv = torch.zeros(shape + (2,), dtype=torch.float32, device=dev)
    best_t = torch.zeros(shape, dtype=torch.float32, device=dev)
    for frac in probe_fractions(k_points, spacing_gamma, spacing_growth):
        _count(work, "probe", ~(best_hit | first_off))
        if point_jitter > 0.0 and noise is not None:
            frac = torch.clamp(frac + (noise - 0.5) * (point_jitter / k_points), 0.0, 1.0)
        p = ro_grid_ndc + seg * (frac[..., None] if torch.is_tensor(frac) else frac)
        ndc, w = _project(clip_from_world, p / lightgrid_scale)
        uv = ndc[..., :2] * 0.5 + 0.5
        onscreen = _onscreen(ndc, w)
        first_off = first_off | (~onscreen & ~best_hit)
        d_scene = sampling.sample_nearest(depth_tex, uv)
        hit_k = onscreen & ~first_off & (ndc[..., 2] > d_scene + z_margin) & (d_scene < 1.0)
        if solid_taps > 0:
            _count(work, "taps", hit_k & ~best_hit, solid_taps)
            surf, _ = _project(world_from_clip, torch.cat([ndc[..., :2], d_scene[..., None]], -1))
            surf_g = surf * lightgrid_scale
            n0 = noise * 0.2 if noise is not None else 0.0
            asum = 0.0
            for t in range(1, solid_taps + 1):
                frac = n0 + t / (solid_taps + 1.0)
                pos = surf_g + (p - surf_g) * (frac[..., None] if torch.is_tensor(frac) else frac)
                asum = asum + _sample_alpha_u16(alpha_grid, pos)
            hit_k = hit_k & (asum >= 0.5 * solid_taps)
        newly = hit_k & ~best_hit
        best_uv = torch.where(newly[..., None], uv, best_uv)
        best_t = torch.where(newly, frac, best_t)
        best_hit = best_hit | hit_k
    if dist_mip > 0.0 and prev_levels > 0:
        lv = torch.round(seg_world * best_t * dist_mip).to(torch.int32)
        prev = sampling.sample_screen_atlas_window(wprev, prev_hw[0], prev_hw[1], prev_levels,
                                                   best_uv, lv, 3)
    else:
        prev = sampling.sample_bilinear_window(wprev, prev_hw[0], prev_hw[1], best_uv, 3)
    if want_offscreen:
        return best_hit, prev * ss_intensity, first_off & ~best_hit
    return best_hit, prev * ss_intensity


def build_hiz_atlas(depth, levels=6):
    """Min-depth pyramid of depth [H, W] in one [H, Wa] f32 atlas (gi.py:1232):
    level k (2x2 minima of level k-1) at column sampling.mip_offsets(H, W,
    levels)[k]; the unused texels hold 1.0 (far).  Exact.  Returns (atlas,
    offsets int32[levels])."""
    h, w = depth.shape
    offs, wa = sampling.mip_offsets(h, w, levels)
    atlas = torch.ones((h, wa), dtype=torch.float32, device=depth.device)
    cur = depth
    for k in range(levels):
        lh, lw = cur.shape
        atlas[:lh, offs[k]:offs[k] + lw] = cur
        if k + 1 < levels:
            if lh < 2 or lw < 2:
                cur = cur[:lh // 2, :lw // 2]
            else:
                cur = cur[:lh // 2 * 2, :lw // 2 * 2].reshape(lh // 2, 2, lw // 2, 2).amin(
                    dim=(1, 3))
    return atlas, torch.tensor(offs, dtype=torch.int32, device=depth.device)


HIZ_MAX_LEVEL = 5     # hiz_trace's coarsest level as screen_trace_hiz runs it


def _zview(zview_nf):
    """hiz_trace's depth to view-space z (the LH_ZO inverse), or identity."""
    if zview_nf is None:
        return lambda z: z
    zn, zf = zview_nf
    return lambda z: (zf * zn) / torch.clamp(zf - z * (zf - zn), min=1e-6)


def hiz_trace(atlas, offs, base_hw, p0, p1, iters=10, start_level=1, max_level=HIZ_MAX_LEVEL,
              thickness=0.015, z_bias=2e-4, t0_px=2.0, zview_nf=None, work=None):
    """Hierarchical-z walk from p0 to p1 ([..., 3] = (u, v, ndc z)) over
    build_hiz_atlas's pyramid of a base_hw depth (gi.py:1258): each of
    `iters` rounds advances a lane to its cell's exit where the segment
    stays in front of the cell's minimum, or refines a level (jumping to
    the segment's z crossing); at level 0 a crossing within `thickness`
    behind the surface hits, one farther behind is skipped.  zview_nf =
    (z_near, z_far) measures the bias and thickness in view space.  work:
    the live rounds ("hiz").  Returns (hit, t_hit, dead)."""
    h, w = base_hw
    zv = _zview(zview_nf)
    dev = p0.device
    u0, v0, z0 = p0[..., 0], p0[..., 1], p0[..., 2]
    du = p1[..., 0] - u0
    dv = p1[..., 1] - v0
    dz = p1[..., 2] - z0
    big = 1e9

    def exit_t(o, d):
        t_hi = torch.where(d > 1e-9, (1.0 - o) / torch.where(d > 1e-9, d, 1.0), big)
        t_lo = torch.where(d < -1e-9, (0.0 - o) / torch.where(d < -1e-9, d, -1.0), big)
        return torch.minimum(t_hi, t_lo)

    t_max = torch.clamp(torch.minimum(exit_t(u0, du), exit_t(v0, dv)), max=1.0)
    duw, dvh = du * w, dv * h
    seg_px = torch.clamp(m3.sqrt(duw * duw + dvh * dvh), min=1e-6)
    eps_t = 0.05 / seg_px
    t = torch.minimum(t0_px / seg_px, t_max)
    lvl = torch.full(t.shape, start_level, dtype=torch.int32, device=dev)
    hit = torch.zeros(t.shape, dtype=torch.bool, device=dev)
    t_hit = torch.zeros_like(t)
    dead = t >= t_max
    lw = torch.tensor([max(1, w >> k) for k in range(max_level + 1)], dtype=torch.int32,
                      device=dev)
    lh = torch.tensor([max(1, h >> k) for k in range(max_level + 1)], dtype=torch.int32,
                      device=dev)
    offs = offs.to(device=dev, dtype=torch.int32)
    inv_du = torch.where(torch.abs(du) > 1e-9, 1.0 / torch.where(du == 0, 1.0, du), big)
    inv_dv = torch.where(torch.abs(dv) > 1e-9, 1.0 / torch.where(dv == 0, 1.0, dv), big)
    flat = atlas.reshape(-1)
    wa = atlas.shape[1]
    for _ in range(iters):
        active = ~hit & ~dead
        _count(work, "hiz", active)
        li = lvl.to(torch.int64)
        cs = torch.exp2(lvl.to(torch.float32))
        pu = (u0 + du * t) * w
        pv = (v0 + dv * t) * h
        cx = torch.floor(pu / cs)
        cy = torch.floor(pv / cs)
        bx = (cx + (du > 0)) * cs
        by = (cy + (dv > 0)) * cs
        tx = (bx / w - u0) * inv_du
        ty = (by / h - v0) * inv_dv
        tx = torch.where(torch.abs(du) > 1e-9, tx, big)
        ty = torch.where(torch.abs(dv) > 1e-9, ty, big)
        t_cross = torch.minimum(torch.minimum(tx, ty), t_max)
        ix = torch.minimum(torch.clamp(cx.to(torch.int32), min=0), lw[li] - 1)
        iy = torch.minimum(torch.clamp(cy.to(torch.int32), min=0), lh[li] - 1)
        zcell = flat[(iy * wa + offs[li] + ix).to(torch.int64)]
        z_enter = z0 + dz * t
        z_exit = z0 + dz * t_cross
        zmax = torch.maximum(z_enter, z_exit)
        if zview_nf is not None:
            cross = (zv(zmax) - z_bias >= zv(zcell)) & (zcell < 1.0)
        else:
            cross = (zmax + z_bias >= zcell) & (zcell < 1.0)
        at0 = lvl == 0
        real_hit = active & cross & at0 & (
            zv(torch.minimum(z_enter, z_exit)) - zv(zcell) < thickness)
        skip_behind = active & cross & at0 & ~real_hit
        hit = hit | real_hit
        t_hit = torch.where(real_hit, t, t_hit)
        refine = active & cross & ~at0
        advance = active & (~cross | skip_behind)
        lvl = torch.where(refine, lvl - 1,
                          torch.where(advance, torch.clamp(lvl + 1, max=max_level), lvl))
        dzi = z_exit - z_enter
        t_z = t + (zcell - z_enter) / torch.where(torch.abs(dzi) < 1e-9, 1.0, dzi) * (t_cross - t)
        t_z = torch.where(dzi > 1e-9, torch.minimum(torch.maximum(t_z, t), t_cross), t)
        t_new = torch.where(advance, t_cross + eps_t, torch.where(refine, t_z, t))
        dead = dead | (advance & (t_new >= t_max))
        t = t_new
    return hit, t_hit, dead


def screen_trace_hiz(ro_grid_ndc, open_grid_ndc, lightgrid_scale, clip_from_world, hiz,
                     hiz_offs, base_hw, wprev, prev_hw, ss_intensity, alpha_grid=None, iters=10,
                     thickness=0.5, z_bias=2e-4, solid_thresh=0.0, zview_nf=None, work=None):
    """Hi-z screen resolve of the segment [ro, open] in grid NDC
    (gi.py:1391): the segment clipped at w = 1e-3 before the camera plane,
    hiz_trace between its projections; with solid_thresh > 0 a hit needs
    that much alpha (alpha_grid) at its perspective-correct world point; a
    lane the walk missed whose end point projects on screen behind the
    level-0 depth resolves there.  The previous frame's window pack is
    sampled at the resolved uv.  work: hiz_trace's, and the solidity taps
    ("taps").  Returns (hit, rgb * ss_intensity)."""
    c0 = m3.transform_points(clip_from_world, ro_grid_ndc / lightgrid_scale)
    c1 = m3.transform_points(clip_from_world, open_grid_ndc / lightgrid_scale)
    w0, w1 = c0[..., 3], c1[..., 3]
    w_min = 1e-3
    t_end = torch.where(w1 < w_min,
                        torch.clamp((w0 - w_min) / torch.clamp(w0 - w1, min=1e-6), 0.0, 1.0),
                        1.0)
    c1 = c0 + (c1 - c0) * t_end[..., None]
    w1 = torch.clamp(c1[..., 3], min=w_min)
    w0s = torch.clamp(w0, min=w_min)
    ndc0 = c0[..., :3] / w0s[..., None]
    ndc1 = c1[..., :3] / w1[..., None]
    p0 = torch.cat([ndc0[..., :2] * 0.5 + 0.5, ndc0[..., 2:3]], -1)
    p1 = torch.cat([ndc1[..., :2] * 0.5 + 0.5, ndc1[..., 2:3]], -1)
    valid = w0 > w_min
    hit, t_hit, _ = hiz_trace(hiz, hiz_offs, base_hw, p0, p1, iters=iters, thickness=thickness,
                              z_bias=z_bias, zview_nf=zview_nf, work=work)
    hit = hit & valid
    if alpha_grid is not None and solid_thresh > 0.0:
        _count(work, "taps", hit)
        iw0, iw1 = 1.0 / w0s, 1.0 / w1
        th = t_hit[..., None]
        denom = (1.0 - th) * iw0[..., None] + th * iw1[..., None]
        mid = ((1.0 - th) * ro_grid_ndc * iw0[..., None]
               + th * open_grid_ndc * iw1[..., None]) / denom
        hit = hit & (_sample_alpha_u16(alpha_grid, mid) >= solid_thresh)
    hh, ww = base_hw
    e_ix = torch.clamp((p1[..., 0] * ww).to(torch.int32), 0, ww - 1)
    e_iy = torch.clamp((p1[..., 1] * hh).to(torch.int32), 0, hh - 1)
    d_end = hiz.reshape(-1)[(e_iy * hiz.shape[1] + e_ix).to(torch.int64)]
    onscreen = (valid & (t_end >= 1.0) & (p1[..., 0] > 0.0) & (p1[..., 0] < 1.0)
                & (p1[..., 1] > 0.0) & (p1[..., 1] < 1.0))
    end_hit = onscreen & ~hit & (p1[..., 2] > d_end) & (d_end < 1.0)
    t_res = torch.where(end_hit, 1.0, t_hit)
    hit = hit | end_hit
    uv_hit = p0[..., :2] + (p1[..., :2] - p0[..., :2]) * t_res[..., None]
    prev = sampling.sample_bilinear_window(wprev, prev_hw[0], prev_hw[1], uv_hit, 3)
    return hit, prev * ss_intensity


# ---------------------------------------------------------------------------
# 5b. One ray of the fast GI's probe and hi-z screen terms and of its
#     economy mode (the JAX package's gi_modes.py:147-224, 292-354 and
#     403-468), and their CUDA kernels


class ScreenRayParams(NamedTuple):
    """The scalars of one ray of screen_ray_resolve_plain (RenderConfig's
    values; screen_ray_params builds them).  kind: "fog" (the fog march of
    fast_march_gi, the kernel gi_screen_ray), "march" (its wave-9 march,
    no kernel) or "fast" (fast_probe_gi's quadrature, the kernel
    gi_probe_ray).  term: "probes" (screen_probe_multi of the march's
    segment), "hiz" (screen_trace_hiz of it), "probe" (fast_probe_gi's
    probe: screen_probe_multi from the surface, or screen_probe with one
    point) or None."""
    kind: str
    term: object
    lightgrid_scale: float
    voxel_step: float        # 2 / lightgrid_size
    skip_steps: int
    open_thresh: float
    march_steps: int         # the fog / wave-9 march's steps; "fast": march_to_hit's
    step_scale: float        # their step in voxels
    jitter_scale: float      # the fog march's start jitter in steps
    rgb_samples: int         # the wave-9 march's rgb samples / the quadrature's samples
    sample_spread: float     # the quadrature's spacing in voxels
    dist_voxels: float       # the quadrature's first sample, voxels past the open point
    ss_intensity: float
    to_stop: bool            # probe [surface, march stop]
    overshoot: float
    edge_fallback: bool
    k_points: int
    z_margin: float
    gamma: float
    growth: float
    jitter: float
    solid_taps: int
    dist_mip: float
    probe_level: int
    prev_h: int              # the previous-frame pyramid's level 0
    prev_w: int
    prev_levels: int
    hiz_iters: int
    hiz_thickness: float
    hiz_bias: float
    hiz_solid: float
    z_near: float
    z_far: float
    hiz_levels: int
    hiz_h: int               # the hi-z pyramid's level 0 (the probe depth's shape)
    hiz_w: int


def screen_ray_params(cfg, kind, march_steps, step_scale, ss_intensity, prev_h, prev_w,
                      hiz_hw=(0, 0), dist_voxels=2.5):
    """ScreenRayParams of one ray under `cfg`: kind "fog" / "march" (the
    probes or hiz term of cfg.gi_fast_screen_mode) with the march's steps
    and step scale, or "fast" (the economy mode's ray, march_steps and
    step_scale its march_to_hit's, dist_voxels its first sample)."""
    if kind == "fast":
        term = "probe" if cfg.gi_fast_screen_probe and cfg.gi_fast_screen_mode != "trace" \
            else None
        probe = dict(to_stop=False, overshoot=0.0, edge_fallback=False, gamma=1.0, growth=0.0,
                     jitter=0.0, solid_taps=0)
    else:
        term = cfg.gi_fast_screen_mode
        probe = dict(to_stop=cfg.gi_fast_probe_to_stop, overshoot=cfg.gi_fast_probe_overshoot,
                     edge_fallback=cfg.gi_fast_edge_fallback, gamma=cfg.gi_fast_probe_gamma,
                     growth=cfg.gi_fast_probe_growth, jitter=cfg.gi_fast_probe_jitter,
                     solid_taps=cfg.gi_fast_probe_solid_taps)
    return ScreenRayParams(
        kind=kind, term=term, lightgrid_scale=cfg.lightgrid_scale,
        voxel_step=2.0 / cfg.lightgrid_size, skip_steps=cfg.gi_fast_skip_steps,
        open_thresh=cfg.gi_fast_open_thresh, march_steps=march_steps, step_scale=step_scale,
        jitter_scale=cfg.gi_fast_jitter_scale, rgb_samples=cfg.gi_fast_samples,
        sample_spread=cfg.gi_fast_sample_spread, dist_voxels=dist_voxels,
        ss_intensity=ss_intensity, k_points=cfg.gi_fast_probe_points,
        z_margin=cfg.gi_fast_probe_margin, dist_mip=cfg.gi_fast_probe_dist_mip,
        probe_level=cfg.gi_fast_probe_level, prev_h=prev_h, prev_w=prev_w,
        prev_levels=cfg.bloom_pass_count, hiz_iters=cfg.gi_hiz_iters,
        hiz_thickness=cfg.gi_hiz_thickness, hiz_bias=cfg.gi_hiz_bias,
        hiz_solid=cfg.gi_hiz_solid, z_near=cfg.z_near, z_far=cfg.z_far,
        hiz_levels=cfg.gi_hiz_levels, hiz_h=hiz_hw[0], hiz_w=hiz_hw[1], **probe)


def _check_screen_params(rp, fn):
    """ValueError for the ScreenRayParams the reference package cannot run:
    a one-level resolve (the hi-z term, a one-point probe) with dist_mip > 0
    (its window pack of the whole pyramid has another width), a probe level
    the pyramid lacks, a hi-z pyramid of fewer than HIZ_MAX_LEVEL + 1 levels."""
    if rp.kind not in ("fog", "march", "fast") or rp.term not in (None, "probes", "hiz",
                                                                  "probe"):
        raise ValueError(f"{fn}: unknown kind {rp.kind!r} or term {rp.term!r}")
    if rp.term is None:
        return
    single = rp.term == "hiz" or (rp.term == "probe" and rp.k_points <= 1)
    if rp.dist_mip > 0.0 and single:
        raise ValueError(f"{fn}: gi_fast_probe_dist_mip > 0 needs the k-point probe; the "
                         "hi-z term and a one-point probe sample one pyramid level")
    if rp.dist_mip <= 0.0 and not 0 <= rp.probe_level < rp.prev_levels:
        raise ValueError(f"{fn}: gi_fast_probe_level {rp.probe_level} is not a level of the "
                         f"{rp.prev_levels}-level pyramid")
    if rp.term == "hiz" and rp.hiz_levels < HIZ_MAX_LEVEL + 1:
        raise ValueError(f"{fn}: the hi-z walk reaches level {HIZ_MAX_LEVEL}; gi_hiz_levels "
                         f"must be at least {HIZ_MAX_LEVEL + 1}")
    if rp.term != "hiz" and rp.k_points < 1:
        raise ValueError(f"{fn}: gi_fast_probe_points must be at least 1")


def probe_prev_pack(prev_atlas, rp):
    """The previous frame as the probe and hi-z terms sample it
    (gi_modes.py:147 _probe_prev_setup): the f16 2x2 window pack of the bf16
    pyramid's level rp.probe_level, or with rp.dist_mip > 0 of the whole
    pyramid.  Returns (pack, (texel rows, columns) of its base)."""
    if rp.dist_mip > 0.0:
        return (sampling.window_pack(prev_atlas.to(torch.float32), 2, 2, dtype=torch.float16),
                (rp.prev_h, rp.prev_w))
    lv = rp.probe_level
    offs, _ = sampling.mip_offsets(rp.prev_h, rp.prev_w, rp.prev_levels)
    plh, plw = rp.prev_h >> lv, rp.prev_w >> lv
    return (sampling.window_pack(prev_atlas[:plh, offs[lv]:offs[lv] + plw], 2, 2,
                                 dtype=torch.float16), (plh, plw))


def _xform_dirs(m, v):
    """m3.transform_dirs in PyTorch's elementwise order: (x*m0 + y*m1) + z*m2."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return (x * m[:3, 0] + y * m[:3, 1]) + z * m[:3, 2]


def screen_ray_resolve_plain(table, fgrid, depth, prev_atlas, clip_from_world, world_from_clip,
                             view_from_world, camera_pos, pw, rd_unit, noise, foggyness, rp,
                             work=None):
    """One ray per lane of the fast GI with the probe or hi-z screen term
    (rp.kind "fog" / "march") or of its economy mode (rp.kind "fast").

    "fog" / "march": the fog march (sample_radiance_fog; on the nearest f16
    grid fgrid, or trilinear on the u8 table when fgrid is None) or the
    wave-9 march (sample_radiance_march, rp.rgb_samples) from world
    position pw along rd_unit, then the screen term over [pw, first open]
    in grid NDC ([pw, march stop] with rp.to_stop): "hiz" screen_trace_hiz
    on the hi-z pyramid `depth` (build_hiz_atlas of an rp.hiz_h x rp.hiz_w
    depth), "probes" screen_probe_multi on the probe depth `depth` with
    every knob (the overshoot, spacings, jitter, solidity taps, dist_mip)
    and, with rp.edge_fallback, the lightgrid 2.5 voxels camera-ward where
    the probes left the screen first.  "fast": sample_radiance_fast, then
    (term "probe") march_to_hit when rp.march_steps > 0 and the probe from
    the surface on the full-resolution depth `depth`: screen_probe_multi of
    rp.k_points points, or screen_probe with one.  The previous frame is
    the f16 pack of the bf16 pyramid prev_atlas (probe_prev_pack).

    table: quantize_grid_u8 [D,H,W,4]; the matrices [4,4]; camera_pos [3];
    pw, rd_unit [...,3] f32; noise [...] f32 and foggyness (a float or
    [...] f32) for "fog" / "march".  work: an optional dict of each lane's
    step counts.  Returns (rgb [...,3] f32, status [...] int32): 1 the edge
    fallback, 3 resolved on screen, 2 the march result."""
    _check_screen_params(rp, "screen_ray_resolve")
    scale = rp.lightgrid_scale
    ro0 = pw * scale
    status = torch.full(pw.shape[:-1], 2, dtype=torch.int32, device=pw.device)
    if rp.kind == "fast":
        rgb, ro_open = sample_radiance_fast(table, pw, rd_unit, scale, rp.dist_voxels,
                                            rp.skip_steps, rp.open_thresh, rp.rgb_samples,
                                            rp.sample_spread, alpha_grid=table, work=work)
        if rp.term is None:
            return rgb, status
        hit_m = None
        if rp.march_steps > 0:
            ro_open, hit_m = march_to_hit(table, ro_open,
                                          rd_unit * (rp.voxel_step * rp.step_scale),
                                          rp.march_steps, work=work)
        wprev, prev_hw = probe_prev_pack(prev_atlas, rp)
        if rp.k_points > 1:
            mip = dict(prev_levels=rp.prev_levels, dist_mip=rp.dist_mip) if rp.dist_mip > 0.0 \
                else {}
            hit, ss_rgb = screen_probe_multi(ro0, ro_open, scale, clip_from_world, depth, wprev,
                                             prev_hw, rp.ss_intensity, z_margin=rp.z_margin,
                                             k_points=rp.k_points, work=work, **mip)
        else:
            _count(work, "probe", torch.ones_like(status, dtype=torch.bool))
            hit, ss_rgb = screen_probe(ro_open, scale, clip_from_world, depth, wprev, prev_hw,
                                       rp.ss_intensity, z_margin=rp.z_margin)
        if hit_m is not None:
            hit = hit & hit_m
        _count(work, "resolve", hit)
        return torch.where(hit[..., None], ss_rgb, rgb), torch.where(hit, 3, status)
    if rp.kind == "fog":
        rgb, ro_open, ro_stop, _, _ = sample_radiance_fog(
            fgrid, pw, rd_unit, scale, skip_steps=rp.skip_steps, open_thresh=rp.open_thresh,
            march_steps=rp.march_steps, step_scale=rp.step_scale, noise=noise,
            foggyness=foggyness, trilinear_grid=table if fgrid is None else None,
            jitter_scale=rp.jitter_scale, work=work)
    else:
        rgb, ro_open, ro_stop, _, _ = sample_radiance_march(
            table, table, pw, rd_unit, scale, skip_steps=rp.skip_steps,
            open_thresh=rp.open_thresh, hit_steps=rp.march_steps, step_scale=rp.step_scale,
            noise=noise, rgb_samples=rp.rgb_samples, work=work)
    if rp.term is None:
        return rgb, status
    if rp.to_stop:
        ro_open = ro_stop
    wprev, prev_hw = probe_prev_pack(prev_atlas, rp)
    if rp.term == "hiz":
        offs, _ = sampling.mip_offsets(rp.hiz_h, rp.hiz_w, rp.hiz_levels)
        hit, ss_rgb = screen_trace_hiz(
            ro0, ro_open, scale, clip_from_world, depth, torch.tensor(offs, dtype=torch.int32),
            (rp.hiz_h, rp.hiz_w), wprev, prev_hw, rp.ss_intensity, alpha_grid=table,
            iters=rp.hiz_iters, thickness=rp.hiz_thickness, z_bias=rp.hiz_bias,
            solid_thresh=rp.hiz_solid, zview_nf=(rp.z_near, rp.z_far), work=work)
    else:
        ro_end = ro_open
        if rp.overshoot > 0.0:
            seg_g = ro_open - ro0
            dvs = _xform_dirs(view_from_world, seg_g)
            ov = _norm3(dvs) / torch.clamp(_norm2(dvs), min=1e-6)
            ov = torch.clamp(ov, max=rp.overshoot)
            ro_end = ro0 + seg_g * ov[..., None]
        mip = dict(prev_levels=rp.prev_levels, dist_mip=rp.dist_mip) if rp.dist_mip > 0.0 \
            else {}
        hit, ss_rgb, off = screen_probe_multi(
            ro0, ro_end, scale, clip_from_world, depth, wprev, prev_hw, rp.ss_intensity,
            z_margin=rp.z_margin, k_points=rp.k_points, want_offscreen=True,
            spacing_gamma=rp.gamma, spacing_growth=rp.growth, point_jitter=rp.jitter,
            solid_taps=rp.solid_taps, alpha_grid=table, world_from_clip=world_from_clip,
            noise=noise, work=work, **mip)
        if rp.edge_fallback:
            _count(work, "fallback", off)
            v_cam = m3.normalize(camera_pos - pw)
            fb = grid_sample(table, ro0 + v_cam * (2.5 * rp.voxel_step))[..., :3]
            rgb = torch.where(off[..., None], colorlib.tone_compress_sqrt(fb), rgb)
            status = torch.where(off, 1, status)
    _count(work, "resolve", hit)
    return torch.where(hit[..., None], ss_rgb, rgb), torch.where(hit, 3, status)


SCREEN_MAX_POINTS, SCREEN_MAX_TAPS, SCREEN_MAX_SAMPLES = 16, 8, 8   # csrc/gi_screen_ray.cu
_TERMS = {None: 0, "probes": 1, "hiz": 2, "probe": 3}


class _ScreenArgs(ctypes.Structure):
    """struct ScreenArgs of csrc/gi_screen_ray.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "table", "fgrid", "depth", "atlas", "clip_from_world", "world_from_clip",
        "view_from_world", "camera_pos", "pw", "rd", "noise", "fog_lane", "out_rgb",
        "out_status")] + [(n, ctypes.c_float) for n in (
            "fog", "scale", "inv_scale", "voxel", "open_thresh", "step_scale", "jitter_scale",
            "ss_intensity", "hit_step", "fb_step", "z_margin", "jitter_k", "overshoot",
            "dist_mip", "inv_seg_scale", "hiz_thickness", "hiz_bias", "hiz_solid", "zv_num",
            "zv_far", "zv_span", "inv_hiz_w", "inv_hiz_h", "taps_half")]
        + [("fracs", ctypes.c_float * SCREEN_MAX_POINTS),
           ("tap_fracs", ctypes.c_float * SCREEN_MAX_TAPS),
           ("sample_off", ctypes.c_float * SCREEN_MAX_SAMPLES)]
        + [(n, ctypes.c_int) for n in (
            "n", "gd", "gh", "gw", "th", "tw", "atlas_h", "atlas_wa", "prev_h", "prev_w",
            "prev_levels", "plh", "plw", "level_off", "skip_steps", "march_steps", "samples",
            "term", "to_stop", "edge_fallback", "k_points", "solid_taps", "jitter",
            "hiz_iters", "hiz_h", "hiz_w", "width", "tile_h")])


def _f32(x):
    return float(np.float32(x))


def _screen_shapes(fn, rp, pw_shape, table_shape, depth_shape, atlas_shape):
    """The checks of a screen kernel's shapes and rp that a plan is made
    from (ValueError); None stands for an input that is no tensor."""
    _check_screen_params(rp, fn)
    if pw_shape is None or len(pw_shape) < 1 or pw_shape[-1] != 3:
        raise ValueError(f"{fn}: pw must be a [..., 3] tensor")
    if table_shape is None or len(table_shape) != 4 or table_shape[-1] != 4 or min(
            table_shape) < 1:
        raise ValueError(f"{fn}: table must be a [D, H, W, 4] tensor")
    if rp.term is None:
        return
    if depth_shape is None or len(depth_shape) != 2 or min(depth_shape) < 1:
        raise ValueError(f"{fn}: depth must be an [Ht, Wt] tensor")
    if rp.term == "hiz":
        _, wa = sampling.mip_offsets(rp.hiz_h, rp.hiz_w, rp.hiz_levels)
        if tuple(depth_shape) != (rp.hiz_h, wa):
            raise ValueError(f"{fn}: the hi-z atlas must be [{rp.hiz_h}, {wa}] for a "
                             f"{rp.hiz_h}x{rp.hiz_w} depth of {rp.hiz_levels} levels")
    if rp.term != "hiz" and rp.k_points > SCREEN_MAX_POINTS:
        raise ValueError(f"{fn}: the kernel takes at most {SCREEN_MAX_POINTS} probe points")
    if rp.solid_taps > SCREEN_MAX_TAPS or max(1, rp.rgb_samples) > SCREEN_MAX_SAMPLES:
        raise ValueError(f"{fn}: the kernel takes at most {SCREEN_MAX_TAPS} solidity taps and "
                         f"{SCREEN_MAX_SAMPLES} samples")
    if not 1 <= rp.prev_levels <= MAX_LEVELS:
        raise ValueError(f"{fn}: the pyramid has {rp.prev_levels} levels; the kernel takes 1 "
                         f"to {MAX_LEVELS}")
    _, wa = sampling.mip_offsets(rp.prev_h, rp.prev_w, rp.prev_levels)
    if (atlas_shape is None or len(atlas_shape) != 3 or atlas_shape[0] < rp.prev_h
            or atlas_shape[1] < wa or atlas_shape[2] != 3):
        raise ValueError(f"{fn}: prev_atlas must be [>={rp.prev_h}, >={wa}, 3] for the "
                         f"pyramid of {rp.prev_levels} levels")


def _screen_check(fn, table, fgrid, depth, prev_atlas, mats, pw, rd_unit, noise, foggyness, rp):
    """The full checks of a screen kernel's inputs (ValueError)."""
    _screen_shapes(fn, rp, _shape(pw), _shape(table), _shape(depth), _shape(prev_atlas))
    dev = pw.device
    cuda_build.need(pw, "pw", fn, dev, pw.shape)
    cuda_build.need(rd_unit, "rd_unit", fn, dev, pw.shape)
    cuda_build.need(table, "table", fn, dev, dtype=torch.uint8)
    if table.is_cuda and table.data_ptr() % 4:
        raise ValueError(f"{fn}: table must start on a 4-byte boundary (read as words)")
    names = ("clip_from_world", "world_from_clip", "view_from_world", "camera_pos")
    for t, what in zip(mats, names):
        if t is not None:
            cuda_build.need(t, what, fn, dev, (3,) if what == "camera_pos" else (4, 4))
    if rp.kind != "fast":
        cuda_build.need(noise, "noise", fn, dev, pw.shape[:-1])
        if torch.is_tensor(foggyness):
            cuda_build.need(foggyness, "foggyness", fn, dev, pw.shape[:-1])
        elif not isinstance(foggyness, (int, float, np.floating)):
            raise ValueError(f"{fn}: foggyness must be a number or a tensor of the lanes' shape")
        if fgrid is not None:
            cuda_build.need(fgrid, "fgrid", fn, dev, table.shape, dtype=torch.float16)
            if fgrid.is_cuda and fgrid.data_ptr() % 8:
                raise ValueError(f"{fn}: fgrid must start on an 8-byte boundary")
        for t, what in zip(mats, names):
            if t is None:
                raise ValueError(f"{fn}: {what} is required")
    elif mats[0] is None:
        raise ValueError(f"{fn}: clip_from_world is required")
    if rp.term is not None:
        cuda_build.need(depth, "depth", fn, dev)
        cuda_build.need(prev_atlas, "prev_atlas", fn, dev, dtype=torch.bfloat16)


class _ScreenPlan(_RayPlan):
    """What a launch of gi_screen_ray or gi_probe_ray of one shape keeps
    between calls (_RayPlan's lane grid, specs, lock and output layout):
    the struct with every per-shape field and rp's scalars set (the host's
    f32 fractions and reciprocals among them).  A call allocates the
    outputs anew and sets the data pointers and the scalar foggyness under
    the plan's lock.  The constructor raises _screen_shapes' ValueErrors."""

    def __init__(self, fn, device, pw_shape, table_shape, depth_shape, atlas_shape, rp,
                 nearest, fog_lane):
        _screen_shapes(fn, rp, pw_shape, table_shape, depth_shape, atlas_shape)
        lane_shape = tuple(pw_shape[:-1])
        f32 = torch.float32
        fog = self.fog = rp.kind != "fast"
        screen = rp.term is not None
        # the inputs in run_screen_ray's order
        super().__init__(device, lane_shape, (
            (torch.uint8, table_shape), (torch.float16, table_shape) if nearest else "none",
            (f32, depth_shape) if screen else None,
            (torch.bfloat16, atlas_shape) if screen else None, (f32, (4, 4)),
            (f32, (4, 4)) if fog else "none", (f32, (4, 4)) if fog else "none",
            (f32, (3,)) if fog else "none", (f32, tuple(pw_shape)), (f32, tuple(pw_shape)),
            (f32, lane_shape) if fog else None, (f32, lane_shape) if fog_lane else "none"))
        scale = rp.lightgrid_scale
        fracs = probe_fractions(rp.k_points, rp.gamma, rp.growth) if rp.term in (
            "probes", "probe") else ()
        taps = rp.solid_taps if rp.term == "probes" else 0
        offsets = [rp.dist_voxels - 2.0 + k * rp.sample_spread
                   for k in range(max(1, rp.rgb_samples))] if rp.kind == "fast" else []
        # the probe level's texels and first column (a per-lane level with dist_mip)
        lv = rp.probe_level if rp.dist_mip <= 0.0 else 0
        plh, plw = rp.prev_h >> lv, rp.prev_w >> lv
        offs, _ = sampling.mip_offsets(rp.prev_h, rp.prev_w, rp.prev_levels)
        zn, zf = rp.z_near, rp.z_far
        self.args = _ScreenArgs(
            scale=scale, inv_scale=_f32(np.float32(1.0) / np.float32(scale)),
            voxel=2.0 / table_shape[0], open_thresh=rp.open_thresh, step_scale=rp.step_scale,
            jitter_scale=rp.jitter_scale, ss_intensity=rp.ss_intensity,
            hit_step=rp.voxel_step * rp.step_scale, fb_step=2.5 * rp.voxel_step,
            z_margin=rp.z_margin, jitter_k=rp.jitter / max(rp.k_points, 1),
            overshoot=rp.overshoot, dist_mip=rp.dist_mip,
            inv_seg_scale=_f32(np.float32(1.0) / np.float32(max(scale, 1e-8))),
            hiz_thickness=rp.hiz_thickness, hiz_bias=rp.hiz_bias, hiz_solid=rp.hiz_solid,
            zv_num=zf * zn, zv_far=zf, zv_span=zf - zn,
            inv_hiz_w=_f32(np.float32(1.0) / np.float32(max(rp.hiz_w, 1))),
            inv_hiz_h=_f32(np.float32(1.0) / np.float32(max(rp.hiz_h, 1))),
            taps_half=0.5 * taps,
            fracs=(ctypes.c_float * SCREEN_MAX_POINTS)(*fracs),
            tap_fracs=(ctypes.c_float * SCREEN_MAX_TAPS)(
                *(t / (taps + 1.0) for t in range(1, taps + 1))),
            sample_off=(ctypes.c_float * SCREEN_MAX_SAMPLES)(*offsets),
            n=math.prod(lane_shape), gd=table_shape[0], gh=table_shape[1], gw=table_shape[2],
            th=depth_shape[0] if screen else 0, tw=depth_shape[1] if screen else 0,
            atlas_h=atlas_shape[0] if screen else 0, atlas_wa=atlas_shape[1] if screen else 0,
            prev_h=rp.prev_h, prev_w=rp.prev_w, prev_levels=rp.prev_levels, plh=plh, plw=plw,
            level_off=offs[lv], skip_steps=rp.skip_steps, march_steps=rp.march_steps,
            samples=max(1, rp.rgb_samples), term=_TERMS[rp.term], to_stop=int(rp.to_stop),
            edge_fallback=int(rp.edge_fallback), k_points=rp.k_points, solid_taps=taps,
            jitter=int(rp.jitter > 0.0 and rp.kind != "fast"), hiz_iters=rp.hiz_iters,
            hiz_h=rp.hiz_h, hiz_w=rp.hiz_w, width=self.width, tile_h=self.tile_h)

    def accepts(self, ts, foggyness):
        """Whether the inputs ts (run_screen_ray's order, the foggyness
        tensor or None last) meet the plan's specs, the grids start on
        their word boundaries, and a scalar foggyness is a number (None for
        the economy mode)."""
        scalar = (int, float, np.floating) if self.fog else (type(None),)
        if self.specs[-1] == "none" and not isinstance(foggyness, scalar):
            return False
        return (self.matches(ts) and ts[0].data_ptr() % 4 == 0
                and (ts[1] is None or ts[1].data_ptr() % 8 == 0))


@functools.lru_cache(maxsize=16)
def _screen_plan(fn, device, stream, pw_shape, table_shape, depth_shape, atlas_shape, rp,
                 nearest, fog_lane):
    return _ScreenPlan(fn, device, pw_shape, table_shape, depth_shape, atlas_shape, rp,
                       nearest, fog_lane)


def run_screen_ray(fn, table, fgrid, depth, prev_atlas, clip_from_world, world_from_clip,
                   view_from_world, camera_pos, pw, rd_unit, noise, foggyness, rp):
    """One launch of csrc/gi_screen_ray.cu's kernel for `fn`
    ("screen_ray_resolve": gi_screen_ray, "probe_ray_resolve": gi_probe_ray)
    on checked CUDA inputs, on the current stream with no host sync, through
    the plan of their shapes (_ScreenPlan): a call's inputs are compared
    with the plan's, and checked in full (ValueError) where that comparison
    fails.  Returns (rgb, status)."""
    mats = (clip_from_world, world_from_clip, view_from_world, camera_pos)
    dev = pw.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    screen = rp.term is not None
    fog_lane = torch.is_tensor(foggyness)
    plan = _screen_plan(fn, dev, stream, tuple(pw.shape), _shape(table),
                        _shape(depth) if screen else None,
                        _shape(prev_atlas) if screen else None, rp, fgrid is not None, fog_lane)
    ts = (table, fgrid, depth, prev_atlas, *mats, pw, rd_unit, noise,
          foggyness if fog_lane else None)
    if not plan.accepts(ts, foggyness):
        _screen_check(fn, table, fgrid, depth, prev_atlas, mats, pw, rd_unit, noise, foggyness,
                      rp)
    rgb, status = plan.outputs()
    lib = _screen_library()
    with plan.lock:
        args = plan.args
        args.table, args.fgrid = _ptr(table), _ptr(fgrid)
        args.depth = _ptr(depth) if screen else None
        args.atlas = _ptr(prev_atlas) if screen else None
        (args.clip_from_world, args.world_from_clip, args.view_from_world,
         args.camera_pos) = (_ptr(t) for t in mats)
        args.pw, args.rd, args.noise = _ptr(pw), _ptr(rd_unit), _ptr(noise)
        args.fog_lane = foggyness.data_ptr() if fog_lane else None
        args.fog = 0.0 if fog_lane or foggyness is None else float(foggyness)
        args.out_rgb, args.out_status = rgb.data_ptr(), status.data_ptr()
        launch = lib.gi_probe_ray_launch if rp.kind == "fast" else lib.gi_screen_ray_launch
        err = launch(ctypes.byref(args), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return rgb, status


def screen_ray_resolve(table, fgrid, depth, prev_atlas, clip_from_world, world_from_clip,
                       view_from_world, camera_pos, pw, rd_unit, noise, foggyness, rp):
    """screen_ray_resolve_plain's (rgb, status) for rp.kind "fog" (the fog
    march with the probes or hiz screen term).  A CUDA tensor launches
    csrc/gi_screen_ray.cu's gi_screen_ray once through a plan cached per
    shape and stream (_ScreenPlan), or raises; a CPU tensor takes the plain
    version after the full checks (ValueError), which on the card run where
    the plan refuses the inputs.  No host sync.
    `screen_ray_resolve.launches` counts launches."""
    fn = "screen_ray_resolve"
    if rp.kind != "fog" or rp.term not in ("probes", "hiz"):
        raise ValueError(f"{fn}: takes the fog march with the probes or hiz term, got kind "
                         f"{rp.kind!r}, term {rp.term!r} (the wave-9 march has no kernel: "
                         "screen_ray_resolve_plain runs it)")
    mats = (clip_from_world, world_from_clip, view_from_world, camera_pos)
    if not torch.is_tensor(pw) or not pw.is_cuda:
        _screen_check(fn, table, fgrid, depth, prev_atlas, mats, pw, rd_unit, noise, foggyness,
                      rp)
        return screen_ray_resolve_plain(table, fgrid, depth, prev_atlas, *mats, pw, rd_unit,
                                        noise, foggyness, rp)
    out = run_screen_ray(fn, table, fgrid, depth, prev_atlas, *mats, pw,
                         rd_unit, noise, foggyness, rp)
    screen_ray_resolve.launches += 1
    return out


screen_ray_resolve.launches = 0


def probe_ray_resolve(table, depth, prev_atlas, clip_from_world, pw, rd_unit, rp):
    """screen_ray_resolve_plain's (rgb, status) for rp.kind "fast" (the
    economy mode's ray; depth the full-resolution depth, prev_atlas the
    bf16 pyramid, both unused without a screen term).  A CUDA tensor
    launches csrc/gi_screen_ray.cu's gi_probe_ray once through a plan cached
    per shape and stream, or raises; a CPU tensor takes the plain version.
    `probe_ray_resolve.launches` counts launches."""
    fn = "probe_ray_resolve"
    if rp.kind != "fast":
        raise ValueError(f"{fn}: takes the economy mode's ray (kind 'fast'), got {rp.kind!r}")
    mats = (clip_from_world, None, None, None)
    if not torch.is_tensor(pw) or not pw.is_cuda:
        _screen_check(fn, table, None, depth, prev_atlas, mats, pw, rd_unit, None, None, rp)
        return screen_ray_resolve_plain(table, None, depth, prev_atlas, *mats, pw, rd_unit,
                                        None, None, rp)
    out = run_screen_ray(fn, table, None, depth, prev_atlas, *mats, pw,
                         rd_unit, None, None, rp)
    probe_ray_resolve.launches += 1
    return out


probe_ray_resolve.launches = 0


@functools.cache
def _screen_library():
    """The built library of csrc/gi_screen_ray.cu."""
    lib = cuda_build.load_library("gi_screen_ray")
    for name in ("gi_screen_ray_launch", "gi_probe_ray_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def screen_ray_occupancy(which):
    """{registers, local_bytes, blocks_per_sm, threads} of csrc/gi_screen_ray.cu's
    kernel on the current card: which "probe" (gi_probe_ray), "probes" or
    "hiz" (gi_screen_ray's terms, trilinear march)."""
    lib = _screen_library()
    names = ("registers", "local_bytes", "blocks_per_sm", "threads")
    vals = [ctypes.c_int() for _ in names]
    fn = lib.gi_screen_ray_occupancy
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * len(names)
    fn.restype = ctypes.c_int
    err = fn({"probe": 0, "probes": 1, "hiz": 2}[which], *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"gi_screen_ray_occupancy failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return {n: v.value for n, v in zip(names, vals)}
