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
   card, `reference_ray_resolve_plain` on the CPU.

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


def ray_params(cfg, march_steps, step_scale, ss_intensity, prev_h, prev_w):
    """RayParams of one ray of the fast GI under `cfg`."""
    return RayParams(
        lightgrid_scale=cfg.lightgrid_scale, voxel_step=2.0 / cfg.lightgrid_size,
        skip_steps=cfg.gi_fast_skip_steps, open_thresh=cfg.gi_fast_open_thresh,
        march_steps=march_steps, step_scale=step_scale,
        jitter_scale=cfg.gi_fast_jitter_scale, ss_intensity=ss_intensity,
        screen=cfg.gi_fast_screen_probe, trace_steps=cfg.gi_trace_steps,
        trace_rounds=cfg.gi_trace_rounds, trace_steps2=cfg.gi_trace_steps2,
        solid_taps=cfg.gi_trace_solid_taps, prev_h=prev_h, prev_w=prev_w,
        prev_levels=cfg.bloom_pass_count)


def fast_ray_resolve_plain(table, fgrid, trace_tbl, prev_atlas, view_from_world,
                           clip_from_view, world_from_view, camera_pos, pw, rd_unit, pv, noise,
                           foggyness, rp, work=None):
    """The fast-GI radiance of one ray per lane: the fog march
    (sample_radiance_fog) from world position pw along rd_unit, then, with
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
    rgb, ro_open, _, _, _ = sample_radiance_fog(
        fgrid, pw, rd_unit, scale, skip_steps=rp.skip_steps, open_thresh=rp.open_thresh,
        march_steps=rp.march_steps, step_scale=rp.step_scale, noise=noise,
        foggyness=foggyness, trilinear_grid=table if fgrid is None else None,
        jitter_scale=rp.jitter_scale, work=work)
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


class _RefPlan:
    """What a reference-ray launch of one shape keeps between calls: the
    struct with every per-shape field set (the grid's, the trace table's and
    the pyramid's sizes, the lane grid and its tiles, rp's scalars), the
    inputs' dtypes and shapes, which each call's inputs are compared with
    (`accepts`), and the outputs' layout in one allocation (rgb, then the
    status on a 128-byte line).  A call allocates that buffer anew
    (`outputs`) and sets the data pointers and the scalar foggyness under
    the plan's lock.  The constructor raises _ref_shapes' ValueErrors."""

    def __init__(self, device, pw_shape, table_shape, depth_shape, atlas_shape, rp, fog_lane):
        _ref_shapes(pw_shape, table_shape, depth_shape, atlas_shape, rp)
        lane_shape = pw_shape[:-1]
        rows, width = lane_grid(lane_shape)
        n = math.prod(lane_shape)
        f32 = np.float32
        self.device, self.lock, self.fog_lane = device, threading.Lock(), fog_lane
        self.lane_shape = lane_shape
        self.specs = ([(torch.uint8, table_shape), (torch.float32, depth_shape),
                       (torch.bfloat16, atlas_shape)] + [(torch.float32, (4, 4))] * 4
                      + [(torch.float32, pw_shape)] * 4
                      + [(torch.float32, lane_shape)] * (2 if fog_lane else 1))
        self.status_off = -(-3 * n // 32) * 32
        self.total = self.status_off + n
        self.tile_h = lane_tile_h(rows)
        self.args = _RefArgs(
            scale=rp.lightgrid_scale,
            # PyTorch on the card divides by a Python number as a product with
            # its f32 reciprocal (ro / lightgrid_scale): the kernel does too
            inv_scale=float(f32(1.0) / f32(rp.lightgrid_scale)),
            voxel=2.0 / table_shape[0], half_scale=rp.lightgrid_scale * 0.5,
            step_scale=rp.step_scale, ss_intensity=rp.ss_intensity, n=n, gd=table_shape[0],
            gh=table_shape[1], gw=table_shape[2], th=depth_shape[0], tw=depth_shape[1],
            atlas_wa=atlas_shape[1], prev_h=rp.prev_h, prev_w=rp.prev_w,
            prev_levels=rp.prev_levels, num_steps=rp.num_steps, max_ss_steps=rp.max_ss_steps,
            width=max(width, 1), tile_h=self.tile_h)

    def accepts(self, ts, foggyness):
        """Whether the inputs ts (table, trace depth, pyramid, the four
        matrices, vd, pv, pw, rd_unit, noise[, foggyness]) have the plan's
        dtypes and shapes, are contiguous and on its card, the table starts
        on a 4-byte boundary, and a scalar foggyness is a number."""
        if not self.fog_lane and not isinstance(foggyness, (int, float, np.floating)):
            return False
        for t, (dtype, shape) in zip(ts, self.specs):
            if (not torch.is_tensor(t) or t.dtype is not dtype or t.shape != shape
                    or not t.is_contiguous() or t.device != self.device):
                return False
        return len(ts) == len(self.specs) and ts[0].data_ptr() % 4 == 0

    def outputs(self):
        """A fresh (rgb, status): views of one new allocation."""
        buf = torch.empty(self.total, dtype=torch.float32, device=self.device)
        n = self.total - self.status_off
        return (buf[:3 * n].view(self.lane_shape + (3,)),
                buf[self.status_off:].view(torch.int32).view(self.lane_shape))


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
