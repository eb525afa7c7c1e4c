"""Deferred G-buffer assembly from the visibility buffer (counterpart of
vulkan_pbr_renderer_tpu/shade/gbuffer.py, geometry_pass.glsl:255-352).

Per pixel: fetch the covering triangle's setup and attributes, interpolate
with perspective-correct barycentrics, take exact analytic screen
derivatives (the replacement for dFdx/dFdy), sample the u8 material atlas
with derivative-based mip selection, apply the alpha test and the
derivative-TBN normal mapping, and reconstruct world position (and the
velocity) by unprojecting the rasterizer's depth.

`gbuffer_pass` dispatches: a CUDA tensor launches csrc/gbuffer.cu's
gbuffer_kernel, a block per 2D tile of pixels and a thread per pixel; a CPU
tensor takes `gbuffer_pass_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..gpu import cuda_build, sampling
from ..raster.setup import TriSetup
from ..utils import math3d as m3
from ..utils import noise as noiselib


class GBuffer(NamedTuple):
    base_color: torch.Tensor   # [H,W,3] linear albedo
    normal: torch.Tensor       # [H,W,3] world-space, unit (mapped)
    orm: torch.Tensor          # [H,W,3]
    emissive: torch.Tensor     # [H,W,3]
    depth: torch.Tensor        # [H,W] ndc z in [0,1]; 1.0 where empty
    velocity: torch.Tensor     # [H,W,2] ndc velocity (cur - prev), jitter-free
    coverage: torch.Tensor     # [H,W] bool


def gbuffer_static(scene):
    """The per-scene f32 [T,16] attribute table the G-buffer reads by
    triangle id: uv0..2 (6, exact: their derivatives feed the mip level and
    the TBN), nrm0..2 (9, rounded through f16 like the reference package's
    packed row; renormalized after interpolation) and 2 * material id +
    (alpha-test flag), all exact in f32.  Built once per scene (the
    renderer keeps it in its FrameState); the per-frame part, the raster's
    adj and z_vert, is read where it lies."""
    nrm16 = scene.tri_attr[:, 9:18].to(torch.float16).to(torch.float32)
    code = scene.mat_id.to(torch.float32) * 2.0 + (scene.tri_alpha > 0.5).to(torch.float32)
    return torch.cat([scene.tri_attr[:, 18:24], nrm16, code[:, None]], dim=1).contiguous()


def _edge_eval(adj, cw, px, py):
    """e_j = sum_i adj[i,j] * p_i and W = cw . p for p = (px+.5, py+.5, 1)."""
    x = (px + 0.5)[..., None]
    y = (py + 0.5)[..., None]
    e = adj[..., 0, :] * x + adj[..., 1, :] * y + adj[..., 2, :]
    w = cw[..., 0] * x[..., 0] + cw[..., 1] * y[..., 0] + cw[..., 2]
    return e, w


def _lambda_and_derivs(adj, cw, px, py):
    """Perspective-correct barycentrics and their exact screen derivatives:
    d(lambda_j)/dx = (a_jx - lambda_j * W_x) / W."""
    e, w = _edge_eval(adj, cw, px, py)
    w = torch.where(torch.abs(w) < 1e-20, torch.full_like(w, 1e-20), w)
    lam = e / w[..., None]
    dlam_dx = (adj[..., 0, :] - lam * cw[..., 0:1]) / w[..., None]
    dlam_dy = (adj[..., 1, :] - lam * cw[..., 1:2]) / w[..., None]
    return lam, dlam_dx, dlam_dy


def _interp(attr_tri, lam):
    """attr_tri [...,3,A] interpolated by lam [...,3] -> [...,A]."""
    return (attr_tri[..., 0, :] * lam[..., 0:1]
            + attr_tri[..., 1, :] * lam[..., 1:2]
            + attr_tri[..., 2, :] * lam[..., 2:3])


def gbuffer_pass_plain(scene, static, setup: TriSetup, depth, tri_id, clip_from_world,
                       old_clip_from_world, alpha_threshold=0.3, world_from_clip=None,
                       jitter=None, material_filter="nearest", frame_idx_mod_59=None,
                       row_offset=0, full_size=None, work=None):
    """gbuffer_pass's G-buffer in PyTorch ops: each pixel's triangle row
    (adj, z_vert and the static attributes of gbuffer_static) gathered by
    id, then the interpolation, the material fetch, the alpha test, the TBN
    and the velocity as tensors.  The CPU's path, and csrc/gbuffer.cu's
    reference on the card.  work: a dict that receives each pixel's
    material atlas rows read ("atlas_rows", one [H,W] index per level
    sampled), for a count of the distinct rows a frame needs."""
    h, w = depth.shape
    fh, fw = (h, w) if full_size is None else full_size
    dev = depth.device
    depth = torch.where(torch.isinf(depth), 1.0, depth)
    covered = tri_id >= 0
    tid = torch.clamp(tri_id, min=0)
    if world_from_clip is None:
        world_from_clip = torch.linalg.inv(clip_from_world)

    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + row_offset).expand(h, w)

    n = setup.adj.shape[0]
    adj = sampling.take_rows(setup.adj.reshape(n, 9), tid).reshape(h, w, 3, 3)
    z_vert = sampling.take_rows(setup.z_vert, tid)
    row = sampling.take_rows(static, tid)                       # [H,W,16]
    uv_tri = row[..., 0:6].reshape(h, w, 3, 2)
    nrm_tri = row[..., 6:15].reshape(h, w, 3, 3)
    mat = torch.div(row[..., 15].to(torch.int32), 2, rounding_mode="floor")
    do_test = torch.remainder(row[..., 15].to(torch.int32), 2) == 1
    cw = adj[..., 0] + adj[..., 1] + adj[..., 2]                # adj @ ones

    lam, dlam_dx, dlam_dy = _lambda_and_derivs(adj, cw, px, py)
    n_geo = m3.normalize(_interp(nrm_tri, lam))
    uv = _interp(uv_tri, lam)
    duv_dx = _interp(uv_tri, dlam_dx)
    duv_dy = _interp(uv_tri, dlam_dy)

    # world position + derivatives by unprojecting the rasterizer's depth
    jx = 0.0 if jitter is None else jitter[0]
    jy = 0.0 if jitter is None else jitter[1]
    ndc_x = (px + 0.5) * (2.0 / fw) - 1.0 - jx
    ndc_y = (py + 0.5) * (2.0 / fh) - 1.0 - jy
    q = (world_from_clip[:, 0] * ndc_x[..., None]
         + world_from_clip[:, 1] * ndc_y[..., None]
         + world_from_clip[:, 2] * depth[..., None]
         + world_from_clip[:, 3])
    qw = q[..., 3:4]
    qw = torch.where(torch.abs(qw) < 1e-20, torch.full_like(qw, 1e-20), qw)
    world_pos = q[..., :3] / qw

    # d(z_ndc)/d(pixel) by the quotient rule on the rasterizer's z formula
    e, s_den = _edge_eval(adj, cw, px, py)
    s_den = torch.where(torch.abs(s_den) < 1e-20, torch.full_like(s_den, 1e-20), s_den)
    num = e[..., 1] * z_vert[..., 1] + e[..., 2] * z_vert[..., 2]
    dnum_dx = adj[..., 0, 1] * z_vert[..., 1] + adj[..., 0, 2] * z_vert[..., 2]
    dnum_dy = adj[..., 1, 1] * z_vert[..., 1] + adj[..., 1, 2] * z_vert[..., 2]
    dz_dx = (dnum_dx - (num / s_den) * cw[..., 0]) / s_den
    dz_dy = (dnum_dy - (num / s_den) * cw[..., 1]) / s_den

    def dworld(dndc_x, dndc_y, dndc_z):
        dq = (world_from_clip[:, 0] * dndc_x[..., None]
              + world_from_clip[:, 1] * dndc_y[..., None]
              + world_from_clip[:, 2] * dndc_z[..., None])
        return (dq[..., :3] - world_pos * dq[..., 3:4]) / qw

    dpos_dx = dworld(torch.full_like(px, 2.0 / fw), torch.zeros_like(px), dz_dx)
    dpos_dy = dworld(torch.zeros_like(px), torch.full_like(px, 2.0 / fh), dz_dy)

    # mip level from the uv footprint in texels (GL lod rule)
    ts = scene.tex_packed.shape[1]
    du = torch.maximum(torch.sum((duv_dx * ts) ** 2, -1),
                       torch.sum((duv_dy * ts) ** 2, -1))
    lod = 0.5 * m3.cpu_serial(torch.log2, torch.clamp(du, min=1e-12))
    lod = torch.clamp(lod, 0.0, 16.0)

    # "stochastic": the mip level dithered by frame noise makes the nearest-
    # mip fetch an unbiased estimator of the trilinear lerp, integrated by TAA
    rows = None if work is None else work.setdefault("atlas_rows", [])
    if material_filter == "stochastic" and frame_idx_mod_59 is not None:
        u = noiselib.frame_noise(px + 0.5, py + 0.5, frame_idx_mod_59,
                                 offset=(71.0, 13.0))
        texel = sampling.sample_mip_atlas_array_window_nearest(
            scene.tex_packed, mat, uv, lod + (u - 0.5), 12, scale=scene.tex_scale, rows=rows)
    else:
        sampler = (sampling.sample_mip_atlas_array_window_trilinear
                   if material_filter == "trilinear"
                   else sampling.sample_mip_atlas_array_window_nearest)
        texel = sampler(scene.tex_packed, mat, uv, lod, 12, scale=scene.tex_scale, rows=rows)
    base_color = texel[..., 0:4]
    nrm_xy = texel[..., 4:6]
    orm = texel[..., 6:9]
    emissive = texel[..., 9:12]

    # alpha test (geometry_pass.glsl:259): discard -> background
    covered = covered & torch.where(do_test, base_color[..., 3] >= alpha_threshold,
                                    torch.ones_like(do_test))
    albedo = torch.pow(torch.clamp(base_color[..., :3], min=0.0), 2.2)

    # derivative TBN + normal mapping (geometry_pass.glsl:277-310)
    tsn_xy = nrm_xy * 2.0 - 1.0
    tsn_z = m3.sqrt(torch.clamp(1.0 - torch.sum(tsn_xy ** 2, -1), min=0.0))
    handed = duv_dx[..., 0] * duv_dy[..., 1] - duv_dx[..., 1] * duv_dy[..., 0]

    def _ortho(v, n):
        return m3.normalize(v - n * m3.dot(v, n, keepdim=True))

    denorm_b = dpos_dx * duv_dy[..., 0:1] - dpos_dy * duv_dx[..., 0:1]
    b1 = _ortho(denorm_b, n_geo)
    t1 = m3.cross(b1, n_geo)
    denorm_t = dpos_dx * duv_dy[..., 1:2] - dpos_dy * duv_dx[..., 1:2]
    t2 = _ortho(denorm_t, n_geo)
    b2 = m3.cross(t2, n_geo)
    mirrored = (handed < 0.0)[..., None]
    t_vec = torch.where(mirrored, t1, t2)
    b_vec = torch.where(mirrored, b1, b2)
    normal = m3.normalize(t_vec * tsn_xy[..., 0:1] + b_vec * tsn_xy[..., 1:2]
                          + n_geo * tsn_z[..., None])
    normal = torch.where((torch.abs(handed) < 1e-20)[..., None], n_geo, normal)

    # velocity (geometry_pass.glsl:312): jitter-free ndc motion
    ndc_cur, _ = m3.project_points(clip_from_world, world_pos)
    ndc_old, _ = m3.project_points(old_clip_from_world, world_pos)
    velocity = ndc_cur[..., :2] - ndc_old[..., :2]

    cov3 = covered[..., None]
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return GBuffer(
        base_color=torch.where(cov3, albedo, 0.0),
        normal=torch.where(cov3, normal, up),
        orm=torch.where(cov3, orm, 0.0),
        emissive=torch.where(cov3, emissive, 0.0),
        depth=torch.where(covered, depth, 1.0),
        velocity=torch.where(cov3, velocity, 0.0),
        coverage=covered,
    )


FILTERS = {"nearest": 0, "trilinear": 1, "stochastic": 2}


class _GBufArgs(ctypes.Structure):
    """struct GBufArgs of csrc/gbuffer.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "adj", "z_vert", "attr", "atlas", "tex_scale", "depth", "tri_id", "clip_from_world",
        "old_clip_from_world", "world_from_clip", "jitter", "base_color", "normal", "orm",
        "emissive", "depth_out", "velocity", "coverage")] + [(n, ctypes.c_float) for n in (
            "alpha_threshold", "ndc_sx", "ndc_sy", "noise_offset", "ts")] + [
        (n, ctypes.c_int) for n in ("h", "w", "row_offset", "n_tris", "base", "wa", "levels",
                                    "filter")]


def gbuffer_pass(scene, setup: TriSetup, depth, tri_id, clip_from_world,
                 old_clip_from_world, alpha_threshold=0.3, world_from_clip=None,
                 jitter=None, material_filter="nearest", frame_idx_mod_59=None,
                 row_offset=0, full_size=None, static=None):
    """Assemble the G-buffer from depth / tri_id [H,W] (depth inf or 1.0
    where empty).  world_from_clip: inverse of the unjittered
    clip_from_world; jitter: the TAA ndc jitter [2] the rasterizer applied.
    In the row-sharded frame depth / tri_id hold the rows [row_offset,
    row_offset + H) of a full_size = (H_full, W) framebuffer, to which the
    pixel -> ndc mapping is relative.  static: gbuffer_static(scene), made
    here when not given.

    The inputs are checked first (ValueError; on the card, also that
    scene.tex_packed starts on a 16-byte boundary); then a CUDA tensor
    launches csrc/gbuffer.cu's gbuffer_kernel (or raises) and a CPU tensor
    takes gbuffer_pass_plain.  `gbuffer_pass.launches` counts launches."""
    if material_filter not in FILTERS:
        raise ValueError(f"gbuffer_pass: unknown material_filter {material_filter!r}")
    if static is None:
        static = gbuffer_static(scene)
    if world_from_clip is None:
        world_from_clip = torch.linalg.inv(clip_from_world)
    # the kernel reads its inputs as dense arrays (a raster band's depth and
    # ids can be views)
    depth, tri_id, clip_from_world, old_clip_from_world, world_from_clip = (
        t.contiguous() if torch.is_tensor(t) else t
        for t in (depth, tri_id, clip_from_world, old_clip_from_world, world_from_clip))
    jitter = jitter.contiguous() if jitter is not None else None
    dev = depth.device
    if depth.dim() != 2:
        raise ValueError(f"gbuffer_pass: depth must be [H, W], got {tuple(depth.shape)}")
    h, w = depth.shape
    n_tris = setup.adj.shape[0]
    fn = "gbuffer_pass"
    for t, what, shape, dtype in (
            (depth, "depth", None, None), (tri_id, "tri_id", (h, w), torch.int32),
            (setup.adj, "setup.adj", (n_tris, 3, 3), None),
            (setup.z_vert, "setup.z_vert", (n_tris, 3), None),
            (static, "static", (n_tris, 16), None),
            (clip_from_world, "clip_from_world", (4, 4), None),
            (old_clip_from_world, "old_clip_from_world", (4, 4), None),
            (world_from_clip, "world_from_clip", (4, 4), None),
            (scene.tex_packed, "scene.tex_packed", None, torch.uint8),
            (scene.tex_scale, "scene.tex_scale", (12,), None)):
        cuda_build.need(t, what, fn, dev, shape, dtype)
    if jitter is not None:
        cuda_build.need(jitter, "jitter", fn, dev, (2,))
    atlas = scene.tex_packed
    if atlas.dim() != 4 or atlas.shape[3] != 48:
        raise ValueError(f"{fn}: scene.tex_packed must be [L, S, Wa, 48], "
                         f"got {tuple(atlas.shape)}")
    stochastic = material_filter == "stochastic" and frame_idx_mod_59 is not None
    if not depth.is_cuda:
        return gbuffer_pass_plain(scene, static, setup, depth, tri_id, clip_from_world,
                                  old_clip_from_world, alpha_threshold, world_from_clip, jitter,
                                  material_filter, frame_idx_mod_59, row_offset, full_size)
    if atlas.data_ptr() % 16:
        raise ValueError(f"{fn}: scene.tex_packed must start on a 16-byte boundary (the "
                         f"kernel reads its 48-byte texels as three 16-byte loads)")
    fh, fw = (h, w) if full_size is None else full_size
    base = atlas.shape[1]
    levels = sampling.n_mip_levels(base, base)
    _, wa = sampling.mip_offsets(base, base, levels)
    if atlas.shape[2] != wa:
        raise ValueError(f"gbuffer_pass: scene.tex_packed's atlas is {atlas.shape[2]} wide, "
                         f"a {base}^2 mip atlas is {wa}")
    f32 = dict(dtype=torch.float32, device=dev)
    out = GBuffer(base_color=torch.empty((h, w, 3), **f32),
                  normal=torch.empty((h, w, 3), **f32), orm=torch.empty((h, w, 3), **f32),
                  emissive=torch.empty((h, w, 3), **f32), depth=torch.empty((h, w), **f32),
                  velocity=torch.empty((h, w, 2), **f32),
                  coverage=torch.empty((h, w), dtype=torch.bool, device=dev))
    noise_offset = (float(np.float32(1000.0 * 1.61803398875) * np.float32(frame_idx_mod_59))
                    if stochastic else 0.0)
    args = _GBufArgs(
        adj=setup.adj.data_ptr(), z_vert=setup.z_vert.data_ptr(), attr=static.data_ptr(),
        atlas=atlas.data_ptr(), tex_scale=scene.tex_scale.data_ptr(), depth=depth.data_ptr(),
        tri_id=tri_id.data_ptr(), clip_from_world=clip_from_world.data_ptr(),
        old_clip_from_world=old_clip_from_world.data_ptr(),
        world_from_clip=world_from_clip.data_ptr(),
        jitter=jitter.data_ptr() if jitter is not None else None,
        base_color=out.base_color.data_ptr(), normal=out.normal.data_ptr(),
        orm=out.orm.data_ptr(), emissive=out.emissive.data_ptr(),
        depth_out=out.depth.data_ptr(), velocity=out.velocity.data_ptr(),
        coverage=out.coverage.data_ptr(), alpha_threshold=alpha_threshold,
        ndc_sx=2.0 / fw, ndc_sy=2.0 / fh, noise_offset=noise_offset, ts=float(base),
        h=h, w=w, row_offset=row_offset, n_tris=n_tris, base=base, wa=wa, levels=levels,
        filter=FILTERS["stochastic" if stochastic else
                       ("nearest" if material_filter == "stochastic" else material_filter)])
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.gbuffer_launch(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gbuffer kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    gbuffer_pass.launches += 1
    return out


gbuffer_pass.launches = 0


def gbuffer_occupancy():
    """The built G-buffer kernel on the current card: {registers,
    local_bytes (a thread's local memory, where spills land), shared_bytes
    (a block's), blocks_per_sm (resident at once), tile_w, tile_h}."""
    return cuda_build.query_ints(_library(), "gbuffer_occupancy", (
        "registers", "local_bytes", "shared_bytes", "blocks_per_sm", "tile_w", "tile_h"))

def _library():
    """The built G-buffer library (csrc/gbuffer.cu)."""
    lib = cuda_build.load_library("gbuffer")
    lib.gbuffer_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gbuffer_launch.restype = ctypes.c_int
    return lib
