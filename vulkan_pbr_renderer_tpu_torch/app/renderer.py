"""The renderer (counterpart of vulkan_pbr_renderer_tpu/app/renderer.py).

Frame pass order (render.cpp:954-1196):
  1 sun depth (only when the sun moved)  2 voxelize (only when the sun
  moved)  3 lightgrid sweep  4 raster + G-buffer  5 lighting (voxel GI, fast
  or reference mode; or the lightgrid debug view)
  6 TAA resolve  7-8 bloom down/up  9 tonemap
Pass 3 is csrc/sweep.cu's kernel (the swept grid and the GI's u8 table in
one launch), pass 4's G-buffer csrc/gbuffer.cu's and pass 5
csrc/lighting.cu's (shafts, GI lane inputs, the full-resolution shade)
beside the GI rays' csrc/gi_fast_ray.cu; on the CPU their plain versions.
Passes 1 and 4 run, with raster_backend="pallas" (the name the JAX package
gives its kernel backend), the folded-tile kernel (csrc/vis_folded.cu; with
raster_hiz, its hierarchical-z variant csrc/vis_folded_hiz.cu) or, with
raster_kernel="rowblock", the rowblock kernel (csrc/vis_rowblock.cu); with
raster_backend="xla" the brute-force raster (raster/xla_raster.py), which
bins nothing and has no capacity limit.  Renderer's default "auto" takes
"xla" for scenes of at most 4096 triangles and "pallas" above.
PyTorch runs eagerly, so the frame is a plain function; the frame index and
the previous sun angle live on the host, so the "sun changed" test and the
sweep axis are Python branches with no device sync.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bake import ibl
from ..config import RenderConfig
from ..device import resolve_device
from ..gpu import sampling
from ..raster import setup as rsetup
from ..raster import visibility, visibility_v2, xla_raster
from ..shade import bloom as bloom_mod
from ..shade import gbuffer as gb
from ..shade import gi, gi_modes, lighting, shadow, taa
from ..utils import math3d as m3
from ..utils import noise as noiselib


@dataclasses.dataclass
class FrameState:
    """Temporal state carried across frames.  render_frame replaces the
    tensors it recomputes and keeps the others; the running overflow maximum
    is updated in place, so it never reallocates."""

    lightgrid: torch.Tensor          # [D,D,D,4] swept radiance grid
    sun_depth: torch.Tensor          # [S,S] cached sun shadow map
    taa_history: torch.Tensor        # [H,W,3] prev TAA output
    velocity_prev: torch.Tensor      # [H,W,2]
    prev_pyramid: torch.Tensor       # [H/2,Wa,3] bf16 prev bloom downscale atlas
    clip_from_world_prev: torch.Tensor  # [4,4]
    raster_overflow: torch.Tensor    # i32[2] running max of [max_tile_segment,
                                     # total_pairs] (the folded kernel
                                     # reports segment 0: it has no capacity)
    gi_cache: torch.Tensor           # [2,Hg,Wg,3] interleaved GI cache
                                     # (ambient, specular); [2,1,1,3] unused
    frame_idx: int = 0               # host
    sun_angle_prev: Optional[tuple] = None  # host; None before the first frame
    voxelize_count: int = 0          # host: voxelize passes run so far
    # tables the G-buffer and lighting kernels read, made on first use:
    sun_u16: Optional[torch.Tensor] = None         # [S,S] quantize_u16(sun_depth),
                                                   # remade with the sun depth
    gbuffer_static: Optional[torch.Tensor] = None  # [T,16] gbuffer_static(scene)
    brdf_lut16: Optional[torch.Tensor] = None      # [L,L,2] f16 brdf_lut
    voxel_plan: Optional[gi._VoxelPlan] = None     # voxelize's per-scene plan, made on the
                                                   # first sun pass (voxel_plan)


def frame_tables(state: FrameState, scene, brdf_lut, cfg, sun_depth, sun_changed):
    """(sun_u16, gbuffer_static, brdf_lut16) for this frame: the per-scene
    and per-bake tables made once and kept in `state`, the u16 sun map made
    again when the sun depth was redrawn (render_frame and the row-sharded
    frame share this)."""
    if state.gbuffer_static is None:
        state.gbuffer_static = gb.gbuffer_static(scene)
    if state.brdf_lut16 is None and (cfg.enable_gi or cfg.enable_ibl):
        state.brdf_lut16 = lighting.brdf_lut_f16(brdf_lut)
    sun_u16 = state.sun_u16
    if cfg.enable_shadows and (sun_changed or sun_u16 is None):
        sun_u16 = sampling.quantize_u16(sun_depth)
    return sun_u16, state.gbuffer_static, state.brdf_lut16


def voxel_plan(state: FrameState, scene, cfg):
    """The scene's voxelize plan (gi._VoxelPlan: its checks, the stream's
    offsets and the triangle rows), made on the first sun pass and kept in
    `state` (render_frame and the row-sharded frame share this)."""
    if state.voxel_plan is None:
        state.voxel_plan = gi._VoxelPlan(scene, cfg.lightgrid_size, cfg.lightgrid_scale,
                                         total_samples=cfg.voxelize_samples or (1 << 20))
    return state.voxel_plan


class CameraState(NamedTuple):
    """Host-computed camera matrices for one frame (camera.h:102-120)."""

    clip_from_world: torch.Tensor
    clip_from_view: torch.Tensor
    world_from_clip: torch.Tensor
    view_from_clip: torch.Tensor
    view_from_world: torch.Tensor
    world_from_view: torch.Tensor
    position: torch.Tensor           # [3]

    def to(self, device):
        return CameraState(*(t.to(device) for t in self))


def make_camera(position, target, cfg: RenderConfig, up=(0.0, 0.0, 1.0),
                device="cuda") -> CameraState:
    """The camera's matrices on `device` (the card unless the caller asks
    for the CPU; raises without one)."""
    device = resolve_device(device)
    view_from_world = m3.look_at(position, target, up)
    clip_from_view = m3.perspective_lh_zo(np.deg2rad(cfg.fov_y_deg), cfg.aspect,
                                          cfg.z_near, cfg.z_far)
    clip_from_world = clip_from_view @ view_from_world
    # row-major like the kernels read them (linalg.inv returns column-major)
    return CameraState(
        clip_from_world=clip_from_world,
        clip_from_view=clip_from_view,
        world_from_clip=m3.inverse(clip_from_world).contiguous(),
        view_from_clip=m3.inverse(clip_from_view).contiguous(),
        view_from_world=view_from_world,
        world_from_view=m3.inverse(view_from_world).contiguous(),
        position=torch.as_tensor(np.asarray(position, np.float32)),
    ).to(device)


def init_frame_state(cfg: RenderConfig, device) -> FrameState:
    h, w = cfg.height, cfg.width
    d, kg = cfg.lightgrid_size, cfg.gi_res_divisor
    _, pwa = sampling.mip_offsets(h // 2, w // 2, cfg.bloom_pass_count)
    f32 = dict(dtype=torch.float32, device=device)
    return FrameState(
        lightgrid=torch.zeros((d, d, d, 4), **f32),
        gi_cache=(torch.zeros((2, h // kg, w // kg, 3), **f32)
                  if gi_modes.gi_temporal_active(cfg)
                  else torch.zeros((2, 1, 1, 3), **f32)),
        sun_depth=torch.ones((cfg.shadow_map_size,) * 2, **f32),
        taa_history=torch.zeros((h, w, 3), **f32),
        velocity_prev=torch.zeros((h, w, 2), **f32),
        prev_pyramid=torch.zeros((h // 2, pwa, 3), dtype=torch.bfloat16, device=device),
        clip_from_world_prev=torch.eye(4, **f32),
        raster_overflow=torch.zeros((2,), dtype=torch.int32, device=device),
    )


RASTER_BACKENDS = ("xla", "pallas")
AUTO_XLA_MAX_TRIS = 4096


def resolve_raster_backend(raster_backend, num_tris):
    """"auto" -> "xla" for scenes of at most AUTO_XLA_MAX_TRIS triangles,
    else "pallas" (the JAX Renderer's rule); an unknown name raises."""
    if raster_backend == "auto":
        return "xla" if num_tris <= AUTO_XLA_MAX_TRIS else "pallas"
    if raster_backend not in RASTER_BACKENDS:
        raise ValueError(f"unknown raster_backend {raster_backend!r}: "
                         f"'auto', 'xla' or 'pallas'")
    return raster_backend


def _rasterize(scene, mat, width, height, cfg, jitter=None, cull="back",
               backend="xla", rows=None, y_origin=0):
    """Raster the scene -> (TriSetup, depth, tri_id, overflow i32[2] =
    [max_tile_segment, total_pairs]).  backend "pallas" bins and runs the
    kernel of cfg.raster_kernel / cfg.raster_hiz; "xla" is the brute-force
    raster, whose overflow is zero (it has no capacity).  With `rows`, only
    the band [y_origin, y_origin + rows) of the height-tall viewport is
    rastered (the row-sharded frame, sharding.py:66-96): the setup maps NDC
    to pixels over the whole viewport."""
    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    s = rsetup.transform_and_setup(tri_pos, mat, width, height, cull=cull, jitter=jitter)
    rows = height if rows is None else rows
    pair_capacity = cfg.pair_capacity_factor * scene.num_tris
    if resolve_raster_backend(backend, scene.num_tris) == "xla":
        depth, tri = xla_raster.rasterize_vis(s, width, rows, y_origin=y_origin)
        ovf = torch.zeros((2,), dtype=torch.int32, device=depth.device)
    elif cfg.raster_kernel == "rowblock":
        depth, tri, ovf = visibility.rasterize_vis_tiled(
            s, width, rows, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            tile_capacity=cfg.tile_capacity, chunk=cfg.tri_chunk,
            pair_capacity=pair_capacity, return_overflow=True, y_origin=y_origin)
    else:
        depth, tri, ovf = visibility_v2.rasterize_vis_folded(
            s, width, rows, chunk=cfg.tri_chunk, pair_capacity=pair_capacity,
            hiz=cfg.raster_hiz, y_origin=y_origin)
    return s, depth, tri, ovf


def sweep_rotated(lightgrid, frame_idx, cfg):
    """Pass 3: the lightgrid sweep, its axis rotating per frame
    (render.cpp:1064-1069): z, y, x for frame_idx % 3 = 0, 1, 2 — or per
    2-frame cycle under the interleave with gi_temporal_sweep="cycle".
    Returns (swept grid, its u8 table): gi.sweep_lightgrid_u8, one launch
    of csrc/sweep.cu on the card."""
    if cfg.gi_temporal_sweep == "cycle" and gi_modes.gi_temporal_active(cfg):
        k = (frame_idx // cfg.gi_temporal_div) % 3
    else:
        k = frame_idx % 3
    return gi.sweep_lightgrid_u8(lightgrid, (2, 1, 0)[k], cfg.skylight,
                                 cfg.sweep_move_ratio, cfg.sweep_blend)


class FrameInputs(NamedTuple):
    """Per-frame derived scalars / matrices."""

    jitter: torch.Tensor
    jitter_prev: torch.Tensor
    sun_from_world: torch.Tensor
    sun_dir: torch.Tensor
    old_clip_from_world: torch.Tensor
    sun_changed: bool


def sun_emission(cfg):
    """Voxelize's sun emission, voxelize_sun_emission_scale * sun_color, as
    3 float32 numbers (the f32 product the card's and the CPU's tensor
    product give)."""
    return np.float32(cfg.voxelize_sun_emission_scale) * np.asarray(cfg.sun_color, np.float32)


def frame_inputs(state: FrameState, cam: CameraState, sun_angle, cfg) -> FrameInputs:
    dev = cam.clip_from_world.device
    fidx = state.frame_idx
    sun_from_world, sun_dir = shadow.sun_matrices(sun_angle[0], sun_angle[1],
                                                  cfg.sun_half_size)
    sun_angle = tuple(float(np.float32(a)) for a in sun_angle)
    return FrameInputs(
        jitter=torch.as_tensor(noiselib.taa_jitter(fidx, cfg.width, cfg.height),
                               device=dev),
        jitter_prev=torch.as_tensor(
            noiselib.taa_jitter(max(fidx - 1, 0), cfg.width, cfg.height), device=dev),
        sun_from_world=sun_from_world.to(dev),
        sun_dir=sun_dir.to(dev),
        old_clip_from_world=(cam.clip_from_world if fidx == 0
                             else state.clip_from_world_prev),
        # the scene is static: redraw the shadow map only when the sun moved
        # (the reference's condition, render.cpp:1024)
        sun_changed=fidx == 0 or sun_angle != state.sun_angle_prev,
    )


def build_globals(cam: CameraState, fi: FrameInputs, frame_idx) -> lighting.Globals:
    """The lighting pass's per-frame uniforms (render.h:122-136), shared by
    render_frame and the row-sharded frame (parallel/sharding.py) so that
    the two cannot drift.  frame_idx is the host frame index."""
    return lighting.Globals(
        clip_from_world=cam.clip_from_world,
        clip_from_view=cam.clip_from_view,
        world_from_clip=cam.world_from_clip,
        view_from_clip=cam.view_from_clip,
        view_from_world=cam.view_from_world,
        world_from_view=cam.world_from_view,
        sun_from_world=fi.sun_from_world,
        old_clip_from_world=fi.old_clip_from_world,
        sun_direction=fi.sun_dir,
        camera_pos=cam.position,
        frame_idx_mod_59=float(frame_idx % 59),
        taa_jitter=fi.jitter,
        taa_jitter_prev=fi.jitter_prev,
    )


def post_stack(hdr, depth, velocity, state: FrameState, cfg):
    """Passes 6-9: TAA resolve, bloom down/up, tonemap.
    Returns (final srgb image, taa_out, bloom pyramid atlas).

    On the card: three launches, one for TAA, one for the whole down chain
    (each level writing its band of a fresh bf16 pyramid atlas, the
    reference package's RGBA16F storage) and one for the whole up chain,
    whose last level adds the tent to the image and tonemaps it; bloom off,
    TAA and one tonemap launch (bloom_up_level).  On the CPU the same calls
    take their plain versions."""
    if cfg.enable_taa:
        history = hdr if state.frame_idx == 0 else state.taa_history
        taa_out = taa.taa_resolve(
            hdr, depth, velocity, state.velocity_prev, history, cfg.taa_blend,
            cfg.taa_velocity_rejection, catmull_history=cfg.taa_catmull_history,
            full_rgb_catmull=cfg.taa_full_rgb_catmull)
    else:
        taa_out = hdr
    if not cfg.enable_bloom:
        final = bloom_mod.bloom_up_level(None, cfg.height, cfg.width, base=taa_out,
                                         exposure=cfg.exposure)
        return final, taa_out, state.prev_pyramid
    h, w, passes = cfg.height, cfg.width, cfg.bloom_pass_count
    pyramid, offsets = bloom_mod.new_atlas(h, w, passes, hdr.device)
    downs = bloom_mod.bloom_down_chain(taa_out, passes, pyramid, offsets)
    final = bloom_mod.bloom_up_chain(downs[-1], h, w, passes, cfg.bloom_strength, taa_out,
                                     cfg.exposure)
    return final, taa_out, pyramid


def render_frame(scene, state: FrameState, cam: CameraState, sun_angle,
                 prefiltered_env, brdf_lut, cfg: RenderConfig, raster_backend="xla"):
    """One frame.  Updates `state` and returns the final sRGB image [H,W,3].
    raster_backend: "xla" (the default, as in the JAX render_frame) or
    "pallas"."""
    h, w = cfg.height, cfg.width
    fi = frame_inputs(state, cam, sun_angle, cfg)
    f59 = float(state.frame_idx % 59)

    # ---- pass 1: sun depth (render.cpp:999-1020) -------------------------
    sun_depth = state.sun_depth
    if cfg.enable_shadows and fi.sun_changed:
        _, sd, _, sun_ovf = _rasterize(scene, fi.sun_from_world, cfg.shadow_map_size,
                                       cfg.shadow_map_size, cfg, cull="none",
                                       backend=raster_backend)
        sun_depth = torch.where(torch.isinf(sd), 1.0, sd)
        torch.maximum(state.raster_overflow, sun_ovf, out=state.raster_overflow)

    # ---- pass 2: voxelize, only when the sun moved (render.cpp:1022-1057)
    # ---- pass 3: sweep, the axis rotating per frame (render.cpp:1064-1069)
    lightgrid, lightgrid_u8 = state.lightgrid, None
    if cfg.enable_gi:
        if fi.sun_changed:
            # on the card one launch of csrc/voxelize.cu; the emission goes
            # by value (f32, as the card's product rounds it)
            lightgrid = gi.voxelize_lightgrid(
                scene, cfg.lightgrid_size, cfg.lightgrid_scale, sun_depth,
                fi.sun_from_world, fi.sun_dir, sun_emission(cfg),
                total_samples=cfg.voxelize_samples or (1 << 20),
                plan=voxel_plan(state, scene, cfg))
            state.voxelize_count += 1
        lightgrid, lightgrid_u8 = sweep_rotated(lightgrid, state.frame_idx, cfg)

    # ---- pass 4: geometry -> G-buffer (render.cpp:1074-1115) -------------
    sun_u16, static, lut16 = frame_tables(state, scene, brdf_lut, cfg, sun_depth,
                                          fi.sun_changed)
    s, depth, tri, main_ovf = _rasterize(scene, cam.clip_from_world, w, h, cfg,
                                         jitter=fi.jitter, cull="back",
                                         backend=raster_backend)
    torch.maximum(state.raster_overflow, main_ovf, out=state.raster_overflow)
    gbuf = gb.gbuffer_pass(
        scene, s, depth, tri, cam.clip_from_world, fi.old_clip_from_world,
        cfg.alpha_test_threshold, world_from_clip=cam.world_from_clip, jitter=fi.jitter,
        material_filter=cfg.material_filter, frame_idx_mod_59=f59, static=static)

    # ---- pass 5: lighting ------------------------------------------------
    glob = build_globals(cam, fi, state.frame_idx)
    res = lighting.LightingResources(sun_depth=sun_depth,
                                     prefiltered_env=prefiltered_env,
                                     brdf_lut=brdf_lut, lightgrid=lightgrid,
                                     prev_frame_atlas=state.prev_pyramid,
                                     sun_u16=sun_u16, brdf_lut16=lut16,
                                     lightgrid_u8=lightgrid_u8)
    gi_cache = state.gi_cache
    if cfg.visualize_lightgrid:
        hdr = lighting.visualize_lightgrid_pass(glob, res, cfg, w, h)
    elif gi_modes.gi_temporal_active(cfg):
        hdr, gi_cache = lighting.lighting_pass(gbuf, glob, res, cfg, gi_cache=gi_cache,
                                               frame_idx=state.frame_idx)
    else:
        hdr = lighting.lighting_pass(gbuf, glob, res, cfg)

    # ---- passes 6-9: TAA, bloom, tonemap ---------------------------------
    final, taa_out, pyramid = post_stack(hdr, gbuf.depth, gbuf.velocity, state, cfg)

    state.lightgrid = lightgrid
    state.gi_cache = gi_cache
    state.sun_depth = sun_depth
    state.sun_u16 = sun_u16
    state.taa_history = taa_out
    state.velocity_prev = gbuf.velocity
    state.prev_pyramid = pyramid
    state.clip_from_world_prev = cam.clip_from_world
    state.sun_angle_prev = tuple(float(np.float32(a)) for a in sun_angle)
    state.frame_idx += 1
    return final


class Renderer:
    """Host-side orchestration: bake the IBL tables once, then step frames."""

    def __init__(self, cfg: RenderConfig, scene, device="cuda", env_faces=None,
                 raster_backend="auto"):
        if cfg.enable_gi and cfg.voxelize_samples == 0:
            # right-size the voxelize sample stream for this scene (the same
            # samples for any capacity >= the true count)
            cfg = cfg.replace(voxelize_samples=gi.voxelize_sample_capacity(
                scene, cfg.lightgrid_size, cfg.lightgrid_scale))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scene = type(scene)(*(t.to(self.device) for t in scene))
        self.raster_backend = resolve_raster_backend(raster_backend, scene.num_tris)
        if env_faces is None:
            from ..assets import procedural

            env_faces = procedural.make_sky_cubemap(128)
        env = torch.as_tensor(np.asarray(env_faces, np.float32), device=self.device)
        env_atlas = sampling.build_cube_mip_atlas(env)
        # baked even with IBL off: the sky fallback samples the prefiltered env
        self.prefiltered_env_raw = ibl.bake_prefiltered_env(
            env_atlas, env.shape[1], cfg.prefiltered_env_size,
            cfg.prefiltered_env_min_size, cfg.prefilter_samples)
        self.prefiltered_env = sampling.pack_cube_mip_atlas_window(
            self.prefiltered_env_raw, cfg.prefiltered_env_size)
        self.brdf_lut = ibl.bake_brdf_lut(cfg.brdf_lut_size, cfg.brdf_lut_samples,
                                          device=self.device)
        self.state = init_frame_state(cfg, self.device)

    def render(self, cam: CameraState, sun_angle=(50.0, 30.0)):
        """Render one frame; updates the temporal state.  Returns [H,W,3].
        Setting `renderer.state = None` resets the temporal state."""
        if self.state is None:
            self.state = init_frame_state(self.cfg, self.device)
        return render_frame(self.scene, self.state, cam.to(self.device), sun_angle,
                            self.prefiltered_env, self.brdf_lut, self.cfg,
                            self.raster_backend)

    def check_overflow(self, strict=False):
        """Verify no frame so far exceeded the binning pair capacity or, on
        the rowblock kernel, the per-tile capacity (either silently drops
        triangles).  Syncs with the device: call after a batch of frames.
        Returns (ok, message).  The brute-force raster has no capacity, so
        "xla" is ok outright."""
        if self.raster_backend != "pallas":
            return True, "xla raster path has no capacity limits"
        max_seg, total = (int(x) for x in self.state.raster_overflow.cpu())
        pair_cap = self.cfg.pair_capacity_factor * self.scene.num_tris
        msgs = []
        if self.cfg.raster_kernel == "rowblock" and max_seg > self.cfg.tile_capacity:
            msgs.append(f"tile segment {max_seg} > tile_capacity {self.cfg.tile_capacity}")
        if total > pair_cap:
            msgs.append(f"pair count {total} > pair_capacity {pair_cap}")
        if msgs:
            msg = ("raster bin overflow (triangles dropped): " + "; ".join(msgs)
                   + " — raise cfg.tile_capacity / cfg.pair_capacity_factor and "
                   "re-render")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg)
            return False, msg
        return True, f"ok (max segment {max_seg}, pairs {total})"
