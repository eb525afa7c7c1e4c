"""The deferred lighting pass (counterpart of
vulkan_pbr_renderer_tpu/shade/lighting.py, lighting_pass.glsl:432-716): sun
light with PCF shadows, light shafts (polar or marched), the voxel GI (or,
with GI off, static split-sum IBL), emissive and the half-res sky fallback;
and the lightgrid debug view (`visualize_lightgrid_pass`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..gpu import sampling
from ..utils import math3d as m3
from ..utils import noise as noiselib
# reached through the module objects, so that a reloaded module takes effect
from . import bloom, brdf, gi, gi_modes, shadow


class Globals(NamedTuple):
    """Per-frame uniforms (RendererGlobalsBuffer, render.h:122-136)."""

    clip_from_world: torch.Tensor
    clip_from_view: torch.Tensor
    world_from_clip: torch.Tensor
    view_from_clip: torch.Tensor
    view_from_world: torch.Tensor
    world_from_view: torch.Tensor
    sun_from_world: torch.Tensor
    old_clip_from_world: torch.Tensor
    sun_direction: torch.Tensor    # [3]
    camera_pos: torch.Tensor       # [3]
    frame_idx_mod_59: float        # host scalar
    taa_jitter: torch.Tensor       # [2] ndc
    taa_jitter_prev: torch.Tensor  # [2]


class LightingResources(NamedTuple):
    """Textures read by the lighting pass (render.cpp:829-871 bindings)."""

    sun_depth: torch.Tensor        # [S,S]
    prefiltered_env: torch.Tensor  # [6,S,Wa,12] f16 window-packed cube mip atlas
    brdf_lut: torch.Tensor         # [L,L,2]
    lightgrid: Optional[torch.Tensor] = None         # [D,D,D,4] (GI on)
    prev_frame_atlas: Optional[torch.Tensor] = None  # [H/2,Wa,3] bf16 previous
                                                     # frame's bloom pyramid


def reconstruct_positions(depth, world_from_clip, view_from_clip, row_offset=0,
                          full_height=None, stride=1):
    """depth [H,W] -> (p_world, p_view) [H,W,3] by inverse projection
    (lighting_pass.glsl:444-451).  In the row-sharded frame depth holds the
    rows [row_offset, row_offset + H) of a full_height-tall framebuffer.  For
    stride > 1, depth holds the [::stride, ::stride] subsample of a
    (full_height, W * stride) framebuffer and positions are reconstructed at
    those pixels' original centers."""
    h, w = depth.shape
    dev = depth.device
    fh, fw = full_height or h * stride, w * stride
    u = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] * stride + 0.5) / fw
    v = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] * stride
         + row_offset + 0.5) / fh
    ndc = torch.stack([(u * 2.0 - 1.0).expand(h, w), (v * 2.0 - 1.0).expand(h, w),
                       depth], -1)
    pw = m3.transform_points(world_from_clip, ndc)
    pv = m3.transform_points(view_from_clip, ndc)
    return pw[..., :3] / pw[..., 3:4], pv[..., :3] / pv[..., 3:4]


def _up(x, h, w):
    """Bilinear upsample [h/k, w/k, C] to [h, w, C] by exact 2x steps, the
    rest (a divisor that is not a power of two) by resize_linear."""
    while x.shape[0] * 2 <= h and x.shape[1] * 2 <= w:
        x = bloom._up2(x)
    if x.shape[:2] != (h, w):
        x = bloom.resize_linear(x, h, w)
    return x


def _pixel_grid(h, w, stride, device, row_offset=0):
    px = (torch.arange(w, dtype=torch.float32, device=device)[None, :] * stride
          + 0.5).expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device=device)[:, None] * stride
          + row_offset + 0.5).expand(h, w)
    return px, py


def lighting_pass(g, glob: Globals, res: LightingResources, cfg: RenderConfig,
                  gi_cache=None, frame_idx=None, row_offset=0, full_height=None,
                  depth_full=None):
    """HDR lighting [H,W,3] of the G-buffer `g` — or (hdr, new_gi_cache) when
    gi_cache is passed (the cfg.gi_temporal_div interleave; frame_idx is the
    host frame index).  In the row-sharded frame `g` holds the rows
    [row_offset, row_offset + H) of a full_height-tall frame and depth_full,
    the gathered full-height depth, is what the GI screen trace marches."""
    h, w = g.depth.shape
    fh = full_height or h
    dev = g.depth.device
    base_color = g.base_color
    n = g.normal
    roughness = g.orm[..., 1]
    metallic = g.orm[..., 2]
    emissive = g.emissive * cfg.emissive_scale

    p_world, p_view = reconstruct_positions(g.depth, glob.world_from_clip,
                                            glob.view_from_clip, row_offset, fh)
    px, py = _pixel_grid(h, w, 1, dev, row_offset)
    f59 = glob.frame_idx_mod_59
    noise_1 = noiselib.frame_noise(px, py, f59)
    noise_2 = noiselib.frame_noise(px, py, f59, offset=(90.0, 20.0))

    def noises(pxs, pys, f59_):
        return (noiselib.frame_noise(pxs, pys, f59_),
                noiselib.frame_noise(pxs, pys, f59_, offset=(90.0, 20.0)),
                noiselib.frame_noise(pxs, pys, f59_, offset=(522.0, 55.0)))

    def sub_inputs(k, f59_=None):
        """(n, roughness, p_world, p_view, (noise_1, noise_2, noise_3)) at
        the [::k, ::k] grid, positions and noise recomputed at the
        subsampled pixels' centers; f59_ overrides the noise frame index."""
        f59_ = f59 if f59_ is None else f59_
        if k == 1:
            return n, roughness, p_world, p_view, noises(px, py, f59_)
        depth_d = g.depth[::k, ::k]
        pwd, pvd = reconstruct_positions(depth_d, glob.world_from_clip,
                                         glob.view_from_clip, row_offset, fh, stride=k)
        pxd, pyd = _pixel_grid(depth_d.shape[0], depth_d.shape[1], k, dev, row_offset)
        return n[::k, ::k], roughness[::k, ::k], pwd, pvd, noises(pxd, pyd, f59_)

    sun_emission = cfg.sun_emission_scale * torch.tensor(cfg.sun_color, device=dev)
    v = m3.normalize(glob.camera_pos - p_world)
    v_dot_n = torch.clamp(m3.dot(v, n), min=0.0)
    outgoing = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)

    # --- sun shadow + direct light (glsl:592-679) -------------------------
    if cfg.enable_shadows:
        wdepth = sampling.pack_depth_window_u16_4x4_split(res.sun_depth)
        vis = shadow.sun_visibility(glob.sun_from_world, p_world, n, noise_1,
                                    noise_2, wdepth, res.sun_depth.shape[0],
                                    cfg.shadow_normal_offset)
    else:
        vis = torch.ones((h, w), dtype=torch.float32, device=dev)
    l = -glob.sun_direction
    direct = brdf.cook_torrance_direct(n, v, l.expand(n.shape), base_color,
                                       roughness, metallic, cfg.f0_dielectric)
    outgoing = outgoing + vis[..., None] * direct * sun_emission

    # --- volumetric light shafts at 1/k res (glsl:620-651) ----------------
    if cfg.enable_light_shafts and cfg.enable_shadows:
        if cfg.shaft_res_divisor == 1:
            n_s, pw_s, noise_s = n, p_world, noise_1
        else:
            n_s, _, pw_s, _, (noise_s, _, _) = sub_inputs(cfg.shaft_res_divisor)
        if cfg.light_shaft_mode == "polar":
            shafts = shadow.light_shafts_polar(
                res.sun_depth, glob.sun_from_world, glob.camera_pos, pw_s, n_s,
                noise_s, sun_emission, cfg.light_shaft_intensity,
                cfg.shadow_normal_offset, max_steps=cfg.light_shaft_steps * 3,
                n_theta=cfg.shaft_polar_thetas, n_r=cfg.light_shaft_steps * 3)
        else:
            # the march samples the single-table 2x2 u16 pack (lighting.py:216-223)
            shafts = shadow.light_shafts(
                res.sun_depth, glob.sun_from_world, glob.camera_pos, pw_s, n_s,
                noise_s, sun_emission, cfg.light_shaft_intensity,
                cfg.shadow_normal_offset, max_steps=cfg.light_shaft_steps * 3,
                wdepth=sampling.pack_depth_window_u16(res.sun_depth))
        outgoing = outgoing + _up(shafts, h, w)

    # --- split-sum weights (glsl:681) -------------------------------------
    if cfg.enable_gi or cfg.enable_ibl:
        f0 = brdf.f0_from_metallic(base_color, metallic, cfg.f0_dielectric)
        lut_uv = torch.stack([v_dot_n, torch.clamp(roughness, min=0.05)], -1)
        wlut = sampling.window_pack(res.brdf_lut, 2, 2, dtype=torch.float16)
        scale_bias = sampling.sample_bilinear_window(
            wlut, res.brdf_lut.shape[0], res.brdf_lut.shape[1], lut_uv, 2)
        ks = brdf.fresnel_schlick(v_dot_n, f0)
        kd = (1.0 - ks) * (1.0 - metallic[..., None])

    new_gi_cache = None
    if cfg.enable_gi:
        # --- fast voxel GI (glsl:683-702) at 1/gi_res_divisor res ----------
        ambient, spec, new_gi_cache = gi_modes.gi_pass(
            cfg, glob, res, sub_inputs, g.depth if depth_full is None else depth_full, fh, w,
            f59, gi_cache=gi_cache, frame_idx=frame_idx)
        outgoing = outgoing + kd * _up(ambient, h, w) * base_color
        outgoing = outgoing + _up(spec, h, w) * (f0 * scale_bias[..., 0:1]
                                                 + scale_bias[..., 1:2])
    elif cfg.enable_ibl:
        # --- static split-sum IBL (geometry_pass.glsl:322-346 reference) ---
        env_size = res.prefiltered_env.shape[1]
        irr = sampling.sample_cubemap_level_window(res.prefiltered_env, env_size, n, 4)
        outgoing = outgoing + kd * irr * base_color
        r = m3.reflect(-v, n)
        r2 = roughness * roughness
        r = r + (n - r) * (r2 * r2)[..., None]
        spec = sampling.sample_cubemap_lod_window(res.prefiltered_env, env_size, r,
                                                  roughness * 4.0)
        outgoing = outgoing + spec * (f0 * scale_bias[..., 0:1] + scale_bias[..., 1:2])

    outgoing = outgoing + emissive
    # --- sky fallback (glsl:708-710) at mip 0, half res ---------------------
    # (full res in the row-sharded frame, fh > h: the half-res upsample
    # would edge-clamp at the band's edges and seam, lighting.py:305-318)
    out_of_bounds = torch.any(torch.abs(p_world) > cfg.world_bounds, dim=-1) | ~g.coverage
    env_size = res.prefiltered_env.shape[1]
    if h % 2 == 0 and w % 2 == 0 and fh == h:
        hu = (torch.arange(w // 2, dtype=torch.float32, device=dev)[None, :] * 2 + 1.0) / w
        hv = (torch.arange(h // 2, dtype=torch.float32, device=dev)[:, None] * 2
              + row_offset + 1.0) / fh
        ndc_far = torch.stack([
            (hu * 2.0 - 1.0).expand(h // 2, w // 2),
            (hv * 2.0 - 1.0).expand(h // 2, w // 2),
            torch.full((h // 2, w // 2), 0.5, device=dev),
        ], -1)
        far4 = m3.transform_points(glob.world_from_clip, ndc_far)
        ray = far4[..., :3] / far4[..., 3:4] - glob.camera_pos
        sky = _up(sampling.sample_cubemap_level_window(
            res.prefiltered_env, env_size, ray, 0), h, w)
    else:
        sky = sampling.sample_cubemap_level_window(res.prefiltered_env, env_size, -v, 0)
    outgoing = torch.where(out_of_bounds[..., None], sky, outgoing)
    out = torch.clamp(outgoing, min=0.0)
    if gi_cache is not None:
        return out, new_gi_cache
    return out


def visualize_lightgrid_pass(glob: Globals, res: LightingResources, cfg, width, height):
    """Debug view of the raw lightgrid (lighting_pass.glsl:463-491): from
    each pixel's near-plane point, a 512-step march of 1/lightgrid_size
    grid units along the view ray, jittered by noise, shows the first voxel
    with alpha > 0.3 (x10, tone-compressed)."""
    h, w = height, width
    dev = glob.camera_pos.device
    u = ((torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5) / w * 2.0
         - 1.0).expand(h, w)
    v = ((torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5) / h * 2.0
         - 1.0).expand(h, w)
    ndc = torch.stack([u, v, torch.zeros((h, w), device=dev)], -1)
    near4 = m3.transform_points(glob.world_from_clip, ndc)
    near = near4[..., :3] / near4[..., 3:4]
    px, py = _pixel_grid(h, w, 1, dev)
    noise_1 = noiselib.frame_noise(px, py, glob.frame_idx_mod_59)

    rd = m3.normalize(near - glob.camera_pos) * (1.0 / cfg.lightgrid_size)
    ro = near * cfg.lightgrid_scale + noise_1[..., None] * rd
    sum4 = torch.zeros((h, w, 4), device=dev)
    sum4[..., 3] = 1e-5
    done = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for _ in range(512):
        ro = torch.where(done[..., None], ro, ro + rd)
        s = gi.grid_sample(res.lightgrid, ro)
        hit = (s[..., 3] > 0.3) & ~done
        add = 10.0 * torch.cat([s[..., :3], torch.ones_like(s[..., :1])], -1)
        sum4 = torch.where(hit[..., None], add, sum4)
        done = done | hit
    return gi._tone(sum4)
