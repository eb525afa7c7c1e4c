"""The deferred lighting pass (counterpart of
vulkan_pbr_renderer_tpu/shade/lighting.py, lighting_pass.glsl:432-716): sun
light with PCF shadows, light shafts (polar or marched), the voxel GI (or,
with GI off, static split-sum IBL), emissive and the half-res sky fallback;
and the lightgrid debug view (`visualize_lightgrid_pass`).

On the card the pass is csrc/lighting.cu's kernels: the polar shafts
(shadow.shafts_polar, one launch), the GI lane inputs
(gi_modes.gi_lane_inputs, one launch per grid) beside the GI rays
(csrc/gi_fast_ray.cu, reading the lightgrid's u8 table that the sweep
wrote, LightingResources.lightgrid_u8) and the full-resolution `shade`
(one launch); on the CPU their plain versions."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..gpu import cuda_build, sampling
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
    sun_u16: Optional[torch.Tensor] = None     # [S,S] quantize_u16(sun_depth), made once
                                               # per sun change; None: made here
    brdf_lut16: Optional[torch.Tensor] = None  # [L,L,2] f16 brdf_lut; None: made here
    lightgrid_u8: Optional[torch.Tensor] = None  # [D,D,D,4] u8 quantize_grid_u8(lightgrid),
                                                 # written by the sweep beside the grid
                                                 # (gi.sweep_lightgrid_u8); the GI reads it


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


def sub_grid_inputs(normal, orm, depth, world_from_clip, view_from_clip, k, frame_idx_mod_59,
                    row_offset=0, full_height=None):
    """(n, roughness, p_world, p_view, (noise_1, noise_2, noise_3)) at the
    [::k, ::k] grid of the G-buffer rows (normal [H,W,3], orm [H,W,3] or
    None, depth [H,W]), positions and noise recomputed at the subsampled
    pixels' centres (k = 1: the full-resolution ones)."""
    fh = full_height or depth.shape[0]
    depth_d = depth[::k, ::k]
    pw, pv = reconstruct_positions(depth_d, world_from_clip, view_from_clip, row_offset, fh,
                                   stride=k)
    px, py = _pixel_grid(depth_d.shape[0], depth_d.shape[1], k, depth.device, row_offset)
    noises = tuple(noiselib.frame_noise(px, py, frame_idx_mod_59, offset=o)
                   for o in ((0.0, 0.0), (90.0, 20.0), (522.0, 55.0)))
    rough = None if orm is None else orm[::k, ::k, 1]
    return normal[::k, ::k], rough, pw, pv, noises


def _up_steps(src, h, w):
    """The exact 2x steps lighting._up takes from src to (h, w), or None
    when its chain ends in resize_linear (or needs more than 3 steps, which
    shade_kernel does not take on the fly)."""
    sh, sw = src.shape[:2]
    steps = 0
    while sh * 2 <= h and sw * 2 <= w:
        sh, sw, steps = sh * 2, sw * 2, steps + 1
    return steps if (sh, sw) == (h, w) and steps <= 3 else None


def sun_emission(cfg):
    """The sun's rgb emission, f32 (cfg.sun_emission_scale * sun_color)."""
    return np.float32(cfg.sun_emission_scale) * np.asarray(cfg.sun_color, np.float32)


def shade_plain(g, glob: Globals, cfg: RenderConfig, sun_u16, lut16, prefiltered_env,
                shafts=None, ambient=None, spec=None, row_offset=0, full_height=None):
    """The full-resolution shading of the G-buffer `g` (its rows
    [row_offset, row_offset + H) of a full_height-tall frame) in PyTorch
    ops: sun light through the 4-tap PCF of the u16 sun map (sun_u16 None:
    shadows off), the shafts (shafts [h/k, w/k, 3] or None), the GI
    (ambient / spec at the GI grid) or, with GI off and cfg.enable_ibl, the
    static split-sum IBL, both weighted by the f16 LUT lut16, emissive, the
    sky fallback and the clamp; each low-resolution grid upsampled by _up.
    The CPU's path, and csrc/lighting.cu's shade_kernel's reference."""
    h, w = g.depth.shape
    fh = full_height or h
    dev = g.depth.device
    base_color = g.base_color
    n = g.normal
    roughness = g.orm[..., 1]
    metallic = g.orm[..., 2]
    emissive = g.emissive * cfg.emissive_scale

    p_world, _ = reconstruct_positions(g.depth, glob.world_from_clip, glob.view_from_clip,
                                       row_offset, fh)
    px, py = _pixel_grid(h, w, 1, dev, row_offset)
    f59 = glob.frame_idx_mod_59
    noise_1 = noiselib.frame_noise(px, py, f59)
    noise_2 = noiselib.frame_noise(px, py, f59, offset=(90.0, 20.0))

    sun_em = torch.as_tensor(sun_emission(cfg), device=dev)
    v = m3.normalize(glob.camera_pos - p_world)
    v_dot_n = torch.clamp(m3.dot(v, n), min=0.0)
    outgoing = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)

    # --- sun shadow + direct light (glsl:592-679) -------------------------
    if sun_u16 is not None:
        vis = shadow.sun_visibility(glob.sun_from_world, p_world, n, noise_1, noise_2, sun_u16,
                                    cfg.shadow_normal_offset)
    else:
        vis = torch.ones((h, w), dtype=torch.float32, device=dev)
    l = -glob.sun_direction
    direct = brdf.cook_torrance_direct(n, v, l.expand(n.shape), base_color,
                                       roughness, metallic, cfg.f0_dielectric)
    outgoing = outgoing + vis[..., None] * direct * sun_em

    # --- volumetric light shafts at 1/k res (glsl:620-651) ----------------
    if shafts is not None:
        outgoing = outgoing + _up(shafts, h, w)

    # --- split-sum weights (glsl:681) -------------------------------------
    if ambient is not None or cfg.enable_ibl:
        f0 = brdf.f0_from_metallic(base_color, metallic, cfg.f0_dielectric)
        lut_uv = torch.stack([v_dot_n, torch.clamp(roughness, min=0.05)], -1)
        scale_bias = sampling.sample_bilinear_table(lut16, lut_uv)
        ks = brdf.fresnel_schlick(v_dot_n, f0)
        kd = (1.0 - ks) * (1.0 - metallic[..., None])

    env_size = prefiltered_env.shape[1]
    if ambient is not None:
        # --- fast voxel GI (glsl:683-702), from the 1/gi_res_divisor grid --
        outgoing = outgoing + kd * _up(ambient, h, w) * base_color
        outgoing = outgoing + _up(spec, h, w) * (f0 * scale_bias[..., 0:1]
                                                 + scale_bias[..., 1:2])
    elif cfg.enable_ibl:
        # --- static split-sum IBL (geometry_pass.glsl:322-346 reference) ---
        irr = sampling.sample_cubemap_level_window(prefiltered_env, env_size, n, 4)
        outgoing = outgoing + kd * irr * base_color
        r = m3.reflect(-v, n)
        r2 = roughness * roughness
        r = r + (n - r) * (r2 * r2)[..., None]
        spec_ibl = sampling.sample_cubemap_lod_window(prefiltered_env, env_size, r,
                                                      roughness * 4.0)
        outgoing = outgoing + spec_ibl * (f0 * scale_bias[..., 0:1] + scale_bias[..., 1:2])

    outgoing = outgoing + emissive
    # --- sky fallback (glsl:708-710) at mip 0, half res ---------------------
    # (full res in the row-sharded frame, fh > h: the half-res upsample
    # would edge-clamp at the band's edges and seam, lighting.py:305-318)
    out_of_bounds = torch.any(torch.abs(p_world) > cfg.world_bounds, dim=-1) | ~g.coverage
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
            prefiltered_env, env_size, ray, 0), h, w)
    else:
        sky = sampling.sample_cubemap_level_window(prefiltered_env, env_size, -v, 0)
    outgoing = torch.where(out_of_bounds[..., None], sky, outgoing)
    return torch.clamp(outgoing, min=0.0)


class _ShadeArgs(ctypes.Structure):
    """struct ShadeArgs of csrc/lighting.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "base_color", "normal", "orm", "emissive", "depth", "coverage", "sun_map", "lut", "env",
        "shafts", "ambient", "spec", "world_from_clip", "sun_from_world", "camera_pos",
        "sun_dir", "out")] + [("emission", ctypes.c_float * 3)] + [
        (n, ctypes.c_float) for n in (
            "inv_fw", "inv_fh", "inv_w", "inv_s", "inv_pi", "noise_offset", "normal_offset",
            "f0_dielectric", "emissive_scale", "world_bounds")] + [
        (n, ctypes.c_int) for n in (
            "h", "w", "row_offset", "fh", "s", "lh", "lw", "es", "ewa", "env_levels", "sh_h",
            "sh_w", "sh_steps", "gh", "gw", "g_steps", "ibl", "sky_half")]


def shade(g, glob: Globals, cfg: RenderConfig, sun_u16, lut16, prefiltered_env, shafts=None,
          ambient=None, spec=None, row_offset=0, full_height=None):
    """shade_plain's HDR [H,W,3].  The inputs are checked first (ValueError);
    then a CUDA tensor launches csrc/lighting.cu's shade_kernel (or raises)
    and a CPU tensor takes shade_plain.  The kernel stages each grid's
    levels under its tile of pixels; a low-resolution grid whose size does
    not reach (H, W) by at most 3 exact 2x steps is upsampled by _up before
    the launch.  `shade.launches` counts launches."""
    h, w = g.depth.shape
    fh = full_height or h
    dev = g.depth.device
    fn = "shade"
    for t, what, shape in ((g.base_color, "base_color", (h, w, 3)),
                           (g.normal, "normal", (h, w, 3)), (g.orm, "orm", (h, w, 3)),
                           (g.emissive, "emissive", (h, w, 3)), (g.depth, "depth", (h, w))):
        cuda_build.need(t, what, fn, dev, shape)
    cuda_build.need(g.coverage, "coverage", fn, dev, (h, w), torch.bool)
    if sun_u16 is not None:
        cuda_build.need(sun_u16, "sun_u16", fn, dev, dtype=torch.int16)
        if sun_u16.dim() != 2 or sun_u16.shape[0] != sun_u16.shape[1] or sun_u16.shape[0] < 4:
            raise ValueError(f"{fn}: sun_u16 must be [S, S], S >= 4")
    needs_lut = ambient is not None or cfg.enable_ibl
    if needs_lut:
        cuda_build.need(lut16, "lut16", fn, dev, dtype=torch.float16)
        if lut16.dim() != 3 or lut16.shape[2] != 2:
            raise ValueError(f"{fn}: lut16 must be [L, L, 2]")
    cuda_build.need(prefiltered_env, "prefiltered_env", fn, dev, dtype=torch.float16)
    if prefiltered_env.dim() != 4 or prefiltered_env.shape[3] != 12:
        raise ValueError(f"{fn}: prefiltered_env must be [6, S, Wa, 12]")
    for t, what in ((shafts, "shafts"), (ambient, "ambient"), (spec, "spec")):
        if t is not None:
            cuda_build.need(t, what, fn, dev)
            if t.dim() != 3 or t.shape[2] != 3:
                raise ValueError(f"{fn}: {what} must be [h, w, 3]")
    if (ambient is None) != (spec is None):
        raise ValueError(f"{fn}: ambient and spec go together")
    if not g.depth.is_cuda:
        return shade_plain(g, glob, cfg, sun_u16, lut16, prefiltered_env, shafts, ambient, spec,
                           row_offset, full_height)

    def grid(x):
        if x is None:
            return None, 0, 0, 0
        steps = _up_steps(x, h, w)
        if steps is None:
            x, steps = _up(x, h, w).contiguous(), 0
        return x, x.shape[0], x.shape[1], steps

    shafts, sh_h, sh_w, sh_steps = grid(shafts)
    ambient, gh, gw, g_steps = grid(ambient)
    spec, _, _, _ = grid(spec)
    mats = [t.contiguous() for t in (glob.world_from_clip, glob.sun_from_world,
                                     glob.camera_pos, glob.sun_direction)]
    es = prefiltered_env.shape[1]
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = _ShadeArgs(
        base_color=g.base_color.data_ptr(), normal=g.normal.data_ptr(), orm=g.orm.data_ptr(),
        emissive=g.emissive.data_ptr(), depth=g.depth.data_ptr(),
        coverage=g.coverage.data_ptr(), sun_map=ptr(sun_u16),
        lut=ptr(lut16) if needs_lut else None, env=prefiltered_env.data_ptr(),
        shafts=ptr(shafts), ambient=ptr(ambient), spec=ptr(spec),
        world_from_clip=mats[0].data_ptr(), sun_from_world=mats[1].data_ptr(),
        camera_pos=mats[2].data_ptr(), sun_dir=mats[3].data_ptr(), out=out.data_ptr(),
        emission=(ctypes.c_float * 3)(*sun_emission(cfg)),
        inv_fw=shadow._recip(w), inv_fh=shadow._recip(fh), inv_w=shadow._recip(w),
        inv_s=1.0 / sun_u16.shape[0] if sun_u16 is not None else 0.0,
        inv_pi=shadow._recip(brdf.PI), noise_offset=shadow.noise_offset(glob.frame_idx_mod_59),
        normal_offset=cfg.shadow_normal_offset, f0_dielectric=cfg.f0_dielectric,
        emissive_scale=cfg.emissive_scale, world_bounds=cfg.world_bounds,
        h=h, w=w, row_offset=row_offset, fh=fh,
        s=sun_u16.shape[0] if sun_u16 is not None else 0,
        lh=lut16.shape[0] if needs_lut else 0, lw=lut16.shape[1] if needs_lut else 0,
        es=es, ewa=prefiltered_env.shape[2], env_levels=sampling.n_mip_levels(es, es),
        sh_h=sh_h, sh_w=sh_w, sh_steps=sh_steps, gh=gh, gw=gw, g_steps=g_steps,
        ibl=int(cfg.enable_ibl), sky_half=int(h % 2 == 0 and w % 2 == 0 and fh == h))
    shadow.launch("shade_launch", args, dev)
    shade.launches += 1
    return out


shade.launches = 0


def shade_occupancy():
    """The built shade kernel on the current card: {registers, local_bytes
    (a thread's local memory, where spills land), shared_bytes (a block's),
    blocks_per_sm (resident at once), tile_w, tile_h}."""
    return cuda_build.query_ints(shadow.library(), "shade_occupancy", (
        "registers", "local_bytes", "shared_bytes", "blocks_per_sm", "tile_w", "tile_h"))


def lighting_pass(g, glob: Globals, res: LightingResources, cfg: RenderConfig,
                  gi_cache=None, frame_idx=None, row_offset=0, full_height=None,
                  depth_full=None):
    """HDR lighting [H,W,3] of the G-buffer `g` — or (hdr, new_gi_cache) when
    gi_cache is passed (the cfg.gi_temporal_div interleave; frame_idx is the
    host frame index).  In the row-sharded frame `g` holds the rows
    [row_offset, row_offset + H) of a full_height-tall frame and depth_full,
    the gathered full-height depth, is what the GI screen trace marches.

    On the card: shadow.shafts_polar (1 launch), the GI block
    (gi_modes.gi_pass: its lane inputs, 1 launch, and the rays) and shade
    (1 launch); res.sun_u16 and res.brdf_lut16, when not given, are made
    here from res.sun_depth and res.brdf_lut."""
    h, w = g.depth.shape
    fh = full_height or h
    f59 = glob.frame_idx_mod_59
    sun_u16 = None
    if cfg.enable_shadows:
        sun_u16 = (res.sun_u16 if res.sun_u16 is not None
                   else sampling.quantize_u16(res.sun_depth))
    lut16 = None
    if cfg.enable_gi or cfg.enable_ibl:
        lut16 = res.brdf_lut16 if res.brdf_lut16 is not None else brdf_lut_f16(res.brdf_lut)

    # --- volumetric light shafts at 1/k res (glsl:620-651) ----------------
    shafts = None
    if cfg.enable_light_shafts and cfg.enable_shadows:
        k = cfg.shaft_res_divisor
        if cfg.light_shaft_mode == "polar":
            shafts = shadow.shafts_polar(
                res.sun_depth, glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
                glob.world_from_clip, glob.view_from_clip, k, f59, sun_emission(cfg),
                cfg.light_shaft_intensity, cfg.shadow_normal_offset,
                max_steps=cfg.light_shaft_steps * 3, n_theta=cfg.shaft_polar_thetas,
                n_r=cfg.light_shaft_steps * 3, row_offset=row_offset, full_height=fh)
        else:
            # the march samples the single-table 2x2 u16 pack (lighting.py:216-223)
            n_s, _, pw_s, _, (noise_s, _, _) = sub_grid_inputs(
                g.normal, None, g.depth, glob.world_from_clip, glob.view_from_clip, k, f59,
                row_offset, fh)
            shafts = shadow.light_shafts(
                res.sun_depth, glob.sun_from_world, glob.camera_pos, pw_s, n_s,
                noise_s, torch.as_tensor(sun_emission(cfg), device=g.depth.device),
                cfg.light_shaft_intensity, cfg.shadow_normal_offset,
                max_steps=cfg.light_shaft_steps * 3,
                wdepth=sampling.pack_depth_window_u16(res.sun_depth))

    ambient = spec = new_gi_cache = None
    if cfg.enable_gi:
        # --- voxel GI (glsl:683-702) at 1/gi_res_divisor res ---------------
        ambient, spec, new_gi_cache = gi_modes.gi_pass(
            cfg, glob, res, g, g.depth if depth_full is None else depth_full, fh, w, f59,
            gi_cache=gi_cache, frame_idx=frame_idx, row_offset=row_offset)
    out = shade(g, glob, cfg, sun_u16, lut16, res.prefiltered_env, shafts, ambient, spec,
                row_offset, fh)
    if gi_cache is not None:
        return out, new_gi_cache
    return out


def brdf_lut_f16(brdf_lut):
    """The split-sum LUT [L,L,2] as the f16 table shade reads (the values the
    reference package's f16 window pack holds), made once per bake."""
    return brdf_lut.to(torch.float16).contiguous()


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
