"""GI dispatch (counterpart of vulkan_pbr_renderer_tpu/shade/gi_modes.py),
one function per GI mode:
  * fast_march_gi: the reference-structured fog march
    (gi.sample_radiance_fog) with the bounded linear screen trace
    (gi.screen_trace_linear) as its screen term, one gi.fast_ray_resolve
    call per ray (one CUDA kernel launch on the card) — the default;
  * reference_gi: the full hybrid screen + voxel march
    (gi.sample_radiance_with_screen_trace), the fidelity yardstick.

gi_pass returns (ambient, spec, new_gi_cache | None) at the gi_res_divisor
grid; lighting_pass applies the split-sum weights and the upsample.  The
temporal interleave (cfg.gi_temporal_div = 2) traces half the GI lanes per
frame into the persistent FrameState.gi_cache; the frame index and its
parity are host integers, so selecting the half is plain slicing.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from ..utils import math3d as m3
from . import gi


def gi_temporal_active(cfg):
    """True when the temporal GI interleave can run: GI on in fast march
    mode (or in reference mode with the gi_temporal_reference opt-in),
    diffuse and specular at the same divisor, an even number of GI columns
    (and rows under "checker").  init_frame_state sizes FrameState.gi_cache
    by it."""
    kg = cfg.gi_res_divisor
    mode_ok = ((cfg.gi_mode == "fast" and cfg.gi_fast_march)
               or (cfg.gi_mode == "reference" and cfg.gi_temporal_reference))
    return (cfg.gi_temporal_div >= 2 and cfg.enable_gi and mode_ok
            and (cfg.gi_res_divisor_diffuse or kg) == kg
            and cfg.height % kg == 0 and cfg.width % kg == 0
            and (cfg.width // kg) % 2 == 0
            and (cfg.gi_temporal_pattern != "checker"
                 or (cfg.height // kg) % 2 == 0))


def bent_normal_cosine(n, noise_1, noise_3):
    """Random cosine-hemisphere direction about N (lighting_pass.glsl:551-585)."""
    some_vector = m3.normalize(torch.tensor([0.7128864983, 0.8217892113, 0.948912748],
                                            device=n.device))
    tangent = m3.normalize(m3.cross(some_vector.expand(n.shape), n))
    bitangent = m3.cross(n, tangent)
    pitch = torch.arccos(torch.sqrt(torch.clamp(1.0 - noise_1, 0.0, 1.0)))
    yaw = 2.0 * math.pi * noise_3
    sp = torch.sin(pitch)
    local = torch.stack([sp * torch.cos(yaw), sp * torch.sin(yaw), torch.cos(pitch)], -1)
    return tangent * local[..., 0:1] + bitangent * local[..., 1:2] + n * local[..., 2:3]


def interleave_ops(cfg, frame_idx):
    """(half, merge) lane ops of the gi_temporal_div=2 interleave for the
    host frame index.  half(x): the parity-selected half of the GI columns,
    x[:, par::2]; under "checker" odd rows take the opposite parity.
    merge(slot, half_val): a copy of the cache slot with the freshly traced
    half written back at its positions."""
    par = frame_idx % 2
    checker = cfg.gi_temporal_pattern == "checker"

    def half(x):
        if not checker:
            return x[:, par::2]
        out = x.new_empty((x.shape[0], x.shape[1] // 2) + x.shape[2:])
        out[0::2] = x[0::2, par::2]
        out[1::2] = x[1::2, 1 - par::2]
        return out

    def merge(slot, half_val):
        out = slot.clone()
        if not checker:
            out[:, par::2] = half_val
        else:
            out[0::2, par::2] = half_val[0::2]
            out[1::2, 1 - par::2] = half_val[1::2]
        return out

    return half, merge


def _specular_ray(ctx):
    """Noise-roughened reflection direction, biased toward N at high
    roughness (lighting_pass.glsl:691-697)."""
    nd, roughd = ctx.nd, ctx.roughd
    r = m3.reflect(-ctx.vd, nd)
    r = m3.normalize(r + 0.6 * roughd[..., None]
                     * (torch.stack([ctx.n1d, ctx.n2d, ctx.n3d], -1) - 0.5))
    r2 = roughd * roughd
    return r + (nd - r) * (r2 * r2)[..., None]


def _min_depth(trace_depth, k):
    """k x k minimum of the depth (or the [::k, ::k] subsample when k does
    not divide it)."""
    if k == 1:
        return trace_depth
    h, w = trace_depth.shape
    if h % k == 0 and w % k == 0:
        return trace_depth.reshape(h // k, k, w // k, k).amin(dim=(1, 3))
    return trace_depth[::k, ::k]


def fast_march_gi(ctx):
    """The fast GI: fog march on the u8 table (trilinear) or the f16 grid
    (nearest), the linear screen trace as the screen term; each ray's lanes
    in one gi.fast_ray_resolve call (one kernel launch on the card)."""
    cfg, glob, res = ctx.cfg, ctx.glob, ctx.res
    kg = cfg.gi_res_divisor
    trace_tbl = None
    if cfg.gi_fast_screen_probe:
        kdt = cfg.gi_trace_depth_div
        if kdt > 1 and cfg.gi_trace_depth_mode == "plain":
            trace_tbl = ctx.trace_depth[::kdt, ::kdt]
        else:
            trace_tbl = _min_depth(ctx.trace_depth, kdt)
        trace_tbl = trace_tbl.contiguous()
    table = gi.quantize_grid_u8(res.lightgrid)
    fgrid = None if cfg.gi_fast_fog_trilinear else gi.pack_grid_f16_nearest(res.lightgrid)
    # the kernel reads the matrices and the camera position as dense arrays
    mats = [t.contiguous() for t in (glob.view_from_world, glob.clip_from_view,
                                     glob.world_from_view, glob.camera_pos)]

    def march_resolve(pw, rd_unit, hit_steps, step_scale, ss_intensity, noise,
                      foggyness, pv):
        rp = gi.ray_params(cfg, hit_steps, step_scale, ss_intensity, ctx.fh // 2, ctx.w // 2)
        fog = foggyness.contiguous() if torch.is_tensor(foggyness) else foggyness
        rgb, _ = gi.fast_ray_resolve(
            table, fgrid, trace_tbl, res.prev_frame_atlas, *mats, pw.contiguous(),
            rd_unit.contiguous(), pv.contiguous(), noise.contiguous(), fog, rp)
        return rgb

    # diffuse ray, optionally at its own coarser grid
    kdif = cfg.gi_res_divisor_diffuse or kg
    if kdif != kg:
        nd_d, _, pwd_d, pvd_d, (n1dd, _, n3dd) = ctx.sub_inputs(kdif, ctx.f59_gi)
        bent_d = bent_normal_cosine(nd_d, n1dd, n3dd)
    else:
        pwd_d, pvd_d, bent_d, n3dd = ctx.pwd, ctx.pvd, ctx.bent, ctx.n3d
    half = ctx.half if ctx.half is not None else (lambda x: x)
    ambient = march_resolve(half(pwd_d), half(bent_d), cfg.gi_fast_hit_steps,
                            cfg.gi_fast_hit_step_scale, cfg.gi_diffuse_ss_intensity,
                            half(n3dd), cfg.gi_diffuse_foggyness, half(pvd_d))

    r = _specular_ray(ctx)
    spec_fog = ctx.roughd if cfg.gi_specular_foggyness_is_roughness else 0.9
    spec = march_resolve(half(ctx.pwd), half(r), cfg.gi_fast_hit_steps_spec,
                         cfg.gi_fast_hit_step_scale_spec, cfg.gi_specular_ss_intensity,
                         half(ctx.n3d),
                         half(spec_fog) if torch.is_tensor(spec_fog) else spec_fog,
                         half(ctx.pvd))
    if ctx.half is None:
        return ambient, spec, None
    ambient = ctx.merge(ctx.gi_cache[0], ambient)
    spec = ctx.merge(ctx.gi_cache[1], spec)
    return ambient, spec, torch.stack([ambient, spec])


def reference_gi(ctx):
    """The reference mode: the full hybrid march
    (gi.sample_radiance_with_screen_trace, lighting_pass.glsl:273-424) for
    the diffuse and the specular ray, against the full-resolution depth or,
    with gi_reference_depth_div = k > 1, its plain [::k, ::k] subsample;
    under gi_temporal_reference, on the interleave's half of the lanes."""
    cfg, glob, res = ctx.cfg, ctx.glob, ctx.res
    kdr = cfg.gi_reference_depth_div
    ref_depth = ctx.trace_depth[::kdr, ::kdr].contiguous() if kdr > 1 else ctx.trace_depth
    wgrid, walpha = gi.pack_grid_u8(res.lightgrid), gi.pack_grid_alpha_u16(res.lightgrid)

    def ref_resolve(pw, pv, vd, rd, noise, steps, step_scale, fog, intensity):
        return gi.sample_radiance_with_screen_trace(
            wgrid, ref_depth, res.prev_frame_atlas, glob.view_from_world,
            glob.clip_from_view, glob.view_from_clip, glob.world_from_view, vd, pv, pw, rd,
            cfg.lightgrid_scale, steps, step_scale, noise, fog, intensity,
            max_ss_steps=cfg.gi_screen_trace_steps, prev_base=(ctx.fh // 2, ctx.w // 2),
            prev_levels=cfg.bloom_pass_count, alpha_grid=walpha)

    half = ctx.half if ctx.half is not None else (lambda x: x)
    ambient = ref_resolve(half(ctx.pwd), half(ctx.pvd), half(ctx.vd), half(ctx.bent),
                          half(ctx.n3d), cfg.gi_diffuse_steps, cfg.gi_diffuse_step_scale,
                          cfg.gi_diffuse_foggyness, cfg.gi_diffuse_ss_intensity)
    r = _specular_ray(ctx)
    spec_fog = ctx.roughd if cfg.gi_specular_foggyness_is_roughness else 0.9
    spec = ref_resolve(half(ctx.pwd), half(ctx.pvd), half(ctx.vd), half(r), half(ctx.n3d),
                       cfg.gi_specular_steps, cfg.gi_specular_step_scale,
                       half(spec_fog) if torch.is_tensor(spec_fog) else spec_fog,
                       cfg.gi_specular_ss_intensity)
    if ctx.half is None:
        return ambient, spec, None
    ambient = ctx.merge(ctx.gi_cache[0], ambient)
    spec = ctx.merge(ctx.gi_cache[1], spec)
    return ambient, spec, torch.stack([ambient, spec])


def gi_pass(cfg, glob, res, sub_inputs, trace_depth, fh, w, f59, gi_cache=None,
            frame_idx=None):
    """GI of the frame.  Returns (ambient, spec, new_gi_cache | None) at the
    gi_res_divisor grid.  f59 and frame_idx are host numbers."""
    kg = cfg.gi_res_divisor
    # "cycle": the GI noise advances once per 2-frame refresh cycle
    f59_gi = None
    if gi_cache is not None and cfg.gi_temporal_noise == "cycle":
        f59_gi = float(((frame_idx | 1) + cfg.gi_noise_offset) % 59)
    elif cfg.gi_noise_offset:
        f59_gi = float(np.mod(np.float32(f59) + np.float32(cfg.gi_noise_offset),
                              np.float32(59.0)))
    nd, roughd, pwd, pvd, (n1d, n2d, n3d) = sub_inputs(kg, f59_gi)
    if gi_cache is not None:
        assert gi_temporal_active(cfg)
        half, merge = interleave_ops(cfg, frame_idx)
    else:
        half = merge = None
    ctx = SimpleNamespace(
        cfg=cfg, glob=glob, res=res, sub_inputs=sub_inputs, trace_depth=trace_depth,
        fh=fh, w=w, f59_gi=f59_gi,
        nd=nd, roughd=roughd, pwd=pwd, pvd=pvd, n1d=n1d, n2d=n2d, n3d=n3d,
        vd=m3.normalize(glob.camera_pos - pwd), bent=bent_normal_cosine(nd, n1d, n3d),
        gi_cache=gi_cache, half=half, merge=merge)
    if cfg.gi_mode == "reference":
        return reference_gi(ctx)
    return fast_march_gi(ctx)
