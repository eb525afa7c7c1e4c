"""Seed-made inputs of the G-buffer and lighting kernels (shade/gbuffer.py
gbuffer_pass, shade/gi_modes.py gi_lane_inputs, shade/shadow.py
shafts_polar, shade/lighting.py shade), built with the port alone on any
device, shared by the CPU tests, the card tests and chip_smoke.py.

A plane and a cube under a 75-degree camera: an alpha-tested checker
material (the dark squares' alpha 0.1) with a bump normal map and an emissive one; on every third
triangle the u coordinate is mirrored (the TBN's mirrored-uv rule); the
camera sees the sky above the plane (uncovered pixels); the brute-force
raster gives depth and ids, the sun raster the shadow map.  The G-buffer
fields for the lighting kernels are the plain G-buffer's, with a random
roughness and metalness; the GI grids and the shafts are random.  The test
below holds the mix to what it is for: covered and uncovered pixels,
alpha-tested ones cut, mirrored and unmirrored uv.  Imports no jax.
"""

import numpy as np
import torch

from vulkan_pbr_renderer_tpu_torch.app import renderer as trender
from vulkan_pbr_renderer_tpu_torch.assets import procedural
from vulkan_pbr_renderer_tpu_torch.assets.scene import MaterialDesc, Scene, build_scene
from vulkan_pbr_renderer_tpu_torch.bake import ibl
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.gpu import sampling
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb
from vulkan_pbr_renderer_tpu_torch.shade import lighting

SUN = (40.0, 120.0)


def shade_scene(device, texture_size=32):
    """The plane + cube scene with every third triangle's u mirrored."""
    checker = np.asarray(procedural.checker_texture(texture_size, 4), np.float32)[..., :3]
    alpha = np.where(checker[..., :1] < 0.5, 0.1, 1.0).astype(np.float32)   # cut squares
    mats = [MaterialDesc(base_color=np.concatenate([checker, alpha], -1),
                         normal=procedural.bump_normal_texture(texture_size),
                         orm_factor=(1.0, 0.6, 0.3), alpha_test=True),
            MaterialDesc(base_color_factor=(0.7, 0.2, 0.15, 1.0),
                         orm_factor=(1.0, 0.35, 0.0), emissive_factor=(0.5, 0.2, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (14, 14), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    scene = build_scene(parts, mats, texture_size=texture_size, device="cpu")
    attr = scene.tri_attr.clone()
    flip = torch.arange(attr.shape[0]) % 3 == 0
    attr[flip, 18:24:2] = 1.0 - attr[flip, 18:24:2]
    return Scene(*(t.to(device) for t in scene._replace(tri_attr=attr)))


def frame_config(h, w, **changes):
    return RenderConfig(width=w, height=h, shadow_map_size=128, prefiltered_env_size=16,
                        prefiltered_env_min_size=8, prefilter_samples=64, brdf_lut_size=16,
                        brdf_lut_samples=64, bloom_pass_count=3, light_shaft_steps=4,
                        lightgrid_size=16, lightgrid_extent=10.0, **changes)


def gbuffer_inputs(scene, h, w, frame_idx=3, band=None, device="cpu"):
    """gbuffer_pass's arguments for an h x w frame (or the rows band =
    (row_offset, rows) of it): a dict of setup, depth, tri_id,
    clip_from_world, old_clip_from_world, world_from_clip, jitter,
    frame_idx_mod_59, row_offset and full_size."""
    cfg = frame_config(h, w)
    cam = trender.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 2.0), cfg, device=device)
    state = trender.init_frame_state(cfg, device)
    state.frame_idx = frame_idx
    fi = trender.frame_inputs(state, cam, SUN, cfg)
    y0, rows = band if band is not None else (0, h)
    s, depth, tri, _ = trender._rasterize(scene, cam.clip_from_world, w, h, cfg,
                                          jitter=fi.jitter, backend="xla", rows=rows,
                                          y_origin=y0)
    old = cam.clip_from_world @ (torch.eye(4, device=device) + 0.01)
    return dict(setup=s, depth=depth, tri_id=tri, clip_from_world=cam.clip_from_world,
                old_clip_from_world=old, world_from_clip=cam.world_from_clip,
                jitter=fi.jitter, frame_idx_mod_59=float(frame_idx % 59), row_offset=y0,
                full_size=(h, w)), cam, fi


def lighting_inputs(scene, h, w, seed=5, frame_idx=3, band=None, device="cpu", kg=2, ks=4):
    """(G-buffer, Globals, tables) for the lighting kernels: the plain
    G-buffer of gbuffer_inputs with roughness and metalness drawn from the
    seed; tables holds sun_depth [128,128], sun_u16, lut16 [16,16,2] f16,
    env (the f16 window-packed prefiltered sky, 16^2), the random GI grids
    ambient / spec [ceil(H/kg), ceil(W/kg), 3] and shafts [ceil(H/ks),
    ceil(W/ks), 3] (H the band's rows)."""
    kw, cam, fi = gbuffer_inputs(scene, h, w, frame_idx, band, device)
    static = gb.gbuffer_static(scene)
    g = gb.gbuffer_pass_plain(scene, static, kw["setup"], kw["depth"], kw["tri_id"],
                              kw["clip_from_world"], kw["old_clip_from_world"], 0.3,
                              kw["world_from_clip"], kw["jitter"], "stochastic",
                              kw["frame_idx_mod_59"], kw["row_offset"], kw["full_size"])
    rng = np.random.default_rng(seed)
    rows = g.depth.shape[0]
    orm = torch.from_numpy(rng.uniform(0.0, 1.0, (rows, w, 3)).astype(np.float32)).to(device)
    g = g._replace(orm=torch.where(g.coverage[..., None], orm, 0.0))
    cfg = frame_config(h, w)
    _, sd, _, _ = trender._rasterize(scene, fi.sun_from_world, 128, 128, cfg, cull="none",
                                     backend="xla")
    sun_depth = torch.where(torch.isinf(sd), 1.0, sd)
    env = torch.as_tensor(procedural.make_sky_cubemap(16), device=device)
    raw = ibl.bake_prefiltered_env(sampling.build_cube_mip_atlas(env), 16, 16, 8, 32)
    lut = ibl.bake_brdf_lut(16, 32, device=device)

    def grid(k, lo, hi):
        shape = (-(-rows // k), -(-w // k), 3)
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    tables = dict(sun_depth=sun_depth, sun_u16=sampling.quantize_u16(sun_depth),
                  lut16=lighting.brdf_lut_f16(lut),
                  env=sampling.pack_cube_mip_atlas_window(raw, 16),
                  ambient=grid(kg, 0.0, 2.0), spec=grid(kg, 0.0, 1.5), shafts=grid(ks, 0.0, 0.2))
    glob = trender.build_globals(cam, fi, frame_idx)
    return g, glob, tables, kw


def test_shade_inputs_cover_their_cases():
    scene = shade_scene("cpu")
    static = gb.gbuffer_static(scene)
    kw, _, _ = gbuffer_inputs(scene, 48, 64)
    tri = kw["tri_id"]
    assert bool((tri < 0).any()) and bool((tri >= 0).any())
    g = gb.gbuffer_pass_plain(scene, static, kw["setup"], kw["depth"], tri,
                              kw["clip_from_world"], kw["old_clip_from_world"], 0.3,
                              kw["world_from_clip"], kw["jitter"], "nearest", None)
    # the alpha test cuts some covered pixels of the checker material
    assert bool(((tri >= 0) & ~g.coverage).any())
    # mirrored and unmirrored uv among the covered triangles
    ids = torch.unique(tri[g.coverage])
    assert bool((ids % 3 == 0).any()) and bool((ids % 3 != 0).any())
