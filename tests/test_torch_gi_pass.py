"""The port's gi_pass (shade/gi_modes.py) and the GI branch of its lighting
pass against the JAX package, on a JAX G-buffer, sun map and swept
lightgrid of the plane + cube scene at 96x64 (frame 3) with a seed-made
previous bloom pyramid and GI cache.

Tolerance: >= 99% of values within 1e-4 and the mean |difference| below
1e-4 — the bent normal's acos/sin/cos round differently in the two
packages, which moves an occasional screen-trace decision.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu.shade import gbuffer as jgb
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu.shade import gi_modes as jgm
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu.utils import noise as jnoise
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as tgb
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import gi_modes as tgm
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight


def _t(x):
    return torch.from_numpy(np.array(x))


JCFG = JaxConfig(width=96, height=64, shadow_map_size=128, lightgrid_size=16,
                 lightgrid_extent=8.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
                 prefilter_samples=64, brdf_lut_size=16, brdf_lut_samples=64,
                 bloom_pass_count=3, light_shaft_steps=4)


def _port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


@functools.cache
def _jax_gi_inputs():
    """A JAX G-buffer, sun map, swept lightgrid, previous bloom pyramid and GI
    cache of the plane + cube scene at 96x64, frame 3."""
    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4), orm_factor=(1, .6, .3)),
            MaterialDesc(base_color_factor=(0.7, 0.2, 0.15, 1.0), orm_factor=(1.0, .35, 0),
                         emissive_factor=(0.5, 0.2, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (14, 14), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    scene = build_scene(parts, mats, texture_size=32)
    cfg = JCFG
    cam = jr.make_camera((5.0, -6.0, 3.0), (0.0, 0.0, 1.0), cfg)
    state = jr.init_frame_state(cfg)._replace(frame_idx=jnp.int32(3))
    fi = jr.frame_inputs(state, cam, jnp.asarray([40.0, 20.0], jnp.float32), cfg)

    @jax.jit
    def frame(scene, cam, fi):
        s, depth, tri, _ = jr._rasterize(scene, cam.clip_from_world, cfg.width, cfg.height,
                                         jitter=fi.jitter)
        _, sd, _, _ = jr._rasterize(scene, fi.sun_from_world, cfg.shadow_map_size,
                                    cfg.shadow_map_size, cull="none")
        sun_depth = jnp.where(jnp.isinf(sd), 1.0, sd)
        gbuf = jgb.gbuffer_pass(scene, s, jnp.where(jnp.isinf(depth), 1.0, depth), tri,
                                cam.clip_from_world, cam.clip_from_world, 0.3,
                                world_from_clip=cam.world_from_clip, jitter=fi.jitter,
                                frame_idx_mod_59=jnp.float32(3.0))
        grid = jgi.decode_voxel_grid(jgi.voxelize_scene(
            scene, 16, cfg.lightgrid_scale, sun_depth, fi.sun_from_world, fi.sun_dir,
            5.0 * jnp.asarray(cfg.sun_color), total_samples=1 << 14))
        for ax in (2, 1, 0):
            grid = jgi.sweep_lightgrid(grid, ax)
        return sun_depth, gbuf, grid

    sun_depth, gbuf, grid = frame(scene, cam, fi)
    rng = np.random.default_rng(11)
    _, wa = js.mip_offsets(32, 48, 3)
    prev = rng.uniform(0, 3, (32, wa, 3)).astype(np.float32)
    prev = np.asarray(jnp.asarray(prev).astype(jnp.bfloat16).astype(jnp.float32))
    cache = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    return cam, fi, sun_depth, gbuf, grid, prev, cache


def _globals(cam, fi, f59, port):
    fields = dict(
        clip_from_world=cam.clip_from_world, clip_from_view=cam.clip_from_view,
        world_from_clip=cam.world_from_clip, view_from_clip=cam.view_from_clip,
        view_from_world=cam.view_from_world, world_from_view=cam.world_from_view,
        sun_from_world=fi.sun_from_world, old_clip_from_world=cam.clip_from_world,
        sun_direction=fi.sun_dir, camera_pos=cam.position, taa_jitter=fi.jitter,
        taa_jitter_prev=fi.jitter_prev)
    if port:
        return tlight.Globals(frame_idx_mod_59=f59, **{k: _t(v) for k, v in fields.items()})
    return jlight.Globals(frame_idx_mod_59=jnp.float32(f59), **fields)


def _sub_inputs(gbuf, glob):
    """The JAX package's (n, roughness, p_world, p_view, noises) at the
    [::k, ::k] grid, as its lighting pass builds them (the port's gi_pass
    builds its own from the G-buffer: gi_modes.gi_lane_inputs)."""
    depth, n, rough = gbuf.depth, gbuf.normal, gbuf.orm[..., 1]

    def sub(k, f59_=None):
        f59_ = glob.frame_idx_mod_59 if f59_ is None else f59_
        dd = depth[::k, ::k]
        hd, wd = dd.shape
        pw, pv = jlight.reconstruct_positions(dd, glob.world_from_clip,
                                              glob.view_from_clip, 0, depth.shape[0],
                                              stride=k)
        px = jnp.broadcast_to(jnp.arange(wd, dtype=jnp.float32)[None, :] * k + 0.5,
                              (hd, wd))
        py = jnp.broadcast_to(jnp.arange(hd, dtype=jnp.float32)[:, None] * k + 0.5,
                              (hd, wd))
        noises = tuple(jnoise.frame_noise(px, py, f59_, offset=o)
                       for o in ((0.0, 0.0), (90.0, 20.0), (522.0, 55.0)))
        return n[::k, ::k], rough[::k, ::k], pw, pv, noises

    return sub


def _mostly_close(got, want, tol=1e-4, share=0.99, mean_tol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    assert (diff <= tol).mean() >= share, (diff <= tol).mean()
    assert diff.mean() <= mean_tol, diff.mean()


# (name, config changes): the defaults (checker interleave, cycle noise);
# the interleave by columns with the screen term off; no interleave with
# the other GI options at their non-default values
GI_VARIANTS = [
    ("defaults", {}),
    ("columns_no_screen", dict(gi_temporal_pattern="columns", gi_fast_screen_probe=False)),
    ("variants", dict(gi_temporal_div=1, gi_noise_offset=1, gi_fast_fog_trilinear=False,
                      gi_trace_depth_mode="min", gi_res_divisor_diffuse=4,
                      gi_specular_foggyness_is_roughness=False, gi_trace_solid_taps=3)),
    # the economy mode (no interleave) with the probe, and with "hiz" (the
    # same probe) through one point after march_to_hit
    ("economy_probes", dict(gi_fast_march=False, gi_fast_screen_mode="probes",
                            gi_fast_diffuse_hit_steps=3)),
    ("economy_hiz", dict(gi_fast_march=False, gi_fast_screen_mode="hiz",
                         gi_fast_spec_hit_steps=4, gi_fast_probe_points=1)),
    # the hi-z screen term, and the probes with their knobs off the defaults
    ("hiz", dict(gi_fast_screen_mode="hiz")),
    ("probes_knobs", dict(gi_fast_screen_mode="probes", gi_fast_probe_growth=1.3,
                          gi_fast_probe_jitter=0.5, gi_fast_probe_solid_taps=2,
                          gi_fast_probe_overshoot=2.0, gi_fast_probe_dist_mip=0.4,
                          gi_fast_probe_to_stop=True)),
    # the wave-9 march under the trace and the probes
    ("wave9_trace", dict(gi_fast_fog_march=False)),
    ("wave9_probes", dict(gi_fast_fog_march=False, gi_fast_screen_mode="probes",
                          gi_fast_probe_fullres_depth=True, gi_temporal_pattern="columns")),
]


@pytest.mark.parametrize("name,changes", GI_VARIANTS, ids=[v[0] for v in GI_VARIANTS])
def test_gi_pass_matches_jax(name, changes):
    cam, fi, _, gbuf, grid, prev, cache = _jax_gi_inputs()
    jcfg = JCFG.replace(**changes)
    interleave = jgm.gi_temporal_active(jcfg)
    assert tgm.gi_temporal_active(_port_cfg(jcfg)) == interleave
    jres = jlight.LightingResources(sun_depth=None, lightgrid=grid, prefiltered_env=None,
                                    brdf_lut=None,
                                    prev_frame_atlas=jnp.asarray(prev).astype(jnp.bfloat16))
    jglob = _globals(cam, fi, 3.0, False)
    jc = jnp.asarray(cache) if interleave else None
    want = jgm.gi_pass(jcfg, jglob, jres, _sub_inputs(gbuf, jglob), gbuf.depth,
                       64, 96, jglob.frame_idx_mod_59, gi_cache=jc,
                       frame_idx=jnp.int32(3) if interleave else None)
    tgbuf = tgb.GBuffer(*map(_t, gbuf))
    tres = tlight.LightingResources(sun_depth=None, prefiltered_env=None, brdf_lut=None,
                                    lightgrid=_t(grid), lightgrid_u8=tgi.quantize_grid_u8(_t(grid)),
                                    prev_frame_atlas=_t(prev).to(torch.bfloat16))
    tglob = _globals(cam, fi, 3.0, True)
    got = tgm.gi_pass(_port_cfg(jcfg), tglob, tres, tgbuf,
                      tgbuf.depth, 64, 96, 3.0, gi_cache=_t(cache) if interleave else None,
                      frame_idx=3 if interleave else None)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        _mostly_close(a.numpy(), b)
    if interleave:
        _mostly_close(got[2].numpy(), want[2])
    else:
        assert got[2] is None and want[2] is None


def test_gi_lighting_pass_matches_jax():
    cam, fi, sun_depth, gbuf, grid, prev, cache = _jax_gi_inputs()
    from vulkan_pbr_renderer_tpu.bake import ibl as jibl

    env = jnp.asarray(procedural.make_sky_cubemap(16))
    raw = jibl.bake_prefiltered_env(js.build_cube_mip_atlas(env), 16, 16, 8, 64)
    lut = jibl.bake_brdf_lut(16, 64)
    jres = jlight.LightingResources(
        sun_depth=sun_depth, lightgrid=grid, prefiltered_env=js.pack_cube_mip_atlas_window(
            raw, 16), brdf_lut=lut, prev_frame_atlas=jnp.asarray(prev).astype(jnp.bfloat16))
    want, want_cache = jlight.lighting_pass(gbuf, _globals(cam, fi, 3.0, False), jres, JCFG,
                                            gi_cache=jnp.asarray(cache),
                                            frame_idx=jnp.int32(3))
    env16, tlut = convert.bakes_from_numpy(np.asarray(raw), np.asarray(lut), device="cpu")
    tres = tlight.LightingResources(sun_depth=_t(sun_depth), prefiltered_env=env16,
                                    brdf_lut=tlut, lightgrid=_t(grid),
                                    lightgrid_u8=tgi.quantize_grid_u8(_t(grid)),
                                    prev_frame_atlas=_t(prev).to(torch.bfloat16))
    got, got_cache = tlight.lighting_pass(tgb.GBuffer(*map(_t, gbuf)),
                                          _globals(cam, fi, 3.0, True), tres, _port_cfg(JCFG),
                                          gi_cache=_t(cache), frame_idx=3)
    _mostly_close(got.numpy(), want)
    _mostly_close(got_cache.numpy(), want_cache)
