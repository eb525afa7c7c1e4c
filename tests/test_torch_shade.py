"""The port's shading passes and IBL bakes against the JAX package, each fed
the same inputs (upstream JAX outputs handed over as numpy).

Tolerances: f32 shading atol 1e-5 (relative 1e-5 where values exceed 1);
the Monte-Carlo bakes rtol 2e-5 (each chunk's samples are summed in another
order than XLA's).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer_tpu.bake import ibl as jibl
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu.gpu import sampling as jsamp
from vulkan_pbr_renderer_tpu.shade import bloom as jbloom
from vulkan_pbr_renderer_tpu.shade import brdf as jbrdf
from vulkan_pbr_renderer_tpu.shade import gbuffer as jgb
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu.shade import shadow as jshadow
from vulkan_pbr_renderer_tpu.shade import taa as jtaa
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.bake import ibl as tibl
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as tsamp
from vulkan_pbr_renderer_tpu_torch.raster import setup as tsetup
from vulkan_pbr_renderer_tpu_torch.shade import bloom as tbloom
from vulkan_pbr_renderer_tpu_torch.shade import brdf as tbrdf
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as tgb
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow
from vulkan_pbr_renderer_tpu_torch.shade import taa as ttaa

# tests/test_goldens.py TINY with GI off: the fields the port reads
JCFG = JaxConfig(
    width=160, height=96, shadow_map_size=128, lightgrid_size=16, lightgrid_extent=10.0,
    prefiltered_env_size=16, prefiltered_env_min_size=8, prefilter_samples=256,
    brdf_lut_size=16, brdf_lut_samples=256, bloom_pass_count=3, light_shaft_steps=4,
    enable_gi=False)


def port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_brdf_terms_match_jax():
    rng = np.random.default_rng(0)
    n = 256
    nh, vn, ln, vh = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(4))
    rough = rng.uniform(0.05, 1, n).astype(np.float32)
    f0 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    _close(tbrdf.distribution_ggx(_t(nh), _t(rough)), jbrdf.distribution_ggx(nh, rough))
    _close(tbrdf.distribution_beckmann(_t(nh), _t(rough)), jbrdf.distribution_beckmann(nh, rough))
    _close(tbrdf.geometry_mikkelsen(_t(nh), _t(vn), _t(ln), _t(vh)),
           jbrdf.geometry_mikkelsen(nh, vn, ln, vh))
    _close(tbrdf.fresnel_schlick(_t(vn), _t(f0)), jbrdf.fresnel_schlick(vn, jnp.asarray(f0)))
    vecs = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    vecs = [v / np.linalg.norm(v, axis=-1, keepdims=True) for v in vecs]
    metal = rng.uniform(0, 1, n).astype(np.float32)
    _close(tbrdf.cook_torrance_direct(*map(_t, vecs), _t(f0), _t(rough), _t(metal)),
           jbrdf.cook_torrance_direct(*map(jnp.asarray, vecs), jnp.asarray(f0),
                                      jnp.asarray(rough), jnp.asarray(metal)))


@pytest.mark.parametrize("angle", [(50.0, 30.0), (40.0, 120.0), (-10.0, 275.0)])
def test_sun_matrices_match_jax(angle):
    tm, td = tshadow.sun_matrices(*angle, 40.0)
    jm, jd = jshadow.sun_matrices(jnp.float32(angle[0]), jnp.float32(angle[1]), 40.0)
    _close(tm, jm, 1e-6)
    _close(td, jd, 1e-6)


@functools.cache
def _jax_frame_inputs():
    """One JAX raster + G-buffer of the plane + cube scene at the TINY size:
    the upstream inputs handed to the port's passes."""
    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4),
                         normal=procedural.bump_normal_texture(32),
                         orm_factor=(1.0, 0.6, 0.3), alpha_test=True),
            MaterialDesc(base_color_factor=(0.7, 0.2, 0.15, 1.0), orm_factor=(1.0, 0.35, 0.0),
                         emissive_factor=(0.5, 0.2, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (14, 14), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    scene = build_scene(parts, mats, texture_size=32)
    cfg = JCFG
    cam = jr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg)
    state = jr.init_frame_state(cfg)._replace(frame_idx=jnp.int32(3))
    fi = jr.frame_inputs(state, cam, jnp.asarray([40.0, 120.0], jnp.float32), cfg)
    s, depth, tri, _ = jr._rasterize(scene, cam.clip_from_world, cfg.width, cfg.height,
                                     jitter=fi.jitter)
    _, sd, _, _ = jr._rasterize(scene, fi.sun_from_world, cfg.shadow_map_size,
                                cfg.shadow_map_size, cull="none")
    sun_depth = jnp.where(jnp.isinf(sd), 1.0, sd)
    depth1 = jnp.where(jnp.isinf(depth), 1.0, depth)
    old = cam.clip_from_world @ jnp.asarray(np.eye(4, dtype=np.float32) + 0.01)
    gbuf = jgb.gbuffer_pass(scene, s, depth1, tri, cam.clip_from_world, old,
                            cfg.alpha_test_threshold, world_from_clip=cam.world_from_clip,
                            jitter=fi.jitter, material_filter="stochastic",
                            frame_idx_mod_59=jnp.float32(3.0))
    return scene, cam, fi, s, depth1, tri, old, sun_depth, gbuf


def _port_scene(scene):
    return convert.scene_from_numpy({k: np.asarray(v) for k, v in scene._asdict().items()},
                                   device="cpu")


@pytest.mark.parametrize("material_filter", ["stochastic", "trilinear", "nearest"])
def test_gbuffer_pass_matches_jax(material_filter):
    scene, cam, fi, s, depth1, tri, old, _, gbuf = _jax_frame_inputs()
    if material_filter != "stochastic":
        gbuf = jgb.gbuffer_pass(scene, s, depth1, tri, cam.clip_from_world, old, 0.3,
                                world_from_clip=cam.world_from_clip, jitter=fi.jitter,
                                material_filter=material_filter,
                                frame_idx_mod_59=jnp.float32(3.0))
    got = tgb.gbuffer_pass(
        _port_scene(scene), tsetup.TriSetup(*map(_t, s)), _t(depth1), _t(tri),
        _t(cam.clip_from_world), _t(old), 0.3, world_from_clip=_t(cam.world_from_clip),
        jitter=_t(fi.jitter), material_filter=material_filter, frame_idx_mod_59=3.0)
    assert bool(np.asarray(gbuf.coverage).any())
    np.testing.assert_array_equal(got.coverage.numpy(), np.asarray(gbuf.coverage))
    for name in ("normal", "orm", "emissive", "depth", "velocity"):
        _close(getattr(got, name), getattr(gbuf, name))
    # XLA fuses the barycentric dot products into FMAs on the CPU, the port
    # rounds each product: uv moves by an ulp and the bilinear texel weights
    # follow the checker texture's hard edges — still < 1/40 of a u8 quantum
    _close(got.base_color, gbuf.base_color, 1e-4)


def _globals(cam, fi, f59, port):
    fields = dict(
        clip_from_world=cam.clip_from_world, clip_from_view=cam.clip_from_view,
        world_from_clip=cam.world_from_clip, view_from_clip=cam.view_from_clip,
        view_from_world=cam.view_from_world, world_from_view=cam.world_from_view,
        sun_from_world=fi.sun_from_world, old_clip_from_world=fi.old_clip_from_world,
        sun_direction=fi.sun_dir, camera_pos=cam.position, taa_jitter=fi.jitter,
        taa_jitter_prev=fi.jitter_prev)
    if port:
        return tlight.Globals(frame_idx_mod_59=f59, **{k: _t(v) for k, v in fields.items()})
    return jlight.Globals(frame_idx_mod_59=jnp.float32(f59), **fields)


@functools.cache
def _jax_bakes():
    env = jnp.asarray(procedural.make_sky_cubemap(16))
    atlas = jsamp.build_cube_mip_atlas(env)
    raw = jibl.bake_prefiltered_env(atlas, 16, 16, 8, 64)
    return env, atlas, raw, jibl.bake_brdf_lut(16, 64)


@pytest.mark.parametrize("toggles", [
    {}, {"enable_ibl": False}, {"enable_shadows": False}, {"shaft_res_divisor": 1},
])
def test_lighting_pass_matches_jax(toggles):
    scene, cam, fi, s, depth1, tri, old, sun_depth, gbuf = _jax_frame_inputs()
    _, _, raw, lut = _jax_bakes()
    jcfg = JCFG.replace(**toggles)
    jres = jlight.LightingResources(
        sun_depth=sun_depth, lightgrid=jnp.zeros((4, 4, 4, 4)),
        prefiltered_env=jsamp.pack_cube_mip_atlas_window(raw, 16), brdf_lut=lut,
        prev_frame_atlas=jnp.zeros((48, 80, 3)))
    want = jlight.lighting_pass(gbuf, _globals(cam, fi, 3.0, False), jres, jcfg)
    env16, tlut = convert.bakes_from_numpy(np.asarray(raw), np.asarray(lut), device="cpu")
    tres = tlight.LightingResources(sun_depth=_t(sun_depth), prefiltered_env=env16,
                                    brdf_lut=tlut)
    tg = tgb.GBuffer(*map(_t, gbuf))
    got = tlight.lighting_pass(tg, _globals(cam, fi, 3.0, True), tres, port_cfg(jcfg))
    _close(got, want)


def test_light_shafts_polar_matches_jax():
    _, cam, fi, _, _, _, _, sun_depth, gbuf = _jax_frame_inputs()
    rng = np.random.default_rng(1)
    h, w = 24, 40
    pos = rng.uniform(-6, 6, (h, w, 3)).astype(np.float32)
    nrm = np.asarray(gbuf.normal)[::4, ::4]
    noise = rng.uniform(0, 1, (h, w)).astype(np.float32)
    em = np.array([25.0, 22.5, 17.5], np.float32)
    kw = dict(intensity=0.001, normal_offset=0.1, max_steps=12, n_theta=4096, n_r=12)
    want = jshadow.light_shafts_polar(sun_depth, fi.sun_from_world, cam.position,
                                      jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(noise),
                                      jnp.asarray(em), **kw)
    got = tshadow.light_shafts_polar(_t(sun_depth), _t(fi.sun_from_world), _t(cam.position),
                                     _t(pos), _t(nrm), _t(noise), _t(em), **kw)
    _close(got, want)


@pytest.mark.parametrize("catmull,full_rgb", [(True, False), (True, True), (False, False)])
def test_taa_resolve_matches_jax(catmull, full_rgb):
    rng = np.random.default_rng(2)
    h, w = 24, 40
    light = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    vel = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    vel_prev = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    hist = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    args = (light, depth, vel, vel_prev, hist)
    kw = dict(catmull_history=catmull, full_rgb_catmull=full_rgb)
    _close(ttaa.taa_resolve(*map(_t, args), 0.05, 1000.0, **kw),
           jtaa.taa_resolve(*map(jnp.asarray, args), 0.05, 1000.0, **kw))


# 135x240 and 54x96 meet odd sizes down the chain (as 1920x1080 does:
# 135 -> 67 -> 33), where the filter takes jax.image.resize's linear weights
@pytest.mark.parametrize("shape,passes", [((96, 160), 3), ((64, 64), 6), ((135, 240), 4),
                                          ((54, 96), 3)])
def test_bloom_matches_jax(shape, passes):
    hdr = np.random.default_rng(3).uniform(0, 3, shape + (3,)).astype(np.float32)
    out, downs = tbloom.bloom_with_pyramid(_t(hdr), passes, 0.06)
    jout, jdowns = jbloom.bloom_with_pyramid(jnp.asarray(hdr), passes, 0.06)
    _close(out, jout)
    for a, b in zip(downs, jdowns):
        _close(a, b)
    _close(tsamp.pack_mip_atlas(downs).to(torch.bfloat16).float(),
           jsamp.pack_mip_atlas(jdowns).astype(jnp.bfloat16).astype(jnp.float32), 1e-2)


@pytest.mark.parametrize("src,dst", [((9, 16), (36, 64)), ((18, 32), (54, 96)),
                                     ((27, 48), (54, 96))])
def test_lighting_upsample_matches_jax(src, dst):
    """lighting._up: exact 2x steps, then jax.image.resize's linear filter
    for a divisor that is not a power of two."""
    x = np.random.default_rng(4).uniform(0, 2, src + (3,)).astype(np.float32)
    _close(tlight._up(_t(x), *dst), jlight._up(jnp.asarray(x), *dst))


def test_bake_prefiltered_env_matches_jax():
    env, atlas, raw, _ = _jax_bakes()
    got = tibl.bake_prefiltered_env(tsamp.build_cube_mip_atlas(_t(env)), 16, 16, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(raw), rtol=2e-5, atol=1e-6)


def test_bake_brdf_lut_matches_jax():
    _, _, _, lut = _jax_bakes()
    np.testing.assert_allclose(tibl.bake_brdf_lut(16, 64, device="cpu").numpy(), np.asarray(lut),
                               rtol=2e-5, atol=1e-6)
