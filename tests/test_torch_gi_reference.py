"""The port's reference GI mode and the last two lighting options against
the eager JAX functions, on the same seed-made numpy inputs: the blockage
skip, the voxel march, `sample_radiance`, the hybrid screen + voxel march
`sample_radiance_with_screen_trace`, `gi_pass` in reference mode (with and
without the interleave, full and half-resolution trace depth), the marched
light shafts and the lightgrid debug view.

Tolerances: masks exactly equal; floats atol 1e-4 (every module here agrees
to a few ulp, up to 4e-6), except `gi_pass`, held as in
test_torch_gi_pass.py to >= 99% of values within 1e-4 and a mean
|difference| below 1e-4: the bent normal's acos/sin/cos round differently
in the two packages, which can move one screen-trace decision.  Eager JAX,
not jitted (jit contracts FMAs and moves results by up to 3e-3, ROADMAP
queue 3).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gi import _trace_inputs
from test_torch_gi_pass import (JCFG, _globals, _jax_gi_inputs, _mostly_close, _port_cfg,
                                _sub_inputs)
from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu.shade import gi_modes as jgm
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu.shade import shadow as jshadow
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as ts
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import gi_modes as tgm
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as tgb
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow

ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


@functools.cache
def _march_inputs(seed=8, d=16, n=600):
    """A random grid (40% occupied) in both packs, lanes inside it, unit
    directions, a seed sum and per-lane fog."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 3.0, (d, d, d, 4)).astype(np.float32)
    g[..., 3] = rng.random((d, d, d)) > 0.6
    ro = rng.uniform(-7.0, 7.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    s4 = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    fog = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    return g, ro, rd, s4, fog


def _packs(g):
    return ((jgi.pack_grid_u8(jnp.asarray(g)), jgi.pack_grid_alpha_u16(jnp.asarray(g))),
            (tgi.pack_grid_u8(_t(g)), tgi.pack_grid_alpha_u16(_t(g))))


@pytest.mark.parametrize("steps", [4, 12])
@pytest.mark.parametrize("alpha", [False, True])
def test_skip_blockage_matches_jax(steps, alpha):
    g, ro, rd, _, _ = _march_inputs()
    (jw, ja), (tw, ta) = _packs(g)
    ro, rd = ro * 0.125, rd * (2.0 / 16)
    want = jgi._skip_blockage(jw, jnp.asarray(ro), jnp.asarray(rd), steps, 0.3,
                              ja if alpha else None)
    got = tgi._skip_blockage(tw, _t(ro), _t(rd), steps, 0.3, ta if alpha else None)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < np.asarray(want[2]).mean() < 1


@pytest.mark.parametrize("accumulate_fog", [False, True])
def test_voxel_march_matches_jax(accumulate_fog):
    g, ro, rd, s4, fog = _march_inputs()
    (jw, _), (tw, _) = _packs(g)
    ro, rd = ro * 0.125, rd * (2.0 / 16)
    want = jgi._voxel_march(jw, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(s4), 12,
                            jnp.asarray(fog) if accumulate_fog else 0.0, accumulate_fog)
    got = tgi._voxel_march(tw, _t(ro), _t(rd), _t(s4), 12,
                           _t(fog) if accumulate_fog else 0.0, accumulate_fog)
    _close(got, want)


@pytest.mark.parametrize("alpha", [False, True])
def test_sample_radiance_matches_jax(alpha):
    g, ro, rd, _, _ = _march_inputs()
    (jw, ja), (tw, ta) = _packs(g)
    want = jgi.sample_radiance(jw, jnp.asarray(ro), jnp.asarray(rd), 0.125, 12, 1.5,
                               ja if alpha else None)
    got = tgi.sample_radiance(tw, _t(ro), _t(rd), 0.125, 12, 1.5, ta if alpha else None)
    _close(got, want)
    assert np.asarray(want).max() > 0.0


def _screen_trace_args(seed, port):
    """tests/test_gi_trace.py's inputs (on-screen view-space starts, a bumpy
    depth buffer, a half-open grid, a quarter of the lanes leaving the
    screen) made into the hybrid march's: world positions and view
    directions from the view transform, random unit rays, a bf16 pyramid."""
    i = _trace_inputs(seed)
    rng = np.random.default_rng(100 + seed)
    h, w = i["p0"].shape[:2]
    wfv = i["wfv"]
    p0 = i["p0"]
    pw = (p0 @ wfv[:3, :3].T + wfv[:3, 3]).astype(np.float32)
    vd = wfv[:3, 3] - pw
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    rd = rng.normal(size=(h, w, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    levels = [rng.uniform(0, 4, (16 >> k, 20 >> k, 3)).astype(np.float32) for k in range(3)]
    fog = rng.uniform(0, 1, (h, w)).astype(np.float32)
    mats = (np.linalg.inv(wfv), i["cfv"], np.linalg.inv(i["cfv"]), wfv)
    if port:
        conv, mod, atlas = _t, tgi, ts.pack_mip_atlas([_t(x) for x in levels]).to(torch.bfloat16)
    else:
        conv, mod = jnp.asarray, jgi
        atlas = js.pack_mip_atlas([jnp.asarray(x) for x in levels]).astype(jnp.bfloat16)
    pos = (mod.pack_grid_u8(conv(i["grid"])), conv(i["depth"]), atlas,
           *(conv(m.astype(np.float32)) for m in mats), conv(vd), conv(p0), conv(pw),
           conv(rd), 0.1, 6, 2.0, conv(i["noise"]))
    kw = dict(max_ss_steps=24, prev_base=(16, 20), prev_levels=3,
              alpha_grid=mod.pack_grid_alpha_u16(conv(i["grid"])))
    return pos, conv(fog), kw


@pytest.mark.parametrize("seed,fog", [(0, "lane"), (3, "scalar"), (5, "lane")])
def test_sample_radiance_with_screen_trace_matches_jax(seed, fog):
    (jpos, jfog, jkw), (tpos, tfog, tkw) = (_screen_trace_args(seed, p) for p in (False, True))
    jfog, tfog = (jfog, tfog) if fog == "lane" else (0.5, 0.5)
    want = jgi.sample_radiance_with_screen_trace(*jpos, jfog, 0.9, **jkw)
    got = tgi.sample_radiance_with_screen_trace(*tpos, tfog, 0.9, **tkw)
    _close(got, want)
    # the screen trace resolves some lanes (their value scales with the
    # screen intensity) and not others
    other = np.asarray(jgi.sample_radiance_with_screen_trace(*jpos, jfog, 0.45, **jkw))
    resolved = np.abs(other - np.asarray(want)).max(-1) > 0
    assert 0.02 < resolved.mean() < 0.98, resolved.mean()


@pytest.mark.parametrize("temporal,depth_div", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_gi_pass_reference_matches_jax(temporal, depth_div):
    cam, fi, _, gbuf, grid, prev, cache = _jax_gi_inputs()
    jcfg = JCFG.replace(gi_mode="reference", gi_temporal_reference=temporal,
                        gi_reference_depth_div=depth_div, gi_screen_trace_steps=8,
                        gi_diffuse_steps=6, gi_specular_steps=8)
    interleave = jgm.gi_temporal_active(jcfg)
    assert interleave == temporal
    assert tgm.gi_temporal_active(_port_cfg(jcfg)) == interleave
    jres = jlight.LightingResources(sun_depth=None, lightgrid=grid, prefiltered_env=None,
                                    brdf_lut=None,
                                    prev_frame_atlas=jnp.asarray(prev).astype(jnp.bfloat16))
    jglob = _globals(cam, fi, 3.0, False)
    want = jgm.gi_pass(jcfg, jglob, jres, _sub_inputs(gbuf, jglob), gbuf.depth,
                       64, 96, jglob.frame_idx_mod_59,
                       gi_cache=jnp.asarray(cache) if interleave else None,
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


def test_gi_temporal_active_reference_matches_jax():
    from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig

    for kw in (dict(gi_mode="reference"), dict(gi_mode="reference", gi_temporal_reference=True),
               dict(gi_mode="reference", gi_temporal_reference=True, height=66),
               dict(gi_mode="reference", gi_temporal_reference=True, enable_gi=False)):
        kw = {"width": 96, "height": 64, **kw}
        assert (tgm.gi_temporal_active(RenderConfig(**kw))
                == jgm.gi_temporal_active(JaxConfig(**kw)))


def test_light_shafts_march_matches_jax():
    rng = np.random.default_rng(12)
    sun_depth = rng.uniform(0.3, 1.0, (64, 64)).astype(np.float32)
    pos = rng.uniform(-12, 12, (40, 30, 3)).astype(np.float32)
    n = rng.normal(size=(40, 30, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    noise = rng.uniform(0, 1, (40, 30)).astype(np.float32)
    cam = np.array([3.0, -9.0, 4.0], np.float32)
    emission = 25.0 * np.asarray((1.0, 0.9, 0.7), np.float32)
    jm, _ = jshadow.sun_matrices(40.0, 20.0, 40.0)
    tm, _ = tshadow.sun_matrices(40.0, 20.0, 40.0)
    want = jshadow.light_shafts(jnp.asarray(sun_depth), jm, jnp.asarray(cam), jnp.asarray(pos),
                                jnp.asarray(n), jnp.asarray(noise), jnp.asarray(emission),
                                0.001, 0.1, max_steps=48,
                                wdepth=js.pack_depth_window_u16(jnp.asarray(sun_depth)))
    got = tshadow.light_shafts(_t(sun_depth), tm, _t(cam), _t(pos), _t(n), _t(noise),
                               _t(emission), 0.001, 0.1, max_steps=48,
                               wdepth=ts.pack_depth_window_u16(_t(sun_depth)))
    _close(got, want)
    assert np.asarray(want).std() > 0.0


def test_visualize_lightgrid_pass_matches_jax():
    from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig

    rng = np.random.default_rng(13)
    g = rng.uniform(0.0, 2.0, (16, 16, 16, 4)).astype(np.float32)
    g[..., 3] = (rng.random((16, 16, 16)) > 0.93).astype(np.float32)
    jcfg = JaxConfig(width=48, height=32, lightgrid_size=16, lightgrid_extent=8.0)
    cam = jr.make_camera((6.0, -7.0, 3.0), (0.0, 0.0, 1.0), jcfg)
    fields = dict(clip_from_world=cam.clip_from_world, clip_from_view=cam.clip_from_view,
                  world_from_clip=cam.world_from_clip, view_from_clip=cam.view_from_clip,
                  view_from_world=cam.view_from_world, world_from_view=cam.world_from_view,
                  sun_from_world=cam.clip_from_world, old_clip_from_world=cam.clip_from_world,
                  sun_direction=cam.position, camera_pos=cam.position,
                  taa_jitter=jnp.zeros(2), taa_jitter_prev=jnp.zeros(2))
    jglob = jlight.Globals(frame_idx_mod_59=jnp.float32(5.0), **fields)
    jres = jlight.LightingResources(sun_depth=None, lightgrid=jnp.asarray(g),
                                    prefiltered_env=None, brdf_lut=None, prev_frame_atlas=None)
    want = jlight.visualize_lightgrid_pass(jglob, jres, jcfg, 48, 32)
    tglob = tlight.Globals(frame_idx_mod_59=5.0, **{k: _t(v) for k, v in fields.items()})
    tres = tlight.LightingResources(sun_depth=None, prefiltered_env=None, brdf_lut=None,
                                    lightgrid=_t(g))
    got = tlight.visualize_lightgrid_pass(tglob, tres, _port_cfg(jcfg), 48, 32)
    assert got.shape == (32, 48, 3)
    _close(got, want)
    assert (np.asarray(want).max(-1) > 0).mean() > 0.5
