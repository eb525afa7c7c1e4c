"""The port's GI-on frames against the JAX pallas-backend frames, through
both raster kernels (folded and rowblock), plus the GI state carried across
mid-run and the rowblock tile-capacity overflow check.

Scene and config: tests/test_frame.py's SMALL (96x64, lightgrid 16) with GI
on in the default fast mode — the temporal interleave, cycle noise, fog
march and linear screen trace all active.  3 frames, the sun moving on the
third.  Tolerances: each frame SSIM >= 0.995 against the JAX frame (the
repo's backend-against-backend bar, tests/test_goldens.py:90-105); the
voxelized grid of frame 0 bit-equal; overflow verdicts equal.
"""

import functools

import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.assets import MaterialDesc as JMaterial
from vulkan_pbr_renderer_tpu.assets import build_scene as jbuild
from vulkan_pbr_renderer_tpu.assets import procedural as jproc
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu_torch.utils import image
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

# tests/test_frame.py SMALL, GI on
SMALL = JaxConfig(
    width=96, height=64, shadow_map_size=128, lightgrid_size=16,
    lightgrid_extent=8.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
    prefilter_samples=512, brdf_lut_size=16, brdf_lut_samples=128,
    irradiance_size=8, irradiance_samples=64, bloom_pass_count=3,
    gi_screen_trace_steps=6, gi_diffuse_steps=4, gi_specular_steps=4,
    light_shaft_steps=4)
SUNS = [(40.0, 20.0), (40.0, 20.0), (45.0, 30.0)]   # the sun moves on frame 2
CAM = ((5.0, -6.0, 3.0), (0.0, 0.0, 1.0))


def port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


def _scene_parts():
    """tests/test_frame.py::_test_scene, built by the JAX package."""
    mats = [
        JMaterial(base_color=jproc.checker_texture(32, 4, (1, 1, 1), (0.3, 0.3, 0.35)),
                  orm_factor=(1.0, 0.6, 0.0)),
        JMaterial(base_color_factor=(0.8, 0.2, 0.2, 1.0), orm_factor=(1.0, 0.3, 0.0)),
    ]
    parts = [jproc.make_plane((0, 0, 0), (12, 12), 2, 0, uv_scale=4),
             jproc.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    return jbuild(parts, mats, texture_size=32)


def _np_state(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


@functools.cache
def _jax_run(kernel):
    """JAX pallas-backend frames, per-frame states and frame 0's voxelized
    grid for one raster kernel."""
    from vulkan_pbr_renderer_tpu.shade import gi as jgi

    cfg = SMALL.replace(raster_kernel=kernel)
    scene = _scene_parts()
    r = jr.Renderer(cfg, scene, use_cache=False, raster_backend="pallas")
    cam = jr.make_camera(*CAM, cfg)
    imgs, states = [], []
    for sun in SUNS:
        states.append(_np_state(r.state))
        imgs.append(np.asarray(r.render(cam, sun_angle=sun)))
    # frame 0's voxelize pass, from the sun map frame 0 drew
    fi = jr.frame_inputs(jr.init_frame_state(r.cfg), cam, np.asarray(SUNS[0], np.float32),
                         r.cfg)
    grid = np.asarray(jgi.decode_voxel_grid(jgi.voxelize_scene(
        scene, cfg.lightgrid_size, cfg.lightgrid_scale, states[1]["sun_depth"],
        fi.sun_from_world, fi.sun_dir,
        cfg.voxelize_sun_emission_scale * np.asarray(cfg.sun_color, np.float32),
        total_samples=r.cfg.voxelize_samples)))
    return scene, r, cam, imgs, states, grid


def _port_renderer(kernel):
    scene, jrend, *_ = _jax_run(kernel)
    r = tr.Renderer(port_cfg(SMALL.replace(raster_kernel=kernel)),
                    convert.scene_from_numpy({k: np.asarray(v)
                                              for k, v in scene._asdict().items()},
                                             device="cpu"),
                    device="cpu", raster_backend="pallas")
    r.prefiltered_env, r.brdf_lut = convert.bakes_from_numpy(
        np.asarray(jrend.prefiltered_env_raw), np.asarray(jrend.brdf_lut), device="cpu")
    return r


def _port_camera(jcam):
    return tr.CameraState(*(torch.from_numpy(np.array(x)) for x in jcam))


@pytest.mark.parametrize("kernel", ["folded", "rowblock"])
def test_gi_frames_match_jax_pallas_frames(kernel):
    _, jrend, jcam, jimgs, jstates, _ = _jax_run(kernel)
    r = _port_renderer(kernel)
    assert r.cfg.voxelize_samples == jrend.cfg.voxelize_samples
    cam = _port_camera(jcam)
    for i, sun in enumerate(SUNS):
        img = r.render(cam, sun_angle=sun).numpy()
        assert img.shape == (64, 96, 3) and np.isfinite(img).all()
        s = image.ssim(img, jimgs[i])
        assert s >= 0.995, f"{kernel} frame {i}: SSIM {s}"
    assert r.state.voxelize_count == 2          # frames 0 and 2 (the sun moved)
    assert r.state.gi_cache.shape == (2, 32, 48, 3)
    assert float(r.state.lightgrid.abs().sum()) > 0.0
    ok, _ = r.check_overflow()
    jok, _ = jrend.check_overflow()
    assert ok == jok


def test_voxelized_grid_bit_equal_to_jax():
    from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
    from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow

    _, jrend, _, _, states, want = _jax_run("folded")
    r = _port_renderer("folded")
    cfg = r.cfg
    sun_from_world, sun_dir = tshadow.sun_matrices(*SUNS[0], cfg.sun_half_size)
    got = tgi.decode_voxel_grid(tgi.voxelize_scene(
        r.scene, cfg.lightgrid_size, cfg.lightgrid_scale,
        torch.from_numpy(states[1]["sun_depth"]), sun_from_world, sun_dir,
        cfg.voxelize_sun_emission_scale * torch.tensor(cfg.sun_color),
        total_samples=cfg.voxelize_samples))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel", ["folded", "rowblock"])
def test_gi_state_carried_from_jax(kernel):
    """Frame 2 from the JAX state after frame 1 (lightgrid, GI cache, TAA
    history, sun map) matches the JAX frame 2."""
    _, _, jcam, jimgs, jstates, _ = _jax_run(kernel)
    r = _port_renderer(kernel)
    r.state = convert.state_from_numpy(jstates[2], device="cpu")
    np.testing.assert_array_equal(r.state.lightgrid.numpy(), jstates[2]["lightgrid"])
    np.testing.assert_array_equal(r.state.gi_cache.numpy(), jstates[2]["gi_cache"])
    img = r.render(_port_camera(jcam), sun_angle=SUNS[2]).numpy()
    assert image.ssim(img, jimgs[2]) >= 0.995


def test_rowblock_check_overflow_matches_jax():
    """tests/test_raster_pallas.py::test_renderer_check_overflow on the
    port: the sphere's sun raster overflows tile_capacity=128 on the
    rowblock kernel (both packages flag it); the folded kernel does not."""
    jcfg = JaxConfig(
        width=128, height=64, shadow_map_size=64, lightgrid_size=8,
        prefiltered_env_size=16, prefiltered_env_min_size=8, prefilter_samples=16,
        brdf_lut_size=16, brdf_lut_samples=16, bloom_pass_count=2, light_shaft_steps=2,
        tile_capacity=128, tri_chunk=128, raster_kernel="rowblock",
        enable_gi=False, enable_taa=False, enable_bloom=False, enable_light_shafts=False,
        enable_ibl=False)
    jscene = jbuild([jproc.make_uv_sphere((0, 0, 1), 1.0, 12, 24, 0)], [JMaterial()],
                    texture_size=16)
    jrend = jr.Renderer(jcfg, jscene, use_cache=False, raster_backend="pallas")
    jrend.render(jr.make_camera((0.0, -4.0, 1.0), (0.0, 0.0, 1.0), jcfg))
    jok, jmsg = jrend.check_overflow()

    scene = convert.scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()},
                                     device="cpu")
    r = tr.Renderer(port_cfg(jcfg), scene, device="cpu", raster_backend="pallas")
    r.render(tr.make_camera((0.0, -4.0, 1.0), (0.0, 0.0, 1.0), r.cfg, device="cpu"))
    ok, msg = r.check_overflow()
    assert not ok and not jok and "tile segment" in msg
    np.testing.assert_array_equal(r.state.raster_overflow.numpy(),
                                  np.asarray(jrend.state.raster_overflow))
    with pytest.raises(RuntimeError):
        r.check_overflow(strict=True)
    r2 = tr.Renderer(port_cfg(jcfg).replace(raster_kernel="folded"), scene, device="cpu",
                     raster_backend="pallas")
    r2.render(tr.make_camera((0.0, -4.0, 1.0), (0.0, 0.0, 1.0), r2.cfg, device="cpu"))
    assert r2.check_overflow()[0]
