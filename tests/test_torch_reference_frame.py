"""Whole frames of the port's new paths against the JAX frames: reference GI
on the SunTemple stand-in (the repo's GI golden), a small
REFERENCE_PRODUCT-style frame with the interleave on, a small frame through
K1's hierarchical-z variant with the marched light shafts, and the lightgrid
debug view.

Tolerances: each frame SSIM >= 0.995 against the JAX frame (the repo's
backend-against-backend bar, tests/test_goldens.py:90-105); the SunTemple
frame SSIM >= 0.97 against tests/goldens/suntemple_gi.png (the bar of
tests/test_goldens.py:87).  The port renders with its own IBL bakes.
"""

import functools
import os

import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.assets import MaterialDesc as JMaterial
from vulkan_pbr_renderer_tpu.assets import build_scene as jbuild
from vulkan_pbr_renderer_tpu.assets import procedural as jproc
from vulkan_pbr_renderer_tpu.assets import suntemple as jtemple
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu_torch.utils import image
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.assets import suntemple as ttemple
from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene as tbuild
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as tv2

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "suntemple_gi.png")

# tests/test_goldens.py TINY: the reference GI mode the golden pins
TINY = JaxConfig(
    gi_mode="reference", width=160, height=96, shadow_map_size=128, lightgrid_size=16,
    lightgrid_extent=10.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
    prefilter_samples=256, brdf_lut_size=16, brdf_lut_samples=256, irradiance_size=8,
    irradiance_samples=64, bloom_pass_count=3, gi_screen_trace_steps=4, gi_diffuse_steps=4,
    gi_specular_steps=4, light_shaft_steps=4)

# tests/test_frame.py SMALL, GI on
SMALL = JaxConfig(
    width=96, height=64, shadow_map_size=128, lightgrid_size=16, lightgrid_extent=8.0,
    prefiltered_env_size=16, prefiltered_env_min_size=8, prefilter_samples=512,
    brdf_lut_size=16, brdf_lut_samples=128, irradiance_size=8, irradiance_samples=64,
    bloom_pass_count=3, gi_screen_trace_steps=6, gi_diffuse_steps=4, gi_specular_steps=4,
    light_shaft_steps=4)
SUNS = [(40.0, 20.0), (45.0, 30.0)]   # the sun moves on frame 1
CAM = ((5.0, -6.0, 3.0), (0.0, 0.0, 1.0))


def port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


def _port_camera(jcam):
    return tr.CameraState(*(torch.from_numpy(np.array(x)) for x in jcam))


@functools.cache
def _plane_cube():
    """tests/test_frame.py::_test_scene, built by the JAX package."""
    mats = [JMaterial(base_color=jproc.checker_texture(32, 4, (1, 1, 1), (0.3, 0.3, 0.35)),
                      orm_factor=(1.0, 0.6, 0.0)),
            JMaterial(base_color_factor=(0.8, 0.2, 0.2, 1.0), orm_factor=(1.0, 0.3, 0.0),
                      emissive_factor=(0.6, 0.3, 0.1))]
    parts = [jproc.make_plane((0, 0, 0), (12, 12), 2, 0, uv_scale=4),
             jproc.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    return jbuild(parts, mats, texture_size=32)


def _frames_match(jcfg, n_frames=2):
    """Render n_frames of the plane + cube scene through both packages (JAX
    on its pallas raster backend) and hold each port frame to the JAX one."""
    scene = _plane_cube()
    jrend = jr.Renderer(jcfg, scene, use_cache=False, raster_backend="pallas")
    jcam = jr.make_camera(*CAM, jcfg)
    r = tr.Renderer(port_cfg(jcfg),
                    convert.scene_from_numpy({k: np.asarray(v)
                                              for k, v in scene._asdict().items()},
                                             device="cpu"),
                    device="cpu", raster_backend="pallas")
    cam = _port_camera(jcam)
    for i, sun in enumerate(SUNS[:n_frames]):
        want = np.asarray(jrend.render(jcam, sun_angle=sun))
        got = r.render(cam, sun_angle=sun).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        s = image.ssim(got, want)
        assert s >= 0.995, f"frame {i}: SSIM {s}"
    return r


@functools.cache
def _suntemple_frames():
    """The golden's frame (test_golden_suntemple_gi: detail 0.2, camera
    path 0.3, sun (35, 80), 2 frames) through JAX and through the port."""
    jscene = jbuild(jtemple.build_parts(0.2), jtemple.materials(), texture_size=32)
    jrend = jr.Renderer(TINY, jscene, use_cache=False, raster_backend="xla")
    jcam = jr.make_camera(*jtemple.camera_path(0.3), TINY)
    r = tr.Renderer(port_cfg(TINY), tbuild(ttemple.build_parts(0.2), ttemple.materials(),
                                           texture_size=32, device="cpu"), device="cpu",
                    raster_backend="pallas")
    cam = tr.make_camera(*ttemple.camera_path(0.3), r.cfg, device="cpu")
    for _ in range(2):
        want = np.asarray(jrend.render(jcam, sun_angle=(35.0, 80.0)))
        got = r.render(cam, sun_angle=(35.0, 80.0)).numpy()
    return got, want


def test_suntemple_reference_gi_matches_jax():
    got, want = _suntemple_frames()
    assert got.shape == (96, 160, 3) and np.isfinite(got).all()
    s = image.ssim(got, want)
    assert s >= 0.995, f"SSIM {s}"


def test_suntemple_reference_gi_matches_golden():
    got, _ = _suntemple_frames()
    golden = image.read_png(GOLDEN).astype(np.float32) / 255.0
    s = image.ssim(got, golden)
    assert s >= 0.97, f"SSIM {s}"


def test_reference_product_frames_match_jax():
    """REFERENCE_PRODUCT's knobs (the interleave in reference mode, the
    trace depth at [::2, ::2]) at 128x72 with 4 bloom passes, whose bloom
    chain and previous-frame pyramid meet an odd size (9 -> 4 rows) as
    1920x1080's do (135 -> 67)."""
    r = _frames_match(SMALL.replace(width=128, height=72, bloom_pass_count=4,
                                    gi_mode="reference", gi_temporal_reference=True,
                                    gi_reference_depth_div=2))
    assert r.state.gi_cache.shape == (2, 36, 64, 3)


def test_hiz_frames_match_jax():
    """K1's hierarchical-z variant for both raster passes (its plain version
    on the CPU), with the marched light shafts."""
    before = tv2.vis_folded_tiles.launches, tv2.vis_folded_hiz_tiles.launches
    _frames_match(SMALL.replace(raster_hiz=True, light_shaft_mode="march",
                                shaft_res_divisor=1))
    assert (tv2.vis_folded_tiles.launches, tv2.vis_folded_hiz_tiles.launches) == before


def test_visualize_lightgrid_frame_matches_jax():
    _frames_match(SMALL.replace(visualize_lightgrid=True, enable_taa=False), n_frames=1)
