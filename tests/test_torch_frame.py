"""The port's whole frame against the JAX frame, plus the scene, the numpy
builders, the state carried across and the renderer's checks.

Tolerances: scene arrays and builder outputs exactly equal; camera
matrices atol 1e-5; frames SSIM >= 0.995 each (the repo's own
backend-against-backend bar, tests/test_goldens.py:90-105).

The plane + cube frames pass raster_backend="pallas" to both packages so
that they cover binning and the folded kernel's route; the default backend
("auto": the brute-force raster on scenes of at most 4096 triangles) is held
to the JAX default on tests/test_frame.py's SMALL scene.
"""

import functools

import jax.numpy as jnp
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
from vulkan_pbr_renderer_tpu_torch.assets import procedural as tproc
from vulkan_pbr_renderer_tpu_torch.assets import suntemple as ttemple
from vulkan_pbr_renderer_tpu_torch.assets.scene import MaterialDesc as TMaterial
from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene as tbuild
from vulkan_pbr_renderer_tpu_torch.bake import ibl as tibl
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

# tests/test_goldens.py TINY, GI off
TINY_NO_GI = JaxConfig(
    gi_mode="reference", width=160, height=96, shadow_map_size=128, lightgrid_size=16,
    lightgrid_extent=10.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
    prefilter_samples=256, brdf_lut_size=16, brdf_lut_samples=256, irradiance_size=8,
    irradiance_samples=64, bloom_pass_count=3, gi_screen_trace_steps=4, gi_diffuse_steps=4,
    gi_specular_steps=4, light_shaft_steps=4, enable_gi=False)
SUNS = [(40.0, 120.0), (40.0, 120.0), (45.0, 120.0)]   # the sun moves on frame 2


def port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


def _numpy_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _plane_cube(mod, material):
    """The scene of test_golden_pallas_matches_xla_frame."""
    return ([mod.make_plane((0, 0, 0), (12, 12), 2, 0), mod.make_cube((0, 0, 1.0), (2, 2, 2), 0)],
            [material(orm_factor=(1.0, 0.5, 0.0))])


def _port_camera(jcam):
    return tr.CameraState(*(torch.from_numpy(np.array(x)) for x in jcam))


@functools.cache
def _jax_run():
    """The JAX pallas-backend frames and per-frame states of the plane+cube
    scene at TINY with GI off."""
    cfg = TINY_NO_GI
    scene = jbuild(*_plane_cube(jproc, JMaterial), texture_size=16)
    r = jr.Renderer(cfg, scene, use_cache=False, raster_backend="pallas")
    cam = jr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg)
    imgs, states = [], []
    for sun in SUNS:
        states.append(jax_state_numpy(r.state))
        imgs.append(np.asarray(r.render(cam, sun_angle=sun)))
    return scene, r, cam, imgs, states


def jax_state_numpy(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def _port_renderer(scene, jrend):
    r = tr.Renderer(port_cfg(TINY_NO_GI), convert.scene_from_numpy(_numpy_fields(scene), device="cpu"),
                    device="cpu", raster_backend="pallas")
    r.prefiltered_env, r.brdf_lut = convert.bakes_from_numpy(
        np.asarray(jrend.prefiltered_env_raw), np.asarray(jrend.brdf_lut), device="cpu")
    return r


def test_frames_match_jax_pallas_frames():
    scene, jrend, jcam, jimgs, _ = _jax_run()
    r = _port_renderer(scene, jrend)
    cam = _port_camera(jcam)
    for i, sun in enumerate(SUNS):
        img = r.render(cam, sun_angle=sun).numpy()
        assert img.shape == (96, 160, 3) and np.isfinite(img).all()
        s = image.ssim(img, jimgs[i])
        assert s >= 0.995, f"frame {i}: SSIM {s}"
    assert r.state.frame_idx == 3 and r.state.sun_angle_prev == SUNS[-1]
    ok, _ = r.check_overflow()
    jok, _ = jrend.check_overflow()
    assert ok == jok


def test_state_carried_from_jax():
    """Frame 2 from the JAX state after frame 1 (TAA history, velocity,
    cached sun map) matches the JAX frame 2."""
    scene, jrend, jcam, jimgs, jstates = _jax_run()
    r = _port_renderer(scene, jrend)
    r.state = convert.state_from_numpy(jstates[2], device="cpu")
    assert r.state.frame_idx == 2 and r.state.sun_angle_prev == SUNS[1]
    img = r.render(_port_camera(jcam), sun_angle=SUNS[2]).numpy()
    assert image.ssim(img, jimgs[2]) >= 0.995


def test_build_scene_matches_jax():
    cases = [
        (_plane_cube(jproc, JMaterial), _plane_cube(tproc, TMaterial), 16),
        ((jtemple.build_parts(0.3), jtemple.materials()),
         (ttemple.build_parts(0.3), ttemple.materials()), 32),
    ]
    for jargs, targs, ts in cases:
        js = jbuild(*jargs, texture_size=ts)
        t = tbuild(*targs, texture_size=ts, device="cpu")
        for name, val in t._asdict().items():
            want = np.asarray(getattr(js, name))
            assert val.dtype == torch.from_numpy(want).dtype, name
            np.testing.assert_array_equal(val.numpy(), want, err_msg=name)


def test_numpy_builders_match_jax():
    np.testing.assert_array_equal(tproc.make_sky_cubemap(16), jproc.make_sky_cubemap(16))
    for jp, tp in zip(jtemple.build_parts(0.4), ttemple.build_parts(0.4)):
        for f in ("positions", "normals", "uvs", "indices", "material"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    for t in (0.0, 0.37, 1.0):
        for a, b in zip(ttemple.camera_path(t), jtemple.camera_path(t)):
            np.testing.assert_array_equal(a, b)


def test_make_camera_matches_jax():
    cfg = TINY_NO_GI
    jcam = jr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg)
    tcam = tr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), port_cfg(cfg), device="cpu")
    for a, b in zip(tcam, jcam):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_renderer_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = tbuild(*_plane_cube(tproc, TMaterial), texture_size=16, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.Renderer(port_cfg(TINY_NO_GI), scene, device="cuda")


def test_builders_default_to_cuda_and_raise_without_it():
    """build_scene, make_camera, bake_brdf_lut and convert.*_from_numpy run
    on the card unless asked for the CPU, so without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    parts = _plane_cube(tproc, TMaterial)
    scene = tbuild(*parts, texture_size=16, device="cpu")
    fields = {k: v.numpy() for k, v in scene._asdict().items()}
    calls = [lambda: tbuild(*parts, texture_size=16),
             lambda: tr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), port_cfg(TINY_NO_GI)),
             lambda: tibl.bake_brdf_lut(8, 16),
             lambda: convert.scene_from_numpy(fields),
             lambda: convert.bakes_from_numpy(np.zeros((6, 8, 8, 3), np.float32),
                                              np.zeros((8, 8, 2), np.float32))]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert tr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), port_cfg(TINY_NO_GI),
                          device="cpu").clip_from_world.device.type == "cpu"


def test_check_overflow_flags_dropped_pairs():
    cfg = port_cfg(TINY_NO_GI).replace(pair_capacity_factor=1, enable_taa=False,
                                       enable_bloom=False)
    scene = tbuild(*_plane_cube(tproc, TMaterial), texture_size=16, device="cpu")
    r = tr.Renderer(cfg, scene, device="cpu", raster_backend="pallas")
    r.render(tr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg, device="cpu"),
             sun_angle=SUNS[0])
    ok, msg = r.check_overflow()
    assert not ok and "overflow" in msg
    with pytest.raises(RuntimeError):
        r.check_overflow(strict=True)


# tests/test_frame.py's SMALL config and scene (its small_renderer: GI off)
FRAME_SMALL = JaxConfig(
    width=96, height=64, shadow_map_size=128, lightgrid_size=16, lightgrid_extent=8.0,
    prefiltered_env_size=16, prefiltered_env_min_size=8, prefilter_samples=512,
    brdf_lut_size=16, brdf_lut_samples=128, irradiance_size=8, irradiance_samples=64,
    bloom_pass_count=3, gi_screen_trace_steps=6, gi_diffuse_steps=4, gi_specular_steps=4,
    light_shaft_steps=4, enable_gi=False)
FRAME_SMALL_CAM = ((5.0, -6.0, 3.0), (0.0, 0.0, 1.0))


@functools.cache
def _frame_small_scene():
    mats = [JMaterial(base_color=jproc.checker_texture(32, 4, (1, 1, 1), (0.3, 0.3, 0.35)),
                      orm_factor=(1.0, 0.6, 0.0)),
            JMaterial(base_color_factor=(0.8, 0.2, 0.2, 1.0), orm_factor=(1.0, 0.3, 0.0))]
    parts = [jproc.make_plane((0, 0, 0), (12, 12), 2, 0, uv_scale=4),
             jproc.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    scene = jbuild(parts, mats, texture_size=32)
    return scene, convert.scene_from_numpy(_numpy_fields(scene), device="cpu")


def _raster_launches():
    from vulkan_pbr_renderer_tpu_torch.raster import visibility, visibility_v2

    return (visibility_v2.vis_folded_tiles.launches,
            visibility_v2.vis_folded_hiz_tiles.launches,
            visibility.vis_rowblock_tiles.launches)


def test_default_backend_matches_jax_default_on_small_scene():
    """The default raster_backend on test_frame.py's SMALL scene (14
    triangles: "auto" takes the brute-force raster in both packages) draws
    every pair: frames match at SSIM >= 0.995 and check_overflow is ok."""
    jscene, scene = _frame_small_scene()
    jrend = jr.Renderer(FRAME_SMALL, jscene, use_cache=False)
    r = tr.Renderer(port_cfg(FRAME_SMALL), scene, device="cpu")
    assert r.raster_backend == jrend.raster_backend == "xla"
    jcam = jr.make_camera(*FRAME_SMALL_CAM, FRAME_SMALL)
    cam = _port_camera(jcam)
    before = _raster_launches()
    for i, sun in enumerate([(40.0, 20.0), (40.0, 20.0), (45.0, 20.0)]):
        want = np.asarray(jrend.render(jcam, sun_angle=sun))
        got = r.render(cam, sun_angle=sun).numpy()
        assert got.shape == (64, 96, 3) and np.isfinite(got).all()
        s = image.ssim(got, want)
        assert s >= 0.995, f"frame {i}: SSIM {s}"
    assert _raster_launches() == before
    assert r.check_overflow() == jrend.check_overflow()
    assert r.check_overflow(strict=True)[0]
    np.testing.assert_array_equal(r.state.raster_overflow.numpy(), [0, 0])


def test_pallas_backend_reports_overflow_on_small_scene():
    """The same scene through binning at Renderer.render's default sun
    (50, 30), as test_frame_temporal_state_advances draws it: 44 pairs against a capacity of
    3 * 14 = 42, so "pallas" reports the dropped pairs in both packages."""
    jscene, scene = _frame_small_scene()
    jrend = jr.Renderer(FRAME_SMALL, jscene, use_cache=False, raster_backend="pallas")
    jrend.render(jr.make_camera(*FRAME_SMALL_CAM, FRAME_SMALL), sun_angle=(50.0, 30.0))
    r = tr.Renderer(port_cfg(FRAME_SMALL), scene, device="cpu", raster_backend="pallas")
    assert r.raster_backend == "pallas"
    r.render(tr.make_camera(*FRAME_SMALL_CAM, r.cfg, device="cpu"), sun_angle=(50.0, 30.0))
    jok, _ = jrend.check_overflow()
    ok, msg = r.check_overflow()
    assert not ok and not jok and "pair count 44 > pair_capacity 42" in msg
    np.testing.assert_array_equal(r.state.raster_overflow.numpy(),
                                  np.asarray(jrend.state.raster_overflow))


def test_check_overflow_warns_when_not_strict():
    """check_overflow(strict=False) on the overflowing SMALL scene warns with
    the message it returns, as the JAX Renderer does; strict raises it."""
    jscene, scene = _frame_small_scene()
    jrend = jr.Renderer(FRAME_SMALL, jscene, use_cache=False, raster_backend="pallas")
    jrend.render(jr.make_camera(*FRAME_SMALL_CAM, FRAME_SMALL), sun_angle=(50.0, 30.0))
    r = tr.Renderer(port_cfg(FRAME_SMALL), scene, device="cpu", raster_backend="pallas")
    r.render(tr.make_camera(*FRAME_SMALL_CAM, r.cfg, device="cpu"), sun_angle=(50.0, 30.0))
    with pytest.warns(UserWarning, match="raster bin overflow") as jrec:
        jok, jmsg = jrend.check_overflow()
    with pytest.warns(UserWarning, match="pair count 44 > pair_capacity 42") as rec:
        ok, msg = r.check_overflow()
    assert (ok, msg) == (jok, jmsg) and not ok
    assert str(rec[0].message) == msg == str(jrec[0].message)
    with pytest.raises(RuntimeError, match="pair count 44 > pair_capacity 42"):
        r.check_overflow(strict=True)


def test_check_overflow_ok_does_not_warn():
    import warnings

    _, scene = _frame_small_scene()
    r = tr.Renderer(port_cfg(FRAME_SMALL).replace(pair_capacity_factor=8), scene,
                    device="cpu", raster_backend="pallas")
    r.render(tr.make_camera(*FRAME_SMALL_CAM, r.cfg, device="cpu"), sun_angle=(50.0, 30.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ok, msg = r.check_overflow()
    assert ok and msg.startswith("ok (")


@pytest.mark.parametrize("num_tris,want", [(14, "xla"), (4096, "xla"), (4097, "pallas")])
def test_auto_backend_resolves_by_triangle_count(num_tris, want):
    assert tr.resolve_raster_backend("auto", num_tris) == want
    assert tr.resolve_raster_backend("xla", num_tris) == "xla"
    assert tr.resolve_raster_backend("pallas", num_tris) == "pallas"


def test_unknown_raster_backend_raises():
    _, scene = _frame_small_scene()
    with pytest.raises(ValueError, match="unknown raster_backend 'cuda'"):
        tr.Renderer(port_cfg(FRAME_SMALL), scene, device="cpu", raster_backend="cuda")
    r = tr.Renderer(port_cfg(FRAME_SMALL), scene, device="cpu")
    with pytest.raises(ValueError, match="unknown raster_backend"):
        tr.render_frame(r.scene, r.state, tr.make_camera(*FRAME_SMALL_CAM, r.cfg, device="cpu"),
                        (40.0, 20.0), r.prefiltered_env, r.brdf_lut, r.cfg, "vulkan")


def test_pcf_taps4_raises_not_carried_over():
    with pytest.raises(ValueError, match="pcf_mode='taps4'.*does not carry over, see ROADMAP"):
        RenderConfig(pcf_mode="taps4")
