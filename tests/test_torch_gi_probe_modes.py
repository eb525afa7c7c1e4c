"""The fast GI's economy mode and its probe and hi-z screen terms through the
port's frame against the JAX package's, and the wrappers of their kernels
(gi.screen_ray_resolve, gi.probe_ray_resolve) on the CPU.

Frames: tests/test_torch_gi_frame.py's SMALL scene and config (96x64,
lightgrid 16) through the brute-force raster of both packages, three
frames with the sun moving on the third, in the economy mode with the
probe (path E's mode) and the fast GI with the hi-z term (path F's); each
frame SSIM >= 0.995 against the JAX frame, and each ray one call of its
wrapper a frame.  Wrappers: on a CPU tensor the plain version bit for bit
with no launch counted, on every seeded set of
tests/test_torch_gi_screen_inputs.py; their ValueErrors.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_gi_frame import CAM, SMALL, SUNS, _scene_parts, port_cfg
from test_torch_gi_screen_inputs import _one_thread  # noqa: F401 (the module's fixture)
from test_torch_gi_screen_inputs import SETS, set_call_args, wrapper_call
from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.shade import gi, gi_modes
from vulkan_pbr_renderer_tpu_torch.utils import image

# path E's and path F's modes
MODES = {"economy_probes": dict(gi_fast_march=False, gi_fast_screen_mode="probes"),
         "hiz": dict(gi_fast_screen_mode="hiz")}


@functools.cache
def _jax_frames(mode):
    cfg = SMALL.replace(**MODES[mode])
    scene = _scene_parts()
    r = jr.Renderer(cfg, scene, use_cache=False, raster_backend="xla")
    cam = jr.make_camera(*CAM, cfg)
    imgs = [np.asarray(r.render(cam, sun_angle=sun)) for sun in SUNS]
    return scene, r, cam, imgs


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_frames_match_jax(mode, monkeypatch):
    scene, jrend, jcam, jimgs = _jax_frames(mode)
    r = tr.Renderer(port_cfg(jrend.cfg),
                    convert.scene_from_numpy({k: np.asarray(v)
                                              for k, v in scene._asdict().items()},
                                             device="cpu"),
                    device="cpu", raster_backend="xla")
    r.prefiltered_env, r.brdf_lut = convert.bakes_from_numpy(
        np.asarray(jrend.prefiltered_env_raw), np.asarray(jrend.brdf_lut), device="cpu")
    cam = tr.CameraState(*(torch.from_numpy(np.array(x)) for x in jcam))
    wrapper = "probe_ray_resolve" if mode == "economy_probes" else "screen_ray_resolve"
    launches = (gi.screen_ray_resolve.launches, gi.probe_ray_resolve.launches)
    calls = []
    fn = getattr(gi, wrapper)
    monkeypatch.setattr(gi, wrapper, lambda *a: calls.append(a[-1]) or fn(*a))
    for i, sun in enumerate(SUNS):
        img = r.render(cam, sun_angle=sun).numpy()
        assert img.shape == (64, 96, 3) and np.isfinite(img).all()
        s = image.ssim(img, jimgs[i])
        assert s >= 0.995, f"{mode} frame {i}: SSIM {s}"
    assert len(calls) == 2 * len(SUNS)
    assert {rp.term for rp in calls} == {"probe" if mode == "economy_probes" else "hiz"}
    monkeypatch.undo()
    assert (gi.screen_ray_resolve.launches, gi.probe_ray_resolve.launches) == launches
    # the economy mode has no interleave
    assert gi_modes.gi_temporal_active(r.cfg) == (mode == "hiz")


@pytest.mark.parametrize("name", [s[0] for s in SETS])
def test_wrappers_take_the_plain_version_on_cpu(name):
    args = set_call_args(name, "cpu", n=256)
    launches = (gi.screen_ray_resolve.launches, gi.probe_ray_resolve.launches)
    rgb, status = wrapper_call(args)
    want_rgb, want_status = gi.screen_ray_resolve_plain(*args)
    np.testing.assert_array_equal(rgb.numpy().view(np.uint32), want_rgb.numpy().view(np.uint32))
    np.testing.assert_array_equal(status.numpy(), want_status.numpy())
    assert (gi.screen_ray_resolve.launches, gi.probe_ray_resolve.launches) == launches


def test_wrappers_reject_what_they_cannot_run():
    args = list(set_call_args("probes", "cpu", n=64))
    rp = args[-1]
    with pytest.raises(ValueError, match="wave-9 march has no kernel"):
        gi.screen_ray_resolve(*args[:-1], rp._replace(kind="march"))
    with pytest.raises(ValueError, match="economy mode"):
        gi.probe_ray_resolve(*args[:1], *args[2:5], *args[8:10], rp)
    with pytest.raises(ValueError, match="dist_mip > 0 needs the k-point probe"):
        hiz = list(set_call_args("hiz", "cpu", n=64))
        gi.screen_ray_resolve(*hiz[:-1], hiz[-1]._replace(dist_mip=0.5))
    with pytest.raises(ValueError, match="gi_hiz_levels"):
        gi.screen_ray_resolve(*hiz[:-1], hiz[-1]._replace(hiz_levels=5))
    with pytest.raises(ValueError, match="gi_fast_probe_level"):
        gi.screen_ray_resolve(*args[:-1], rp._replace(probe_level=rp.prev_levels))
    with pytest.raises(ValueError, match="table must be a"):
        gi.screen_ray_resolve(args[0].to(torch.float32), *args[1:])
    with pytest.raises(ValueError, match="noise"):
        gi.screen_ray_resolve(*args[:10], args[10][:5], *args[11:])
    with pytest.raises(ValueError, match="hi-z atlas must be"):
        gi.screen_ray_resolve(*hiz[:2], hiz[2][:, :-1].contiguous(), *hiz[3:])
