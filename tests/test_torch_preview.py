"""The port's interactive preview: session loop + HTTP protocol (the stand-in
for the reference's live window loop, main.cpp:53-101) — the cases of
tests/test_preview.py on the port, on the CPU."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu_torch.app import preview
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

CFG = RenderConfig(width=32, height=16)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _is_image(data):
    """JPEG (SOI marker) when PIL is present, PNG otherwise (image.encode_jpeg)."""
    return data[:2] == b"\xff\xd8" or data[:8] == PNG_MAGIC


def _render_step(calls, as_tensor=False):
    def step(cam, sun_angle, visualize):
        assert cam.position.device.type == "cpu"
        y = float(cam.position[1])
        calls.append((cam.position.numpy(), tuple(sun_angle), visualize))
        img = np.zeros((CFG.height, CFG.width, 3), np.float32)
        img[..., 0] = y  # encode camera y
        return torch.from_numpy(img) if as_tensor else img

    return step


@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "tensor"])
def test_session_tick_applies_input(as_tensor):
    calls = []
    s = preview.PreviewSession(_render_step(calls, as_tensor), CFG, start_pos=(0, -6, 2.5),
                               device="cpu")
    assert _is_image(s.frame_png) and s.frame_count == 0
    s.tick()  # no input
    p0 = np.asarray(s.camera.pos).copy()
    # movement requires focus = MouseRight-or-Ctrl held (camera.h:51-67)
    s.push_events([["press", "KeyW"]])
    s.tick()
    assert abs(s.camera.pos[1] - p0[1]) < 1e-6  # no focus -> no movement
    s.push_events([["press", "MouseRight"]])
    for _ in range(5):
        time.sleep(0.005)      # the step is as long as the tick took
        s.tick()
    assert s.camera.pos[1] > p0[1] + 0.05  # moved forward (+Y view dir)
    s.push_events([["release", "MouseRight"]])
    # W held across ticks (reset keeps down-state)
    assert s.inputs.is_down(ord("W"))
    s.push_events([["release", "KeyW"], ["press", "Digit0"]])
    s.tick()
    assert s.sun_angle[0] > 35.0
    s.push_events([["press", "KeyG"]])
    s.tick()
    assert calls[-1][2] is True  # visualize_lightgrid passed to render step
    s.push_events([["press", "Escape"]])
    s.tick()
    assert s.quit
    assert s.frame_ms > 0 and "frame 10" in s.stats()


def test_mouse_look_requires_right_button():
    calls = []
    s = preview.PreviewSession(_render_step(calls), CFG, device="cpu")
    yaw0 = s.camera.yaw
    s.push_events([["mouse", 50, 0]])
    s.tick()
    assert s.camera.yaw == yaw0
    s.push_events([["press", "MouseRight"], ["mouse", 50, 0]])
    s.tick()
    assert s.camera.yaw != yaw0


def test_session_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        preview.PreviewSession(_render_step([]), CFG)


def test_key_codes():
    from vulkan_pbr_renderer_tpu.app import preview as jpreview

    for code in ("KeyW", "Digit7", "Escape", "MouseRight", "ShiftLeft", "ArrowUp", "F13", "Key"):
        assert preview._key_from_code(code) == jpreview._key_from_code(code)
    assert preview._PAGE == jpreview._PAGE and preview._CODE_MAP == jpreview._CODE_MAP


def _small_renderer():
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer
    from vulkan_pbr_renderer_tpu_torch.assets import MaterialDesc, build_scene, procedural

    cfg = RenderConfig(
        width=64, height=32, shadow_map_size=32, lightgrid_size=8,
        lightgrid_extent=8.0, prefiltered_env_size=16,
        prefiltered_env_min_size=8, prefilter_samples=16, brdf_lut_size=16,
        brdf_lut_samples=16, bloom_pass_count=2, gi_screen_trace_steps=2,
        gi_diffuse_steps=2, gi_specular_steps=2, light_shaft_steps=2,
    )
    scene = build_scene(
        [procedural.make_plane((0, 0, 0), (10, 10), 2, 0),
         procedural.make_cube((0, 0, 1.0), (1, 1, 2), 0)],
        [MaterialDesc()], texture_size=16, device="cpu")
    return cfg, Renderer(cfg, scene, device="cpu", raster_backend="xla")


def test_session_with_real_renderer():
    """End-to-end: the preview session drives the actual Renderer on a tiny
    scene through preview.main's render step — input moves the camera, the
    lightgrid debug toggle (G) switches the render path and keeps the
    temporal state going, and frames encode."""
    cfg, r = _small_renderer()
    frames = []

    def step(cam, sun_angle, visualize):
        img = preview.renderer_step(r)(cam, sun_angle, visualize)
        frames.append(img)
        return img

    s = preview.PreviewSession(step, cfg, start_pos=(0, -5, 2), device="cpu")
    s.push_events([["press", "KeyW"], ["press", "MouseRight"]])
    s.tick()
    assert _is_image(bytes(s.frame_png[:8]))
    assert s.frame_count == 1 and r.state.frame_idx == 1
    s.push_events([["press", "KeyG"]])
    s.tick()   # lightgrid debug view renders through the DDA path
    assert s.visualize_lightgrid and s.frame_count == 2
    assert r.state.frame_idx == 2      # render_frame advanced r.state in place
    assert s.camera.pos[1] > -5.0
    assert all(isinstance(f, torch.Tensor) and f.shape == (32, 64, 3)
               and bool(torch.isfinite(f).all()) for f in frames)
    assert not torch.equal(frames[0], frames[1])
    assert not r.cfg.visualize_lightgrid     # the toggle is per frame, not on the renderer
    s.push_events([["press", "KeyG"]])
    s.tick()
    assert not s.visualize_lightgrid and r.state.frame_idx == 3


def test_http_server_roundtrip():
    calls = []
    s = preview.PreviewSession(_render_step(calls), CFG, device="cpu")
    server = preview.serve(s, port=0, run_loop=False)
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(f"{base}/").read()
        assert b"frame.png" in page
        body = json.dumps([["press", "KeyW"]]).encode()
        req = urllib.request.Request(f"{base}/input", data=body, method="POST")
        assert urllib.request.urlopen(req).status == 200
        s.tick()
        resp = urllib.request.urlopen(f"{base}/frame.png")
        png = resp.read()
        assert _is_image(png) and resp.headers["Content-Type"] == s.frame_mime
        stats = urllib.request.urlopen(f"{base}/stats").read().decode()
        assert "frame 1" in stats and "sun" in stats
        assert s.inputs.is_down(ord("W"))
        for path, data in (("/nothing", None), ("/nothing", b"[]"), ("/input", b"{not json")):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(f"{base}{path}", data=data))
            assert err.value.code == (400 if path == "/input" else 404)
    finally:
        server.shutdown()
        server.server_close()


def test_serve_loop_ends_on_escape():
    """serve(run_loop=True) blocks in the render loop until Esc and shuts the
    server down."""
    s = preview.PreviewSession(_render_step([]), CFG, device="cpu")
    s.push_events([["press", "Escape"]])
    done = []
    t = threading.Thread(target=lambda: done.append(preview.serve(s, port=0)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and s.quit and s.frame_count == 1
    done[0].server_close()
