"""The port's app surface against the JAX package's: the FPS camera, the
shader watcher, device init, the headless CLI's scenes and cameras, and the
CLI itself.

Tolerances: the camera's quaternion and matrix products are the same f32
operations in the same order, 1e-5 (absolute and relative: positions reach
tens of units, where one f32 ulp is 2e-6) over 20 accumulated updates and
1e-6 for `camera_for`.  The two inverses of a projection (world_from_clip,
view_from_clip) are the exception: z_far / z_near = 5e5 is their condition
number, and the two LU inverses sum in another order, so they are held to
1e-4 of the matrix's largest entry and to inverting their matrix.  The
scenes' arrays are exactly equal; the CLI's PNG frames SSIM >= 0.995 (the
repo's backend-against-backend bar, tests/test_goldens.py).
"""

import functools
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import headless as jheadless
from vulkan_pbr_renderer_tpu.app.camera import FpsCamera as JaxFpsCamera
from vulkan_pbr_renderer_tpu.bake import cache as jcache
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch import device as tdevice
from vulkan_pbr_renderer_tpu_torch.app import headless
from vulkan_pbr_renderer_tpu_torch.app.camera import FpsCamera
from vulkan_pbr_renderer_tpu_torch.app.hotreload import ShaderWatcher
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.utils import image

NO_CARD = not torch.cuda.is_available()


def _cameras_close(got, want, atol, where=""):
    """Every matrix of a port CameraState against the JAX one's."""
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        tol = 1e-4 * np.abs(w).max() if name in ("world_from_clip", "view_from_clip") else atol
        np.testing.assert_allclose(g.numpy(), w, rtol=atol, atol=tol, err_msg=f"{name} {where}")
    for inv, mat in ((got.world_from_clip, got.clip_from_world),
                     (got.view_from_clip, got.clip_from_view)):
        np.testing.assert_allclose((mat.double() @ inv.double()).numpy(), np.eye(4), atol=1e-3)


# ---------------------------------------------------------------------------
# FpsCamera


def test_fps_camera_matches_jax_over_script():
    rng = np.random.default_rng(0)
    start = np.array([1.0, -6.0, 2.5], np.float32)
    cam, jcam = FpsCamera(pos=start.copy()), JaxFpsCamera(pos=start.copy())
    cfg, jcfg = RenderConfig(width=96, height=64), JaxConfig(width=96, height=64)
    for i in range(20):
        kw = dict(
            move=tuple(float(v) for v in rng.integers(-1, 2, 3)),
            mouse=tuple(float(v) for v in rng.uniform(-80, 80, 2)) if i % 3 else (0.0, 0.0),
            speed=5.0, mouse_speed=0.001, shift=bool(i % 4 == 1), ctrl=bool(i % 5 == 2))
        dt = float(rng.uniform(0.005, 0.1))
        cam.update(dt, **kw)
        jcam.update(dt, **kw)
        assert cam.pos.dtype == cam.lazy_pos.dtype == cam.lazy_ori.dtype == np.float32
        np.testing.assert_allclose(cam.pos, jcam.pos, rtol=0, atol=1e-5)
        np.testing.assert_allclose(cam.lazy_pos, jcam.lazy_pos, rtol=0, atol=1e-5)
        np.testing.assert_allclose(cam.lazy_ori, jcam.lazy_ori, rtol=0, atol=1e-5)
        assert abs(cam.yaw - jcam.yaw) < 1e-12 and abs(cam.pitch - jcam.pitch) < 1e-12
        _cameras_close(cam.matrices(cfg, device="cpu"), jcam.matrices(jcfg), 1e-5,
                       f"at step {i}")


def test_fps_camera_matrices_before_update_match_jax():
    cam = FpsCamera(pos=np.array([0.0, 1.0, 2.0], np.float32), pitch=0.2, yaw=-0.4)
    jcam = JaxFpsCamera(pos=np.array([0.0, 1.0, 2.0], np.float32), pitch=0.2, yaw=-0.4)
    _cameras_close(cam.matrices(RenderConfig(width=64, height=64), device="cpu"),
                   jcam.matrices(JaxConfig(width=64, height=64)), 1e-5)


def test_fps_camera_matrices_raise_without_cuda():
    if not NO_CARD:
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        FpsCamera().matrices(RenderConfig(width=64, height=64))


def test_fps_camera_default_faces_plus_y():
    """camera.h:45: zero pitch/yaw looks along +Y with Z up."""
    cam = FpsCamera(pos=np.array([0.0, 0.0, 2.0], np.float32))
    cam.update(0.016)
    st = cam.matrices(RenderConfig(width=64, height=64), device="cpu")
    # a point ahead on +Y projects to the screen centre
    clip = st.clip_from_world @ torch.tensor([0.0, 10.0, 2.0, 1.0])
    ndc = (clip[:3] / clip[3]).numpy()
    np.testing.assert_allclose(ndc[:2], 0.0, atol=1e-5)
    assert 0.0 < ndc[2] < 1.0


def test_fps_camera_movement_conventions():
    """W moves along view forward; Shift x3 (camera.h:67-92)."""
    cam = FpsCamera(pos=np.zeros(3, np.float32))
    cam.update(1.0, move=(1.0, 0.0, 0.0), speed=1.0)
    assert cam.pos[1] > 0.5 and abs(cam.pos[0]) < 1e-5  # moved toward +Y
    y1 = cam.pos[1]
    cam2 = FpsCamera(pos=np.zeros(3, np.float32))
    cam2.update(1.0, move=(1.0, 0.0, 0.0), speed=1.0, shift=True)
    assert cam2.pos[1] > y1 * 2.5  # Shift speeds up 3x


def test_fps_camera_lazy_smoothing():
    """camera.h:95-96: lazy pos lerps at 0.2 toward the target."""
    cam = FpsCamera(pos=np.zeros(3, np.float32))
    cam.update(0.016)  # initializes lazy state
    cam.pos = np.array([1.0, 0.0, 0.0], np.float32)
    cam.update(0.016)
    assert abs(cam.lazy_pos[0] - 0.2) < 1e-5


def test_fps_camera_mouse_look():
    cam = FpsCamera(pos=np.zeros(3, np.float32))
    cam.update(0.016, mouse=(100.0, 0.0), mouse_speed=0.002)
    assert abs(cam.yaw + 0.2) < 1e-6  # yaw -= mouse_speed * dx


# ---------------------------------------------------------------------------
# ShaderWatcher


def _touch_later(path, text):
    path.write_text(text)
    os.utime(path, (time.time() + 2, time.time() + 2))


@pytest.fixture
def on_path(tmp_path):
    sys.path.insert(0, str(tmp_path))
    before = set(sys.modules)
    yield tmp_path
    sys.path.remove(str(tmp_path))
    for name in set(sys.modules) - before:
        sys.modules.pop(name, None)


def test_shader_watcher_detects_change(on_path):
    mod_path = on_path / "fake_torch_shade_mod.py"
    mod_path.write_text("VALUE = 1\n")
    import fake_torch_shade_mod  # noqa: F401

    watcher = ShaderWatcher(prefix="fake_torch_shade_mod")
    assert watcher.poll() is False  # no change yet
    _touch_later(mod_path, "VALUE = 2\n")
    assert watcher.poll() is True
    assert sys.modules["fake_torch_shade_mod"].VALUE == 2
    assert watcher.poll() is False


def test_shader_watcher_default_prefix_is_the_ports_shade():
    from vulkan_pbr_renderer_tpu_torch.app import hotreload, renderer  # noqa: F401

    assert hotreload.WATCHED_PREFIX == "vulkan_pbr_renderer_tpu_torch.shade"
    names = {m.__name__ for m in ShaderWatcher()._modules()}
    assert {"vulkan_pbr_renderer_tpu_torch.shade.lighting",
            "vulkan_pbr_renderer_tpu_torch.shade.bloom"} <= names
    assert all(n.startswith(hotreload.WATCHED_PREFIX) for n in names)


def _two_module_package(root, name):
    """`name`.blur defines resize(); `name`.light reaches it through the
    module object, as shade/lighting.py reaches shade/bloom.py's
    resize_linear."""
    pkg = root / name
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "blur.py").write_text("def resize():\n    return 'old'\n")
    (pkg / "light.py").write_text(
        "from . import blur\nLOADS = []\nLOADS.append(1)\n"
        "def shade():\n    return blur.resize()\n")
    return pkg


def test_shader_watcher_reload_reaches_callers_through_the_module(on_path):
    """Only the changed module is reloaded, and a caller that reaches it
    through the module object sees the new function."""
    import importlib

    pkg = _two_module_package(on_path, "fake_torch_shade_pkg")
    light = importlib.import_module("fake_torch_shade_pkg.light")
    watcher = ShaderWatcher(prefix="fake_torch_shade_pkg")
    assert light.shade() == "old"
    _touch_later(pkg / "blur.py", "def resize():\n    return 'new'\n")
    assert watcher.poll() is True
    assert light.shade() == "new"
    assert light.LOADS == [1]              # light itself was left alone


def test_shader_watcher_keeps_old_code_on_error(on_path, capsys):
    import importlib

    pkg = _two_module_package(on_path, "fake_torch_shade_err")
    light = importlib.import_module("fake_torch_shade_err.light")
    watcher = ShaderWatcher(prefix="fake_torch_shade_err")
    _touch_later(pkg / "blur.py", "def resize(:\n")
    assert watcher.poll() is False
    assert "SyntaxError" in capsys.readouterr().err
    assert light.shade() == "old"
    assert watcher.poll() is False         # reported once, not every frame
    os.utime(pkg / "blur.py", (time.time() + 4, time.time() + 4))
    (pkg / "blur.py").write_text("def resize():\n    return 'fixed'\n")
    os.utime(pkg / "blur.py", (time.time() + 4, time.time() + 4))
    assert watcher.poll() is True
    assert light.shade() == "fixed"


def test_port_shade_modules_survive_a_reload():
    """Reloading the real shade/bloom.py reaches shade/lighting.py and the
    renderer (temporal state untouched): no watched module holds a function
    or class of another watched module by name, where it would go stale."""
    import importlib

    from vulkan_pbr_renderer_tpu_torch.app import hotreload
    from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
    from vulkan_pbr_renderer_tpu_torch.shade import bloom, lighting

    for m in ShaderWatcher()._modules() + [tr]:
        held = {k for k, v in vars(m).items()
                if getattr(v, "__module__", m.__name__) != m.__name__
                and str(getattr(v, "__module__", "")).startswith(hotreload.WATCHED_PREFIX)}
        assert not held, (m.__name__, held)
    old = bloom.resize_linear
    importlib.reload(bloom)
    assert lighting.bloom is tr.bloom_mod is bloom
    assert lighting.bloom.resize_linear is not old
    assert tr.lighting is lighting


# ---------------------------------------------------------------------------
# init_devices


def test_init_devices_retries(monkeypatch):
    """Transient init failures retry; the device comes back once it is up."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient init failure")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "init", flaky)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: object())
    assert tdevice.init_devices(retries=3, delay_s=0.0) == torch.device("cuda")
    assert calls["n"] == 3
    calls["n"] = -99  # always fails from here (< 3 forever)
    with pytest.raises(RuntimeError, match="after 2 attempts: transient init failure"):
        tdevice.init_devices(retries=2, delay_s=0.0)


def test_init_devices_raises_without_a_card():
    assert tdevice.init_devices(device="cpu") == torch.device("cpu")
    if not NO_CARD:
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device init failed after 2 attempts.*cuda"):
        tdevice.init_devices(retries=2, delay_s=0.0)


# ---------------------------------------------------------------------------
# the CLI's scenes and cameras


@pytest.mark.parametrize("name,detail,texture_size", [
    ("triangle", 1.0, 64), ("cube", 1.0, 64), ("spheres", 1.0, 32), ("suntemple", 0.25, 32)])
def test_build_scene_by_name_matches_jax(name, detail, texture_size):
    jscene = jheadless.build_scene_by_name(name, detail, texture_size)
    want = convert.scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()},
                                    device="cpu")
    got = headless.build_scene_by_name(name, detail, texture_size, device="cpu")
    assert got.num_tris == jscene.num_tris
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape and g.device.type == "cpu", f
        assert torch.equal(g, w), f
    if name == "spheres":       # 12 spheres of 24x48 quads + the ground
        assert got.num_tris == 12 * 2 * 24 * 48 + 2


def test_build_scene_by_name_errors():
    with pytest.raises(ValueError, match="unknown scene 'teapot'"):
        headless.build_scene_by_name("teapot", device="cpu")
    if not os.path.exists(os.path.join(headless.RESOURCE_DIR, "Cerberus.glb")):
        with pytest.raises(FileNotFoundError):
            headless.build_scene_by_name("cerberus", device="cpu")
        with pytest.raises(FileNotFoundError):
            jheadless.build_scene_by_name("cerberus")
    if NO_CARD:
        with pytest.raises(RuntimeError, match="cuda"):
            headless.build_scene_by_name("triangle")


@pytest.mark.parametrize("name", ["triangle", "cube", "spheres", "cerberus", "suntemple"])
@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_camera_for_matches_jax(name, t):
    got = headless.camera_for(name, t, RenderConfig(width=96, height=64), device="cpu")
    want = jheadless.camera_for(name, t, JaxConfig(width=96, height=64))
    _cameras_close(got, want, 1e-6)


def test_suntemple_camera_path_takes_cfg():
    from vulkan_pbr_renderer_tpu.assets import suntemple as jtemple
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple as ttemple

    for t in (0.0, 0.3, 0.7):
        for got, want in zip(ttemple.camera_path(t, RenderConfig()),
                             jtemple.camera_path(t, JaxConfig())):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ttemple.camera_path(t, cfg=None)[0],
                                      ttemple.camera_path(t)[0])


# ---------------------------------------------------------------------------
# the CLI end to end.  The CLI has no flags for the bake sizes, so both
# packages' RenderConfig defaults are cut to tests/test_preview.py's small
# tables here (the bakes at full size take minutes on the CPU); everything
# else is the CLI's own.

SMALL_BAKES = dict(
    shadow_map_size=32, lightgrid_size=8, prefiltered_env_size=16,
    prefiltered_env_min_size=8, prefilter_samples=16, brdf_lut_size=16,
    brdf_lut_samples=16, bloom_pass_count=2, gi_screen_trace_steps=2,
    gi_diffuse_steps=2, gi_specular_steps=2, light_shaft_steps=2)


@pytest.fixture
def small_bakes(monkeypatch, tmp_path):
    monkeypatch.setattr(headless, "RenderConfig", functools.partial(RenderConfig, **SMALL_BAKES))
    monkeypatch.setattr(jheadless, "RenderConfig", functools.partial(JaxConfig, **SMALL_BAKES))
    monkeypatch.setattr(jcache, "DEFAULT_CACHE_DIR", str(tmp_path / "bake_cache"))


CLI = ["--scene", "cube", "--frames", "3", "--width", "64", "--height", "32",
       "--texture-size", "32"]


def test_headless_main_matches_jax_cli(small_bakes, tmp_path, capsys):
    out, jout = tmp_path / "port", tmp_path / "jax"
    headless.main(CLI + ["--device", "cpu", "--bench", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "scene cube: 14 tris"
    assert [ln.split(":")[0] for ln in lines[1:4]] == ["frame 0", "frame 1", "frame 2"]
    assert all(ln.endswith(" ms") and float(ln.split()[2]) > 0 for ln in lines[1:4])
    bench = json.loads(lines[-1])
    assert bench["metric"] == "cube_64x32_frame_ms_p50" and bench["unit"] == "ms"
    assert bench["value"] > 0
    assert bench["vs_baseline"] == pytest.approx(16.6 / bench["value"], rel=2e-2)

    jheadless.main(CLI + ["--bench", "--out", str(jout)])
    jlines = capsys.readouterr().out.strip().splitlines()
    assert jlines[0] == lines[0]
    assert json.loads(jlines[-1])["metric"] == bench["metric"]
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jout)) == [f"frame_{i:04d}.png" for i in range(3)]
    for name in names:
        got, want = image.read_png(out / name), image.read_png(jout / name)
        assert got.shape == want.shape == (32, 64, 3) and got.std() > 5
        s = image.ssim(got.astype(np.float32) / 255, want.astype(np.float32) / 255)
        assert s >= 0.995, f"{name}: SSIM {s}"


@pytest.mark.parametrize("flags", [["--no-gi"], ["--visualize-lightgrid"],
                                   ["--raster", "pallas", "--sun", "50", "30"]],
                         ids=["no-gi", "lightgrid", "pallas"])
def test_headless_flags(small_bakes, tmp_path, capsys, flags):
    """The other flags reach the renderer: the frame is the one Renderer.render
    gives for the same config, camera and sun (the CLI adds nothing)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer

    args = ["--scene", "cube", "--frames", "1", "--width", "64", "--height", "32",
            "--texture-size", "32", "--device", "cpu", "--out", str(tmp_path)] + flags
    headless.main(args)
    printed = capsys.readouterr().out
    cfg = headless.RenderConfig(width=64, height=32)
    if "--no-gi" in flags:
        cfg = cfg.replace(enable_gi=False)
    if "--visualize-lightgrid" in flags:
        cfg = cfg.replace(visualize_lightgrid=True)
    backend = "pallas" if "pallas" in flags else "auto"
    sun = (50.0, 30.0) if "--sun" in flags else (35.0, 80.0)
    r = Renderer(cfg, headless.build_scene_by_name("cube", 1.0, 32, device="cpu"),
                 device="cpu", raster_backend=backend)
    want = r.render(headless.camera_for("cube", 0.0, cfg, device="cpu"), sun_angle=sun).numpy()
    got = image.read_png(tmp_path / "frame_0000.png").astype(np.float32) / 255
    np.testing.assert_allclose(got, np.clip(want, 0, 1), rtol=0, atol=1 / 255)
    assert printed.startswith("scene cube: 14 tris\nframe 0: ")


def test_headless_cuda_without_a_card_renders_nothing(monkeypatch, tmp_path, capsys):
    if not NO_CARD:
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(time, "sleep", lambda s: None)
    out = tmp_path / "frames"
    with pytest.raises(RuntimeError, match="device init failed"):
        headless.main(["--scene", "cube", "--frames", "2", "--width", "64", "--height", "32",
                       "--out", str(out)])
    assert not out.exists()
    assert "frame" not in capsys.readouterr().out


def test_headless_rejects_unknown_device_and_raster():
    for bad in (["--device", "tpu"], ["--raster", "cuda"]):
        with pytest.raises(SystemExit):
            headless.main(["--scene", "cube"] + bad)
