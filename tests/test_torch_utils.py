"""The port's utils, device policy and config against the JAX package.

Tolerances: math on float32 inputs rtol/atol 1e-5 (matmul and inverse sum
in another order); noise exactly equal where both sides do the same f32 ops
(IGN, jitter) and atol 1e-6 otherwise; tonemap atol 1e-6.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.utils import color as jcolor
from vulkan_pbr_renderer_tpu.utils import math3d as jm3
from vulkan_pbr_renderer_tpu.utils import noise as jnoise
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu_torch import device as tdevice
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.utils import color as tcolor
from vulkan_pbr_renderer_tpu_torch.utils import math3d as tm3
from vulkan_pbr_renderer_tpu_torch.utils import noise as tnoise


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_import_leaves_jax_out():
    mods = ["app.renderer", "convert", "app.headless", "app.preview", "app.hotreload",
            "app.camera", "app.key_input", "assets.gltf", "assets.fbx", "assets.dds",
            "assets.hdr", "assets.tga", "assets.native_bcdec", "utils.image", "bake.ibl",
            "parallel.sharding", "shade.taa", "shade.bloom"]
    code = ("import sys, " + ", ".join(f"vulkan_pbr_renderer_tpu_torch.{m}" for m in mods)
            + "; assert 'jax' not in sys.modules, 'jax imported'"
            "; assert 'vulkan_pbr_renderer_tpu' not in sys.modules, 'JAX package imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_precision_flags_set():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_resolve_device_raises_without_cuda():
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")


def test_config_defaults_match_jax():
    port = RenderConfig()
    jax_cfg = JaxConfig()
    for f in port.__dataclass_fields__:
        assert getattr(port, f) == getattr(jax_cfg, f), f
    assert port.lightgrid_scale == jax_cfg.lightgrid_scale


@pytest.mark.parametrize("field,value", [
    ("tri_chunk", 64), ("folded_tile", 16), ("pcf_mode", "taps4"), ("tile_w", 64),
])
def test_config_rejects_unported(field, value):
    kw = {"tile_w": dict(raster_kernel="rowblock"),
          "tri_chunk": dict(raster_hiz=True)}.get(field, {})
    kw[field] = value
    # pcf_mode="taps4" is a TPU A/B option that is not carried over at all
    message = ("does not carry over, see ROADMAP" if field == "pcf_mode"
               else "not yet ported, see ROADMAP")
    with pytest.raises(ValueError, match=message):
        RenderConfig(**kw)


@pytest.mark.parametrize("field,value", [
    ("gi_mode", "reference"), ("raster_hiz", True), ("visualize_lightgrid", True),
    ("light_shaft_mode", "march"),
])
def test_config_accepts_ported(field, value):
    port = RenderConfig(**{field: value})
    assert getattr(port, field) == value == getattr(JaxConfig(**{field: value}), field)
    # the hiz bound is per 128-row block; the rowblock kernel ignores raster_hiz
    assert RenderConfig(raster_hiz=True, tri_chunk=64, raster_kernel="rowblock").raster_hiz


@pytest.mark.parametrize("field,value", [
    ("gi_trace_impl", "v1"), ("gi_fast_screen_mode", "probes"),
    ("gi_fast_screen_mode", "hiz"), ("gi_fast_march", False), ("gi_fast_fog_march", False),
])
def test_config_rejects_knobs_not_carried_over(field, value):
    with pytest.raises(ValueError, match="does not carry over"):
        RenderConfig(**{field: value})


def test_config_presets():
    from vulkan_pbr_renderer_tpu_torch import config

    assert config.SUNTEMPLE_1080P == RenderConfig(width=1920, height=1088)
    assert config.SUNTEMPLE_1080P.enable_gi and config.SUNTEMPLE_1080P.gi_mode == "fast"
    rb = config.SUNTEMPLE_1080P_ROWBLOCK
    assert rb.raster_kernel == "rowblock" and rb.tile_capacity % 1024 == 0
    assert rb.replace(raster_kernel="folded", tile_capacity=4096) == config.SUNTEMPLE_1080P
    assert not config.SUNTEMPLE_1080P_NO_GI.enable_gi
    # GI off makes the GI mode irrelevant: a reference-mode config is accepted
    assert RenderConfig(enable_gi=False, gi_mode="reference").gi_mode == "reference"
    # the bench's reference leg, the reference product mode, the hiz frame
    assert config.SUNTEMPLE_1080P_REFERENCE == config.SUNTEMPLE_1080P.replace(gi_mode="reference")
    assert config.SUNTEMPLE_1080P_HIZ == config.SUNTEMPLE_1080P.replace(raster_hiz=True)
    from vulkan_pbr_renderer_tpu.config import REFERENCE_PRODUCT as JAX_PRODUCT

    product = config.REFERENCE_PRODUCT
    assert (product.width, product.height) == (1920, 1080)
    for f in product.__dataclass_fields__:
        assert getattr(product, f) == getattr(JAX_PRODUCT, f), f


def test_camera_matrices_match_jax():
    eye, tgt = (3.0, -4.0, 2.5), (0.5, 1.0, 1.2)
    _close(tm3.look_at(eye, tgt), jm3.look_at(jnp.asarray(eye), jnp.asarray(tgt)))
    _close(tm3.perspective_lh_zo(1.2, 1.6, 0.02, 1e4), jm3.perspective_lh_zo(1.2, 1.6, 0.02, 1e4))
    _close(tm3.orthographic_rh_zo(-40, 40, -40, 40, -40, 40),
           jm3.orthographic_rh_zo(-40, 40, -40, 40, -40, 40))
    axis = np.array([0.3, -0.5, 0.8], np.float32)
    _close(tm3.rotate_rh(torch.tensor(0.7), torch.from_numpy(axis)),
           jm3.rotate_rh(jnp.float32(0.7), jnp.asarray(axis)))


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(4, 4)).astype(np.float32) + 4 * np.eye(4, dtype=np.float32)
    pts = rng.uniform(-5, 5, (7, 9, 3)).astype(np.float32)
    tm, tp = torch.from_numpy(m), torch.from_numpy(pts)
    _close(tm3.inverse(tm), jm3.inverse(jnp.asarray(m)))
    _close(tm3.transform_points(tm, tp), jm3.transform_points(jnp.asarray(m), jnp.asarray(pts)))
    _close(tm3.transform_dirs(tm, tp), jm3.transform_dirs(jnp.asarray(m), jnp.asarray(pts)))
    ndc, w = tm3.project_points(tm, tp)
    jndc, jw = jm3.project_points(jnp.asarray(m), jnp.asarray(pts))
    _close(ndc, jndc, 1e-4)
    _close(w, jw)


def test_vector_helpers_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    th = rng.uniform(0, 6, (50, 1)).astype(np.float32)
    ta, tb, tt = map(torch.from_numpy, (a, b, th))
    ja, jb, jt = map(jnp.asarray, (a, b, th))
    _close(tm3.normalize(ta), jm3.normalize(ja))
    _close(tm3.cross(ta, tb), jm3.cross(ja, jb))
    _close(tm3.reflect(ta, tm3.normalize(tb)), jm3.reflect(ja, jm3.normalize(jb)))
    _close(tm3.rotate_about_axis(ta, tm3.normalize(tb), tt),
           jm3.rotate_about_axis(ja, jm3.normalize(jb), jt))


def test_noise_matches_jax():
    rng = np.random.default_rng(2)
    px = (rng.integers(0, 1920, 500) + 0.5).astype(np.float32)
    py = (rng.integers(0, 1088, 500) + 0.5).astype(np.float32)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    np.testing.assert_array_equal(
        tnoise.interleaved_gradient_noise(tpx, tpy).numpy(),
        np.asarray(jnoise.interleaved_gradient_noise(jnp.asarray(px), jnp.asarray(py))))
    for f59 in (0.0, 7.0, 58.0):
        got = tnoise.frame_noise(tpx, tpy, f59, offset=(90.0, 20.0)).numpy()
        want = np.asarray(jnoise.frame_noise(jnp.asarray(px), jnp.asarray(py),
                                             jnp.float32(f59), offset=(90.0, 20.0)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for idx in (0, 1, 5, 1000):
        np.testing.assert_array_equal(
            tnoise.taa_jitter(idx, 1920, 1088),
            np.asarray(jnoise.taa_jitter(jnp.float32(idx), 1920, 1088)))


def test_color_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.uniform(0, 8, (64, 3)).astype(np.float32)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    _close(tcolor.aces_approx(tv), jcolor.aces_approx(jv), 1e-6)
    _close(tcolor.gamma_encode(tv), jcolor.gamma_encode(jv), 1e-6)
