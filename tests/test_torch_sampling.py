"""The port's samplers against vulkan_pbr_renderer_tpu/gpu/sampling.py.

Tolerances: quantized tables (u8 materials, u16 depth, f16 windows) exactly
equal to the JAX tables' values (the env atlas compared as decoded f16, not
as the JAX package's int32 bitcast view); box-filtered f32 mips atol 1e-6;
filtered samples atol 1e-5 on f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as ts


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol)


def _uv(rng, n, lo=-0.2, hi=1.2):
    return rng.uniform(lo, hi, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("wy,wx,mode", [(2, 2, "edge"), (4, 4, "edge"), (2, 2, "wrap")])
def test_window_pack_matches_jax(wy, wx, mode):
    tex = _rng(0).uniform(0, 4, (9, 13, 3)).astype(np.float32)
    for dtype, jdt in ((None, None), (torch.float16, jnp.float16)):
        got = ts.window_pack(torch.from_numpy(tex), wy, wx, mode, dtype)
        want = js.window_pack(jnp.asarray(tex), wy, wx, mode, jdt)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("mode", ["clamp", "wrap"])
def test_bilinear_samplers_match_jax(mode):
    rng = _rng(1)
    tex = rng.uniform(0, 2, (11, 17, 2)).astype(np.float32)
    uv = _uv(rng, 300)
    _close(ts.sample_bilinear(torch.from_numpy(tex), torch.from_numpy(uv), mode),
           js.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv), mode))
    pad = "wrap" if mode == "wrap" else "edge"
    wt = ts.window_pack(torch.from_numpy(tex), 2, 2, pad, torch.float16)
    jw = js.window_pack(jnp.asarray(tex), 2, 2, pad, jnp.float16)
    _close(ts.sample_bilinear_window(wt, 11, 17, torch.from_numpy(uv), 2, mode),
           js.sample_bilinear_window(jw, 11, 17, jnp.asarray(uv), 2, mode))


def test_catmull_rom_window_matches_jax():
    rng = _rng(2)
    tex = rng.uniform(0, 3, (12, 20, 3)).astype(np.float32)
    uv = _uv(rng, 300)
    wt = ts.window_pack(torch.from_numpy(tex), 4, 4, dtype=torch.float16)
    jw = js.window_pack(jnp.asarray(tex), 4, 4, dtype=jnp.float16)
    _close(ts.sample_catmull_rom_window_decode(wt, 12, 20, torch.from_numpy(uv), 3),
           js.sample_catmull_rom_window_decode(jw, 12, 20, jnp.asarray(uv), 3))


def test_pcf_split_pack_and_sample_match_jax():
    """The port reads the PCF's 4x4 window straight from the u16 map
    (sampling.sample_pcf4_u16): the map equals the JAX split pack's texels
    and the 4-tap PCF its sample_pcf4_window_split."""
    rng = _rng(3)
    s = 64
    depth = rng.uniform(0, 1, (s, s)).astype(np.float32)
    q = ts.quantize_u16(torch.from_numpy(depth))
    ja, jb = js.pack_depth_window_u16_4x4_split(jnp.asarray(depth))
    qn = q.numpy().view(np.uint16)
    for k in range(16):
        dy, dx = divmod(k, 4)
        want = np.asarray(ja if k < 8 else jb)[..., k % 8]
        iy = np.minimum(np.arange(s) + dy, s - 1)
        ix = np.minimum(np.arange(s) + dx, s - 1)
        np.testing.assert_array_equal(qn[iy][:, ix], want)
    uv = _uv(rng, 500, 0.0, 1.0)
    ref = rng.uniform(0, 1, 500).astype(np.float32)
    offs = ((0.75, 0.25), (-0.25, 0.75), (0.25, -0.75), (-0.75, -0.25))
    _close(ts.sample_pcf4_u16(q, torch.from_numpy(uv), torch.from_numpy(ref), offs),
           js.sample_pcf4_window_split(ja, jb, s, jnp.asarray(uv), jnp.asarray(ref), offs))


def test_u16_quantize_round_trip():
    d = torch.tensor([0.0, 0.25, 0.5, 0.99999, 1.0, 1.5, -0.1])
    q = ts.quantize_u16(d)
    assert q.dtype == torch.int16
    np.testing.assert_array_equal(q.numpy().view(np.uint16),
                                  [0, 16384, 32768, 65534, 65535, 65535, 0])
    _close(ts.dequant_u16(q), np.array([0, 16384, 32768, 65534, 65535, 65535, 0]) / 65535.0,
           1e-7)


def test_mip_helpers_match_jax():
    assert ts.mip_offsets(544, 960, 6) == js.mip_offsets(544, 960, 6)
    assert ts.n_mip_levels(256, 256) == js.n_mip_levels(256, 256)
    tex = _rng(4).uniform(0, 1, (16, 24, 3)).astype(np.float32)
    _close(ts.downsample2x(torch.from_numpy(tex)), js.downsample2x(jnp.asarray(tex)), 1e-6)
    _close(ts.build_mip_atlas(torch.from_numpy(tex)), js.build_mip_atlas(jnp.asarray(tex)), 1e-6)
    lv = [tex, tex[:8, :12] * 0.5, tex[:4, :6] * 2]
    _close(ts.pack_mip_atlas([torch.from_numpy(x) for x in lv]),
           js.pack_mip_atlas([jnp.asarray(x) for x in lv]), 0)


def test_material_atlas_u8_matches_jax():
    rng = _rng(5)
    tex = rng.uniform(0, 1.5, (32, 32, 12)).astype(np.float32)
    scale = np.maximum(tex.reshape(-1, 12).max(0), 1.0).astype(np.float32)
    got = ts.build_mip_atlas_window_u8(torch.from_numpy(tex), torch.from_numpy(scale))
    want = js.build_mip_atlas_window_u8(jnp.asarray(tex), jnp.asarray(scale))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("filt", ["nearest", "trilinear"])
@pytest.mark.parametrize("mode", ["wrap", "clamp"])
def test_material_sampler_matches_jax(filt, mode):
    rng = _rng(6)
    texs = rng.uniform(0, 1, (3, 16, 16, 12)).astype(np.float32)
    scale = np.ones(12, np.float32)
    atlas = np.stack([np.asarray(js.build_mip_atlas_window_u8(jnp.asarray(t), jnp.asarray(scale)))
                      for t in texs])
    layer = rng.integers(0, 3, 400).astype(np.int32)
    uv = _uv(rng, 400, -2.0, 3.0)
    lod = rng.uniform(-1, 6, 400).astype(np.float32)
    tfn = getattr(ts, f"sample_mip_atlas_array_window_{filt}")
    jfn = getattr(js, f"sample_mip_atlas_array_window_{filt}")
    _close(tfn(torch.from_numpy(atlas), torch.from_numpy(layer), torch.from_numpy(uv),
               torch.from_numpy(lod), 12, scale=torch.from_numpy(scale), mode=mode),
           jfn(jnp.asarray(atlas), jnp.asarray(layer), jnp.asarray(uv), jnp.asarray(lod), 12,
               scale=jnp.asarray(scale), mode=mode))


def test_cubemap_directions_match_jax():
    rng = _rng(7)
    face = rng.integers(0, 6, 200).astype(np.int32)
    uv = rng.uniform(0, 1, (200, 2)).astype(np.float32)
    _close(ts.cubemap_dir_from_face_uv(torch.from_numpy(face), torch.from_numpy(uv)),
           js.cubemap_dir_from_face_uv(jnp.asarray(face), jnp.asarray(uv)))
    r = rng.normal(size=(300, 3)).astype(np.float32)
    tf, tuv = ts.cubemap_face_uv_from_dir(torch.from_numpy(r))
    jf, juv = js.cubemap_face_uv_from_dir(jnp.asarray(r))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _close(tuv, juv)


def _cube(seed, s=16):
    return _rng(seed).uniform(0, 3, (6, s, s, 3)).astype(np.float32)


def test_cube_atlas_and_lod_sampler_match_jax():
    faces = _cube(8)
    ta = ts.build_cube_mip_atlas(torch.from_numpy(faces))
    ja = js.build_cube_mip_atlas(jnp.asarray(faces))
    _close(ta, ja, 1e-6)
    rng = _rng(9)
    r = rng.normal(size=(400, 3)).astype(np.float32)
    lod = rng.uniform(-1, 6, 400).astype(np.float32)
    _close(ts.sample_cubemap_lod(ta, 16, torch.from_numpy(r), torch.from_numpy(lod)),
           js.sample_cubemap_lod(ja, 16, jnp.asarray(r), jnp.asarray(lod)))


def test_cube_window_pack_and_samplers_match_jax():
    atlas = np.asarray(js.build_cube_mip_atlas(jnp.asarray(_cube(10))))
    tw = ts.pack_cube_mip_atlas_window(torch.from_numpy(atlas), 16)
    jw = js.pack_cube_mip_atlas_window(jnp.asarray(atlas), 16)
    # the JAX table is the int32 bitcast view of the f16 window pack
    jw16 = np.asarray(jw).view(np.float16).reshape(tw.shape)
    assert tw.dtype == torch.float16
    np.testing.assert_array_equal(tw.numpy(), jw16)
    rng = _rng(11)
    r = rng.normal(size=(400, 3)).astype(np.float32)
    lod = rng.uniform(-1, 6, 400).astype(np.float32)
    for level in (0, 2, 4):
        _close(ts.sample_cubemap_level_window(tw, 16, torch.from_numpy(r), level),
               js.sample_cubemap_level_window(jw, 16, jnp.asarray(r), level))
    _close(ts.sample_cubemap_lod_window(tw, 16, torch.from_numpy(r), torch.from_numpy(lod)),
           js.sample_cubemap_lod_window(jw, 16, jnp.asarray(r), jnp.asarray(lod)))
