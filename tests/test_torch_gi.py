"""The port's voxel GI stages (shade/gi.py, the helpers of shade/gi_modes.py
and the GI samplers) against the JAX package, fed the same seed-made numpy
inputs.

Tolerances:
  * exact: the sweep on every axis (the same associative-scan tree; the
    per-frame axis schedule atol 1e-6, the JAX side compiled), the
    voxelized grid and its sample capacity, the three grid packs, the
    trilinear / nearest / compare / bf16 mip-atlas samplers and grid_sample,
    the interleave ops;
  * fog march: masks and positions exact, rgb atol 1e-6 (the sqrt tone
    compressor rounds differently by an ulp);
  * screen trace: status equal on >= 99.9% of lanes; uv atol 1e-5 and step
    length rtol 1e-5 where both resolved.
gi_pass and the GI branch of the lighting pass are in test_torch_gi_pass.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu.shade import gi_modes as jgm
from vulkan_pbr_renderer_tpu.utils import math3d as jm3
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as ts
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import gi_modes as tgm


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _grid(seed, d=16, occ=0.6):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 3.0, (d, d, d, 4)).astype(np.float32)
    g[..., 3] = rng.random((d, d, d)) > occ
    return g


# ---------------------------------------------------------------------------
# sweep


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_matches_jax(axis):
    """test_sweep_matches_glsl_semantics's grid (32 along the swept axis),
    and a 16^3 grid, through both packages."""
    rng = np.random.default_rng(1)
    g = np.zeros((32, 4, 4, 4), np.float32)
    g[..., :3] = rng.uniform(0, 2, (32, 4, 4, 3))
    g[..., 3] = rng.random((32, 4, 4)) < 0.3
    g = np.ascontiguousarray(np.moveaxis(g, 0, axis))
    for grid in (g, _grid(axis)):
        _eq(tgi.sweep_lightgrid(_t(grid), axis),
            jgi.sweep_lightgrid(jnp.asarray(grid), axis=axis))


@pytest.mark.parametrize("schedule", ["frame", "cycle"])
def test_sweep_rotated_schedule_matches_jax(schedule):
    """Pass 3's axis per frame (z, y, x rotating; held per 2-frame cycle
    under the interleave with gi_temporal_sweep="cycle"), and the u8 table
    it returns beside the grid."""
    from vulkan_pbr_renderer_tpu.app import renderer as jr
    from vulkan_pbr_renderer_tpu_torch.app import renderer as tr

    jcfg = JaxConfig(width=96, height=64, lightgrid_size=8, gi_temporal_sweep=schedule)
    tcfg = RenderConfig(width=96, height=64, lightgrid_size=8, gi_temporal_sweep=schedule)
    g = _grid(12, d=8)
    for frame_idx in range(6):
        # the JAX schedule runs under lax.switch, which XLA compiles with
        # FMA contraction: 1-ulp deltas; another axis would differ by O(1)
        swept, table = tr.sweep_rotated(_t(g), frame_idx, tcfg)
        np.testing.assert_allclose(
            swept.numpy(),
            jr.sweep_rotated(jnp.asarray(g), jnp.int32(frame_idx), jcfg), rtol=0, atol=1e-6)
        _eq(table, tgi.quantize_grid_u8(swept))


# ---------------------------------------------------------------------------
# voxelize


@functools.cache
def _voxel_inputs():
    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4), orm_factor=(1, .6, 0)),
            MaterialDesc(base_color_factor=(0.8, 0.2, 0.2, 1.0),
                         emissive_factor=(0.6, 0.3, 0.1))]
    parts = [procedural.make_plane((0, 0, 0), (12, 12), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1),
             procedural.make_uv_sphere((2.5, 1.0, 1.0), 0.8, 8, 16, 1)]
    scene = build_scene(parts, mats, texture_size=32)
    rng = np.random.default_rng(5)
    sun_depth = rng.uniform(0.3, 1.0, (64, 64)).astype(np.float32)
    return scene, sun_depth


@pytest.mark.parametrize("grid_size,extent,sun", [(16, 8.0, (40.0, 20.0)),
                                                  (32, 10.0, (60.0, 130.0))])
def test_voxelize_matches_jax(grid_size, extent, sun):
    from vulkan_pbr_renderer_tpu.shade import shadow as jshadow
    from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow

    scene, sun_depth = _voxel_inputs()
    tscene = convert.scene_from_numpy({k: np.asarray(v) for k, v in scene._asdict().items()},
                                      device="cpu")
    scale = 1.0 / extent
    cap = jgi.voxelize_sample_capacity(scene, grid_size, scale)
    assert tgi.voxelize_sample_capacity(tscene, grid_size, scale) == cap
    emission = 5.0 * np.asarray((1.0, 0.9, 0.7), np.float32)
    jm, jd = jshadow.sun_matrices(*sun, 40.0)
    want = jgi.voxelize_scene(scene, grid_size, scale, jnp.asarray(sun_depth), jm, jd,
                              jnp.asarray(emission), total_samples=cap)
    tm, td = tshadow.sun_matrices(*sun, 40.0)
    got = tgi.voxelize_scene(tscene, grid_size, scale, _t(sun_depth), tm, td,
                             _t(emission), total_samples=cap)
    _eq(got, np.asarray(want).astype(np.int64))
    assert int((got != 0).sum()) > 0
    _eq(tgi.decode_voxel_grid(got), jgi.decode_voxel_grid(want))


# ---------------------------------------------------------------------------
# grid packs and samplers


def test_grid_packs_match_jax():
    g = _grid(3)
    _eq(tgi.pack_grid_u8(_t(g)), jgi.pack_grid_u8(jnp.asarray(g)))
    _eq(tgi.pack_grid_alpha_u16(_t(g)).numpy().astype(np.uint16),
        jgi.pack_grid_alpha_u16(jnp.asarray(g)))
    _eq(tgi.pack_grid_f16_nearest(_t(g)), jgi.pack_grid_f16_nearest(jnp.asarray(g)))
    _eq(ts.window_pack3d(_t(g)), js.window_pack3d(jnp.asarray(g)))


def test_grid_sample_matches_jax():
    """test_grid_u16_bitcast_sampling_bit_identical's grid and lookups: the
    port's per-corner u8 decode equals the JAX u16-bitcast path."""
    rng = np.random.RandomState(3)
    grid = rng.rand(8, 8, 8, 4).astype(np.float32) * 4.0
    grid[..., 3] = grid[..., 3] > 2.0
    uvw = rng.rand(64, 3).astype(np.float32)
    jpack = jgi.pack_grid_u8(jnp.asarray(grid))
    tpack = tgi.pack_grid_u8(_t(grid))
    _eq(tgi._gs_uvw(tpack, _t(uvw)), jgi._gs_uvw(jpack, jnp.asarray(uvw)))
    ro = np.random.default_rng(4).uniform(-1.3, 1.3, (500, 3)).astype(np.float32)
    _eq(tgi.grid_sample(tpack, _t(ro)), jgi.grid_sample(jpack, jnp.asarray(ro)))
    _eq(tgi.grid_sample(_t(grid), _t(ro)), jgi.grid_sample(jnp.asarray(grid), jnp.asarray(ro)))
    _eq(tgi._sample_alpha_u16(tgi.pack_grid_alpha_u16(_t(grid)), _t(ro)),
        jgi._sample_alpha_u16(jgi.pack_grid_alpha_u16(jnp.asarray(grid)), jnp.asarray(ro)))
    _eq(tgi._sample_nearest_grid(tgi.pack_grid_f16_nearest(_t(grid)), _t(ro)),
        jgi._sample_nearest_grid(jgi.pack_grid_f16_nearest(jnp.asarray(grid)),
                                 jnp.asarray(ro)))


def test_gi_samplers_match_jax():
    rng = np.random.default_rng(6)
    uv = rng.uniform(-0.1, 1.1, (400, 2)).astype(np.float32)
    depth = rng.uniform(0.0, 1.0, (40, 48)).astype(np.float32)
    _eq(ts.sample_nearest(_t(depth), _t(uv)), js.sample_nearest8(jnp.asarray(depth),
                                                                 jnp.asarray(uv)))
    odd = depth[:, :45].copy()
    _eq(ts.sample_nearest(_t(odd), _t(uv)), js.sample_nearest8(jnp.asarray(odd),
                                                               jnp.asarray(uv)))
    sd = rng.uniform(0.0, 1.0, (64, 64)).astype(np.float32)
    ref = rng.uniform(0.0, 1.0, 400).astype(np.float32)
    wj = js.pack_depth_window_u16(jnp.asarray(sd))
    wt = ts.pack_depth_window_u16(_t(sd))
    _eq(wt.numpy().astype(np.uint16), wj)
    _eq(ts.sample_depth_compare_window(wt, 64, _t(uv), _t(ref)),
        js.sample_depth_compare_window(wj, 64, jnp.asarray(uv), jnp.asarray(ref)))
    g = _grid(7, d=8)
    uvw = rng.uniform(-0.2, 1.2, (400, 3)).astype(np.float32)
    _eq(ts.sample_trilinear_3d(_t(g), _t(uvw)), js.sample_trilinear_3d(jnp.asarray(g),
                                                                       jnp.asarray(uvw)))
    _eq(ts.sample_trilinear_window(ts.window_pack3d(_t(g)), _t(uvw), 4),
        js.sample_trilinear_window(js.window_pack3d(jnp.asarray(g)), jnp.asarray(uvw), 4))
    # the bf16 previous-frame pyramid at a per-lane continuous lod
    levels = [rng.uniform(0, 4, (32 >> k, 48 >> k, 3)).astype(np.float32) for k in range(3)]
    ja = js.pack_mip_atlas([jnp.asarray(x) for x in levels]).astype(jnp.bfloat16)
    ta = ts.pack_mip_atlas([_t(x) for x in levels]).to(torch.bfloat16)
    lod = rng.uniform(-1.0, 4.0, 400).astype(np.float32)
    _eq(ts.sample_mip_atlas(ta, 32, 48, _t(uv), _t(lod), levels=3),
        js.sample_mip_atlas(ja, 32, 48, jnp.asarray(uv), jnp.asarray(lod), levels=3))


# ---------------------------------------------------------------------------
# marches


@pytest.mark.parametrize("trilinear", [True, False])
def test_sample_radiance_fog_matches_jax(trilinear):
    rng = np.random.default_rng(8)
    g = _grid(9)
    ro = rng.uniform(-7.0, 7.0, (600, 3)).astype(np.float32)
    rd = rng.normal(size=(600, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    noise = rng.uniform(0, 1, 600).astype(np.float32)
    fog = rng.uniform(0, 1, 600).astype(np.float32)
    kw = dict(skip_steps=4, march_steps=12, step_scale=0.5, jitter_scale=2.0)
    want = jgi.sample_radiance_fog(
        jgi.pack_grid_f16_nearest(jnp.asarray(g)), jnp.asarray(ro), jnp.asarray(rd), 0.125,
        foggyness=jnp.asarray(fog), noise=jnp.asarray(noise),
        trilinear_grid=jgi.pack_grid_u8(jnp.asarray(g)) if trilinear else None, **kw)
    got = tgi.sample_radiance_fog(
        None if trilinear else tgi.pack_grid_f16_nearest(_t(g)), _t(ro), _t(rd), 0.125,
        foggyness=_t(fog), noise=_t(noise),
        trilinear_grid=tgi.pack_grid_u8(_t(g)) if trilinear else None, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        _eq(a, b)
    assert bool(np.asarray(want[4]).any()) and bool(np.asarray(want[3]).any())


def _trace_inputs(seed=0, h=24, w=32):
    """tests/test_gi_trace.py::_inputs: on-screen view-space starts, short
    hops to the open point, a bumpy depth buffer, a half-open alpha grid; a
    quarter of the lanes leave the screen."""
    rng = np.random.default_rng(seed)
    cfv = np.asarray(jm3.perspective_lh_zo(np.deg2rad(60.0), w / h, 0.1, 100.0))
    ang = 0.7
    wv = np.eye(4, dtype=np.float32)
    wv[:3, :3] = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                           [0, 0, 1]], np.float32)
    wv[:3, 3] = (1.0, -2.0, 0.5)
    z = rng.uniform(1.5, 12.0, (h, w)).astype(np.float32)
    nx = rng.uniform(-0.7, 0.7, (h, w)).astype(np.float32)
    ny = rng.uniform(-0.7, 0.7, (h, w)).astype(np.float32)
    f = 1.0 / np.tan(np.deg2rad(30.0))
    step = rng.uniform(-1.0, 1.0, (h, w, 3)).astype(np.float32)
    step[..., 2] = np.abs(step[..., 2]) * 0.5
    q = h // 4
    z[:q] = 1.6
    nx[:q] = 0.93
    p0 = np.stack([nx * z / (f * h / w), ny * z / f, z], -1)
    step[:q, :, 0] = 1.0
    step[:q, :, 1] = 0.0
    step[:q, :, 2] = -0.2
    open_vs = p0 + step * rng.uniform(0.5, 4.0, (h, w, 1)).astype(np.float32)
    d = rng.uniform(0.35, 0.99, (34, 40)).astype(np.float32)
    depth = np.minimum.reduce([np.roll(np.roll(d, i, 0), j, 1) for i in (0, 1) for j in (0, 1)])
    grid = rng.uniform(0.0, 1.0, (16, 16, 16, 4)).astype(np.float32)
    grid[..., 3] = (grid[..., 3] > 0.55) * grid[..., 3]
    noise = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32)
    return dict(depth=depth, grid=grid, p0=p0.astype(np.float32),
                open_vs=open_vs.astype(np.float32), cfv=cfv, wfv=wv, noise=noise)


@pytest.mark.parametrize("seed,solid_taps", [(0, 3), (3, 1), (5, 2)])
def test_screen_trace_linear_matches_jax(seed, solid_taps):
    i = _trace_inputs(seed)
    kw = dict(lightgrid_scale=0.1, steps=12, rounds=2, steps2=6, solid_taps=solid_taps)
    s_j, uv_j, sl_j = (np.asarray(x) for x in jgi.screen_trace_linear(
        jnp.asarray(i["depth"]), jgi.pack_grid_alpha_u16(jnp.asarray(i["grid"])),
        jnp.asarray(i["p0"]), jnp.asarray(i["open_vs"]), jnp.asarray(i["cfv"]),
        jnp.asarray(i["wfv"]), noise_01=jnp.asarray(i["noise"]), unroll=24, **kw))
    s_t, uv_t, sl_t = (x.numpy() for x in tgi.screen_trace_linear(
        _t(i["depth"]), tgi.pack_grid_alpha_u16(_t(i["grid"])), _t(i["p0"]),
        _t(i["open_vs"]), _t(i["cfv"]), _t(i["wfv"]), noise_01=_t(i["noise"]), **kw))
    assert (s_t == s_j).mean() >= 0.999, (s_t == s_j).mean()
    assert set(np.unique(s_j)) == {1, 2, 3}
    both = (s_t == 3) & (s_j == 3)
    assert both.sum() > 20
    np.testing.assert_allclose(uv_t[both], uv_j[both], rtol=0, atol=1e-5)
    np.testing.assert_allclose(sl_t[both], sl_j[both], rtol=1e-5)


@pytest.mark.parametrize("pattern", ["columns", "checker"])
@pytest.mark.parametrize("frame_idx", [4, 7])
def test_interleave_ops_match_jax(pattern, frame_idx):
    jcfg = JaxConfig(width=96, height=64, gi_temporal_pattern=pattern)
    tcfg = RenderConfig(width=96, height=64, gi_temporal_pattern=pattern)
    rng = np.random.default_rng(frame_idx)
    x = rng.normal(size=(32, 48, 3)).astype(np.float32)
    slot = rng.normal(size=(32, 48, 3)).astype(np.float32)
    jh, jm = jgm.interleave_ops(jcfg, jnp.int32(frame_idx))
    th, tm = tgm.interleave_ops(tcfg, frame_idx)
    _eq(th(_t(x)), jh(jnp.asarray(x)))
    _eq(th(_t(x[..., 0])), jh(jnp.asarray(x[..., 0])))
    half = rng.normal(size=(32, 24, 3)).astype(np.float32)
    _eq(tm(_t(slot), _t(half)), jm(jnp.asarray(slot), jnp.asarray(half)))


def test_gi_helpers_match_jax():
    rng = np.random.default_rng(10)
    n = rng.normal(size=(20, 30, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n1, n3 = (rng.uniform(0, 1, (20, 30)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tgm.bent_normal_cosine(_t(n), _t(n1), _t(n3)).numpy(),
                               jgm.bent_normal_cosine(jnp.asarray(n), jnp.asarray(n1),
                                                      jnp.asarray(n3)), rtol=0, atol=1e-6)
    d = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    for k in (1, 2, 4, 5):
        _eq(tgm._min_depth(_t(d), k), jgm._min_depth(jnp.asarray(d), k))
    rgb = rng.uniform(0, 4, (50, 3)).astype(np.float32)
    from vulkan_pbr_renderer_tpu.utils import color as jcolor
    from vulkan_pbr_renderer_tpu_torch.utils import color as tcolor
    np.testing.assert_allclose(tcolor.tone_compress_sqrt(_t(rgb)).numpy(),
                               jcolor.tone_compress_sqrt(jnp.asarray(rgb)), rtol=1e-6,
                               atol=1e-6)
    for cfg in (RenderConfig(width=96, height=64), RenderConfig(width=96, height=66),
                RenderConfig(width=96, height=64, gi_temporal_div=1),
                RenderConfig(width=96, height=64, enable_gi=False)):
        jcfg = JaxConfig(**{f: getattr(cfg, f) for f in ("width", "height",
                                                        "gi_temporal_div", "enable_gi")})
        assert tgm.gi_temporal_active(cfg) == jgm.gi_temporal_active(jcfg)
