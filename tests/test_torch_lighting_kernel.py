"""The lighting kernels' plain versions (the references of csrc/lighting.cu)
against the JAX package, on tests/test_torch_shade_inputs.py's 64x48 frame
(its G-buffer handed to both packages as numpy):
  - gi_modes.gi_lane_inputs_plain (gi_inputs_kernel) against the JAX
    lighting pass's sub_inputs composed with bent_normal_cosine,
    _specular_ray and interleave_ops' half, in both interleave patterns
    and parities and at a separate diffuse divisor;
  - shadow.shafts_polar_plain (shafts_polar) against the JAX sub_inputs
    composed with light_shafts_polar, at divisors 4 and 1;
  - lighting_pass (shade_plain) against JAX's where the sky is sampled at
    full resolution: a row band of the frame and an odd-sized frame;
  - the tables made from JAX-converted state: the u16 sun map and the f16
    LUT against the JAX package's own packs;
  - the wrappers' CPU dispatch: the plain versions, no launch counted.

Tolerances: the traced lanes' selection exactly equal (the same lanes in
the same order); f32 atol / rtol 1e-5 (test_torch_shade.py's), except the
GI lanes' rays at 1e-5 with bent and spec taken after arccos, sin and cos,
which XLA and PyTorch evaluate with their own CPU math libraries (atol
2e-5 there).  The kernels run only on the card (tests/test_torch_cuda.py).
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shade_inputs import frame_config, lighting_inputs, shade_scene
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu.gpu import sampling as jsamp
from vulkan_pbr_renderer_tpu.shade import gbuffer as jgb
from vulkan_pbr_renderer_tpu.shade import gi_modes as jgm
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu.shade import shadow as jshadow
from vulkan_pbr_renderer_tpu.utils import math3d as jm3
from vulkan_pbr_renderer_tpu.utils import noise as jnoise
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.app import renderer as trender
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as tsamp
from vulkan_pbr_renderer_tpu_torch.shade import gi_modes as tgm
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow

H, W = 48, 64


@functools.cache
def _frame(band=None):
    return lighting_inputs(shade_scene("cpu"), H, W, band=band)


def _j(t):
    return jnp.asarray(t.numpy())


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


def _jax_globals(glob):
    return jlight.Globals(**{k: (jnp.float32(v) if k == "frame_idx_mod_59" else _j(v))
                             for k, v in glob._asdict().items()})


def _jax_sub(g, glob, k, f59, row_offset, fh):
    """The JAX lighting pass's sub_inputs at the [::k, ::k] grid."""
    d = _j(g.depth)[::k, ::k]
    hd, wd = d.shape
    pw, pv = jlight.reconstruct_positions(d, _j(glob.world_from_clip), _j(glob.view_from_clip),
                                          row_offset, fh, stride=k)
    px = jnp.broadcast_to(jnp.arange(wd, dtype=jnp.float32)[None, :] * k + 0.5, (hd, wd))
    py = jnp.broadcast_to(jnp.arange(hd, dtype=jnp.float32)[:, None] * k + row_offset + 0.5,
                          (hd, wd))
    noises = tuple(jnoise.frame_noise(px, py, jnp.float32(f59), offset=o)
                   for o in ((0.0, 0.0), (90.0, 20.0), (522.0, 55.0)))
    return _j(g.normal)[::k, ::k], _j(g.orm)[::k, ::k, 1], pw, pv, noises


LANE_CASES = [("columns_0", 2, "columns", 0, None), ("columns_1", 2, "columns", 1, None),
              ("checker_0", 2, "checker", 0, None), ("checker_1", 2, "checker", 1, (8, 24)),
              ("diffuse_k4", 4, None, 0, None)]


@pytest.mark.parametrize("name,k,pattern,parity,band", LANE_CASES,
                         ids=[c[0] for c in LANE_CASES])
def test_gi_lane_inputs_plain_match_jax(name, k, pattern, parity, band):
    g, glob, _, kw = _frame(band)
    f59 = 7.0
    got = tgm.gi_lane_inputs_plain(g.normal, g.orm, g.depth, glob.world_from_clip,
                                   glob.view_from_clip, glob.camera_pos, k, f59,
                                   kw["row_offset"], H, pattern, parity, pattern is not None)
    nd, roughd, pwd, pvd, (n1d, n2d, n3d) = _jax_sub(g, glob, k, f59, kw["row_offset"], H)
    vd = jm3.normalize(_j(glob.camera_pos) - pwd)
    ctx = SimpleNamespace(nd=nd, roughd=roughd, vd=vd, n1d=n1d, n2d=n2d, n3d=n3d)
    want = dict(pw=pwd, pv=pvd, bent=jgm.bent_normal_cosine(nd, n1d, n3d), n3=n3d, vd=vd,
                spec=jgm._specular_ray(ctx), rough=roughd)
    if pattern is not None:
        half, _ = jgm.interleave_ops(JaxConfig(gi_temporal_pattern=pattern),
                                     jnp.int32(parity + 4))
        want = {key: half(v) for key, v in want.items()}
        # the traced lanes: the G-buffer's own depth at exactly the half's pixels
        _close(got.pw, want["pw"], what="pw")
    for key in got._fields:
        if getattr(got, key) is None:
            assert pattern is None and key in ("vd", "spec", "rough")
            continue
        tol = 2e-5 if key in ("bent", "spec") else 1e-5
        assert getattr(got, key).shape == want[key].shape, key
        _close(getattr(got, key), want[key], tol, key)


@pytest.mark.parametrize("k,band", [(4, None), (4, (13, 21)), (1, None)],
                         ids=["k4", "k4_band", "k1"])
def test_shafts_polar_plain_matches_jax(k, band):
    g, glob, tables, kw = _frame(band)
    em = tlight.sun_emission(frame_config(H, W))
    got = tshadow.shafts_polar_plain(
        tables["sun_depth"], glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
        glob.world_from_clip, glob.view_from_clip, k, 3.0, torch.as_tensor(em),
        max_steps=12, n_theta=4096, n_r=12, row_offset=kw["row_offset"], full_height=H)
    nd, _, pwd, _, (n1d, _, _) = _jax_sub(g, glob, k, 3.0, kw["row_offset"], H)
    want = jshadow.light_shafts_polar(_j(tables["sun_depth"]), _j(glob.sun_from_world),
                                      _j(glob.camera_pos), pwd, nd, n1d, jnp.asarray(em),
                                      max_steps=12, n_theta=4096, n_r=12)
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    _close(got, want)


@pytest.mark.parametrize("band,size", [((13, 21), (H, W)), (None, (47, 63))],
                         ids=["band_13_21", "odd_47x63"])
def test_lighting_pass_full_res_sky_matches_jax(band, size):
    """GI off: the sky at full resolution (a band of a taller frame, or an
    odd frame), shafts at divisor 4, static IBL."""
    h, w = size
    g, glob, tables, kw = (_frame(band) if size == (H, W)
                           else lighting_inputs(shade_scene("cpu"), h, w))
    rows = g.depth.shape[0]
    cfg = frame_config(h, w, enable_gi=False)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in
                        ("width", "height", "shadow_map_size", "light_shaft_steps",
                         "enable_gi", "brdf_lut_size", "prefiltered_env_size")})
    assert jcfg.shaft_res_divisor == cfg.shaft_res_divisor == 4
    raw_lut = tables["lut16"].float()
    res_t = tlight.LightingResources(sun_depth=tables["sun_depth"],
                                     prefiltered_env=tables["env"], brdf_lut=raw_lut)
    got = tlight.lighting_pass(g, glob, res_t, cfg, row_offset=kw["row_offset"], full_height=h)
    res_j = jlight.LightingResources(sun_depth=_j(tables["sun_depth"]),
                                     prefiltered_env=_j(tables["env"]), brdf_lut=_j(raw_lut),
                                     lightgrid=None, prev_frame_atlas=None)
    want = jlight.lighting_pass(jgb.GBuffer(*(_j(x) for x in g)), _jax_globals(glob), res_j,
                                jcfg, row_offset=kw["row_offset"], full_height=h)
    assert got.shape == (rows, w, 3)
    _close(got, want)


def test_tables_from_converted_state():
    """The u16 sun map and the f16 LUT the renderer makes from JAX state
    carried by convert.py equal the JAX package's own quantized packs (the
    texel at each window's origin), bit for bit."""
    _, _, tables, _ = _frame()
    sun_depth = tables["sun_depth"].numpy()
    lut = np.random.default_rng(3).uniform(0, 1, (16, 16, 2)).astype(np.float32)
    env = np.zeros((6, 16, 31, 3), np.float32)
    cfg = frame_config(H, W)
    state = trender.init_frame_state(cfg, "cpu")
    jstate = {k: (sun_depth if k == "sun_depth" else
                  np.full(2, np.nan, np.float32) if k == "sun_angle_prev" else
                  0 if k == "frame_idx" else getattr(state, k).float().numpy())
              for k in ("lightgrid", "gi_cache", "sun_depth", "taa_history", "velocity_prev",
                        "prev_pyramid", "clip_from_world_prev", "raster_overflow",
                        "frame_idx", "sun_angle_prev")}
    carried = convert.state_from_numpy(jstate, device="cpu")
    _, tlut = convert.bakes_from_numpy(env, lut, device="cpu")
    sun_u16, _, lut16 = trender.frame_tables(carried, shade_scene("cpu"), tlut, cfg,
                                             carried.sun_depth, False)
    jwa, _ = jsamp.pack_depth_window_u16_4x4_split(jnp.asarray(sun_depth))
    np.testing.assert_array_equal(sun_u16.numpy().view(np.uint16), np.asarray(jwa)[..., 0])
    jlut = jsamp.window_pack(jnp.asarray(lut), 2, 2, dtype=jnp.float16)
    np.testing.assert_array_equal(lut16.numpy(), np.asarray(jlut)[..., 0:2])
    assert carried.sun_u16 is None and carried.brdf_lut16 is not None


def test_lighting_wrappers_cpu_take_plain_versions():
    """On CPU tensors gi_lane_inputs, shafts_polar and shade are their plain
    versions, bit for bit, and count no launch."""
    g, glob, tables, kw = _frame((8, 24))
    counters = (tgm.gi_lane_inputs, tshadow.shafts_polar, tlight.shade)
    before = [f.launches for f in counters]
    lane_args = (g.normal, g.orm, g.depth, glob.world_from_clip, glob.view_from_clip,
                 glob.camera_pos, 2, 5.0, kw["row_offset"], H, "checker", 1)
    for a, b in zip(tgm.gi_lane_inputs(*lane_args), tgm.gi_lane_inputs_plain(*lane_args)):
        assert torch.equal(a, b)
    em = tlight.sun_emission(frame_config(H, W))
    sargs = (tables["sun_depth"], glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
             glob.world_from_clip, glob.view_from_clip, 4, 3.0)
    assert torch.equal(tshadow.shafts_polar(*sargs, em, row_offset=8, full_height=H),
                       tshadow.shafts_polar_plain(*sargs, torch.as_tensor(em), row_offset=8,
                                                  full_height=H))
    cfg = frame_config(H, W)
    shade_args = (g, glob, cfg, tables["sun_u16"], tables["lut16"], tables["env"],
                  tables["shafts"], tables["ambient"], tables["spec"], 8, H)
    assert torch.equal(tlight.shade(*shade_args), tlight.shade_plain(*shade_args))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="together"):
        tlight.shade(g, glob, cfg, tables["sun_u16"], tables["lut16"], tables["env"],
                     ambient=tables["ambient"])
    with pytest.raises(ValueError, match="pattern"):
        tgm.gi_lane_inputs(*lane_args[:10], "rows", 0)
    # the sun map is quantized once per sun change: quantize_u16's bit patterns
    q = tsamp.quantize_u16(tables["sun_depth"])
    assert torch.equal(tables["sun_u16"], q)
