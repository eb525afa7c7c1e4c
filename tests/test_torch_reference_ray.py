"""One reference-GI ray (shade/gi.py::reference_ray_resolve and its plain
version, the function of the CUDA kernel csrc/gi_reference_ray.cu) on the
CPU: the plain version on the u8 table against the hybrid march on the
window packs, the plain version against the JAX package's eager
sample_radiance_with_screen_trace, gi_modes.reference_gi on the table
against the same frame's GI on the packs, and the wrapper's checks.  The
kernel itself runs on the card: tests/test_torch_cuda.py and chip_smoke.py.

Tolerances:
  * the u8 table route equals the window-pack route bit for bit (the
    table's trilinear fetches equal the packs', and the skip's open sample
    and sum are the same numbers);
  * against JAX: atol 1e-4 and the lanes whose radiance is exactly 0 (no
    voxel opened) the same, as tests/test_torch_gi_reference.py holds the
    march; eager JAX, not jitted.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_ray_inputs import SETS, set_arrays, set_call_args
from test_torch_reference_ray_inputs import _one_thread  # noqa: F401 (the module's fixture)
from test_torch_shade_inputs import frame_config, lighting_inputs, shade_scene
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as ts
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import gi_modes as tgm
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight

ATOL = 1e-4
SET_NAMES = [s[0] for s in SETS]


def _bits(t):
    return t.contiguous().view(torch.int32)


@functools.cache
def _port_ray(name):
    """reference_ray_resolve's (rgb, status) of a seeded set on the CPU."""
    return tgi.reference_ray_resolve(*set_call_args(name, "cpu"))


def _march_kwargs(rp):
    return dict(max_ss_steps=rp.max_ss_steps, prev_base=(rp.prev_h, rp.prev_w),
                prev_levels=rp.prev_levels)


@pytest.mark.parametrize("name", SET_NAMES)
def test_reference_ray_equals_hybrid_march_on_packs(name):
    """The plain version through the wrapper's CPU dispatch equals
    sample_radiance_with_screen_trace on the u8 table and on the window
    packs (pack_grid_u8 with pack_grid_alpha_u16, the route reference_gi
    took before the table) bit for bit."""
    arrays, _, _, _ = set_arrays(name)
    (table, depth, atlas, *mats, vd, pv, pw, rd, noise, fog, rp) = set_call_args(name, "cpu")
    rgb, status = _port_ray(name)
    pos = (depth, atlas, *mats, vd, pv, pw, rd, rp.lightgrid_scale, rp.num_steps, rp.step_scale,
           noise, fog, rp.ss_intensity)
    on_table = tgi.sample_radiance_with_screen_trace(table, *pos, **_march_kwargs(rp))
    grid = torch.from_numpy(arrays["grid"])
    on_packs = tgi.sample_radiance_with_screen_trace(
        tgi.pack_grid_u8(grid), *pos, **_march_kwargs(rp),
        alpha_grid=tgi.pack_grid_alpha_u16(grid))
    assert torch.equal(_bits(rgb), _bits(on_table))
    assert torch.equal(_bits(rgb), _bits(on_packs))
    assert status.dtype == torch.int32 and set(status.unique().tolist()) == {1, 2, 3}


@functools.cache
def _jax_ray(name):
    """The JAX package's eager sample_radiance_with_screen_trace on the
    seeded set's lanes, on its window packs (reference_gi's route)."""
    arrays, _, _, _ = set_arrays(name)
    *_, fog, rp = set_call_args(name, "cpu")
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    jfog = a["roughness"] if torch.is_tensor(fog) else fog
    out = jgi.sample_radiance_with_screen_trace(
        jgi.pack_grid_u8(a["grid"]), a["depth"], a["atlas"].astype(jnp.bfloat16),
        a["view_from_world"], a["clip_from_view"], a["view_from_clip"], a["world_from_view"],
        a["vd"], a["pv"], a["pw"], a["rd"], rp.lightgrid_scale, rp.num_steps, rp.step_scale,
        a["noise"], jfog, rp.ss_intensity, **_march_kwargs(rp),
        alpha_grid=jgi.pack_grid_alpha_u16(a["grid"]))
    return np.asarray(out)


@pytest.mark.parametrize("name", ["specular", "short_trace"])
def test_reference_ray_matches_jax(name):
    """Per-lane foggyness over 24 trace steps, and a scalar one over 7."""
    rgb, status = _port_ray(name)
    want = _jax_ray(name)
    got = rgb.numpy()
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0,
                               atol=ATOL)
    dark = (want == 0).all(-1)
    np.testing.assert_array_equal((got == 0).all(-1), dark)
    assert 0 < dark.sum() and (status.numpy()[dark] == 2).all()


@functools.cache
def _gi_frame():
    """A 48x64 G-buffer of tests/test_torch_shade_inputs.py's plane + cube
    scene, a seed-made 16^3 lightgrid (open, translucent and solid voxels)
    with its u8 table, and a seed-made bf16 pyramid of 3 levels."""
    h, w = 48, 64
    g, glob, _, _ = lighting_inputs(shade_scene("cpu"), h, w)
    rng = np.random.default_rng(71)
    grid = rng.uniform(0.0, 3.0, (16, 16, 16, 4)).astype(np.float32)
    kind = rng.random((16, 16, 16))
    grid[..., 3] = np.where(kind < 0.45, 0.0, np.where(kind < 0.7, 0.2, rng.uniform(0.3, 1.0, kind.shape)))
    grid = torch.from_numpy(grid)
    _, wa = ts.mip_offsets(h // 2, w // 2, 3)
    prev = torch.from_numpy(rng.uniform(0, 3, (h // 2, wa, 3)).astype(np.float32))
    res = tlight.LightingResources(sun_depth=None, prefiltered_env=None, brdf_lut=None,
                                   lightgrid=grid, lightgrid_u8=tgi.quantize_grid_u8(grid),
                                   prev_frame_atlas=prev.to(torch.bfloat16))
    return g, glob, res


@pytest.mark.parametrize("temporal,depth_div", [(False, 1), (True, 2)])
def test_reference_gi_reads_the_table_as_the_packs(monkeypatch, temporal, depth_div):
    """gi_pass in reference mode (reference_gi on the sweep's u8 table,
    through reference_ray_resolve) equals the same frame's GI with each ray
    marched on the window packs of the grid, bit for bit: with and without
    the interleave, at full and half trace depth."""
    g, glob, res = _gi_frame()
    h, w = g.depth.shape
    cfg = frame_config(h, w, gi_mode="reference", gi_temporal_reference=temporal,
                       gi_reference_depth_div=depth_div)
    assert tgm.gi_temporal_active(cfg) == temporal
    rng = np.random.default_rng(72)
    cache = torch.from_numpy(rng.uniform(0, 1, (2, h // 2, w // 2, 3)).astype(np.float32))
    kw = dict(gi_cache=cache, frame_idx=5) if temporal else {}
    got = tgm.gi_pass(cfg, glob, res, g, g.depth, h, w, 5.0, **kw)

    wgrid, walpha = tgi.pack_grid_u8(res.lightgrid), tgi.pack_grid_alpha_u16(res.lightgrid)
    calls = []

    def on_packs(table, depth, atlas, vfw, cfv, vfc, wfv, vd, pv, pw, rd, noise, fog, rp):
        calls.append(depth.shape)
        return tgi.sample_radiance_with_screen_trace(
            wgrid, depth, atlas, vfw, cfv, vfc, wfv, vd, pv, pw, rd, rp.lightgrid_scale,
            rp.num_steps, rp.step_scale, noise, fog, rp.ss_intensity, **_march_kwargs(rp),
            alpha_grid=walpha), None

    monkeypatch.setattr(tgi, "reference_ray_resolve", on_packs)
    want = tgm.gi_pass(cfg, glob, res, g, g.depth, h, w, 5.0, **kw)
    assert calls == [(-(-h // depth_div), -(-w // depth_div))] * 2
    for a, b in zip(got, want):
        if b is None:
            assert a is None and not temporal
        else:
            assert torch.equal(_bits(a), _bits(b))
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0


def test_reference_ray_wrapper_rejects_bad_inputs():
    args = set_call_args("diffuse", "cpu")
    rp = args[13]
    bad = {0: args[0].float(),                         # table not u8
           1: args[1].double(),                        # trace depth not f32
           2: args[2].float(),                         # pyramid not bf16
           2.5: args[2][:, :10],                       # pyramid narrower than its levels
           3: args[3][:3],                             # a matrix not 4x4
           7: args[7][:100],                           # vd of another shape
           9: args[9][..., :2],                        # pw not [..., 3]
           11: args[11].half(),                        # noise not f32
           12: torch.ones(7),                          # per-lane fog of another shape
           13: rp._replace(prev_levels=17),            # more levels than the kernel keeps
           13.5: rp._replace(max_ss_steps=-1)}
    for i, value in bad.items():
        call = list(args)
        call[int(i)] = value
        with pytest.raises(ValueError):
            tgi.reference_ray_resolve(*call)
