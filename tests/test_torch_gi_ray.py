"""One fast-GI ray (shade/gi.py::fast_ray_resolve and its plain version,
the function of the CUDA kernel csrc/gi_fast_ray.cu) on the CPU: the u8
table the kernel reads against the window packs, the plain version against
the JAX package's fast-GI composition (gi_modes.py's "trace" branch, called
op by op as tests/test_torch_gi.py calls it), and the wrapper's dispatch
and checks.  The kernel itself runs on the card: tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances:
  * the table's trilinear fetches equal the window packs' bit for bit;
  * the ray: statuses equal on >= 99.9% of lanes (a rare trace decision
    moves) and rgb atol 1e-6 where they agree (the sqrt tone compressor
    rounds differently by an ulp), test_torch_gi.py's; on the lanes
    resolved on screen (status 3) atol 1e-5: their pyramid sample is taken
    at the trace's uv and lod, which agree with the JAX trace to a few ulp
    (test_torch_gi.py holds them to uv atol 1e-5, step rtol 1e-5), and the
    random pyramid changes by up to 3 per texel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gi_ray_inputs import random_rays, ray_call_args
from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu.utils import color as jcolor
from vulkan_pbr_renderer_tpu.utils import math3d as jm3
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as ts
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed,d", [(0, 16), (1, 9)])
def test_table_fetches_equal_window_packs(seed, d):
    """quantize_grid_u8 read by sample_trilinear_table (the kernel's fetch)
    equals sample_trilinear_window on pack_grid_u8 (rgb + alpha, decoded per
    corner) and on pack_grid_alpha_u16 (alpha) bit for bit, at uvw inside,
    outside and on the edge texels of the grid; the table holds the corners
    the JAX package's pack stores."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 4.0, (d, d + 2, d + 1, 4)).astype(np.float32)
    g[..., 3] = np.where(rng.random(g.shape[:3]) < 0.5, 0.0, rng.random(g.shape[:3]))
    g[0, 0, 0, :3] = -1.0                       # clamps to 0 before the sqrt
    uvw = rng.uniform(-0.3, 1.3, (2000, 3)).astype(np.float32)
    edges = np.array([0.0, 0.5 / d, 1.0 - 0.5 / d, 1.0, -1e-7, 1.0 + 1e-7], np.float32)
    uvw[:216] = np.stack(np.meshgrid(edges, edges, edges, indexing="ij"), -1).reshape(-1, 3)
    table = tgi.quantize_grid_u8(_t(g))
    assert table.dtype == torch.uint8 and table.shape == g.shape
    _eq(ts.window_pack3d(table), jgi.pack_grid_u8(jnp.asarray(g)))
    u = _t(uvw)
    _eq(ts.sample_trilinear_table(table, u, decode=tgi._decode_grid_u8),
        ts.sample_trilinear_window(tgi.pack_grid_u8(_t(g)), u, 4, decode=tgi._decode_grid_u8))
    _eq(tgi._alpha_uvw(table, u),
        ts.sample_trilinear_window(tgi.pack_grid_alpha_u16(_t(g)), u, 1,
                                   decode=tgi._decode_alpha)[..., 0])
    _eq(tgi._alpha_uvw(table, u), tgi._alpha_uvw(tgi.pack_grid_alpha_u16(_t(g)), u))
    ro = u * 2.0 - 1.0
    _eq(tgi.grid_sample(table, ro), jgi.grid_sample(jgi.pack_grid_u8(jnp.asarray(g)),
                                                    jnp.asarray(ro.numpy())))


def _jax_ray(arrays, scalars, spec, trilinear, screen):
    """The JAX package's fast GI for one ray (gi_modes.py:229-291 with
    gi_fast_screen_mode "trace"), op by op on the CPU: (rgb, status or
    None)."""
    from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig

    cfg = JaxConfig()
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    scale = scalars["lightgrid_scale"]
    grid = a["grid"]
    wgrid, walpha = jgi.pack_grid_u8(grid), jgi.pack_grid_alpha_u16(grid)
    if spec:
        steps, step_scale, ss = (cfg.gi_fast_hit_steps_spec, cfg.gi_fast_hit_step_scale_spec,
                                 cfg.gi_specular_ss_intensity)
        fog = a["roughness"]
    else:
        steps, step_scale, ss = (cfg.gi_fast_hit_steps, cfg.gi_fast_hit_step_scale,
                                 cfg.gi_diffuse_ss_intensity)
        fog = cfg.gi_diffuse_foggyness
    pw, noise = a["pw"], a["noise"]
    rgb, ro_open, _, _, _ = jgi.sample_radiance_fog(
        jgi.pack_grid_f16_nearest(grid), pw, a["rd"], scale,
        skip_steps=cfg.gi_fast_skip_steps, open_thresh=cfg.gi_fast_open_thresh,
        march_steps=steps, step_scale=step_scale, noise=noise, foggyness=fog,
        trilinear_grid=wgrid if trilinear else None, jitter_scale=cfg.gi_fast_jitter_scale)
    if not screen:
        return np.asarray(rgb), None
    open_vs = jm3.transform_points(a["view_from_world"], ro_open / scale)[..., :3]
    v_cam = jm3.normalize(a["camera_pos"] - pw)
    fb = jgi.grid_sample(wgrid, pw * scale + 2.5 * v_cam * (2.0 / grid.shape[0]))
    fb_rgb = jcolor.tone_compress_sqrt(fb[..., :3])
    status, res_uv, res_slen = jgi.screen_trace_linear(
        a["depth"], walpha, a["pv"], open_vs, a["clip_from_view"], a["world_from_view"],
        scale, noise, steps=cfg.gi_trace_steps, rounds=cfg.gi_trace_rounds,
        steps2=cfg.gi_trace_steps2, solid_taps=cfg.gi_trace_solid_taps)
    lod = jnp.minimum(res_slen * 5.0, 5.0)
    prev = js.sample_mip_atlas(a["atlas"].astype(jnp.bfloat16), scalars["prev_h"],
                               scalars["prev_w"], res_uv, lod, levels=scalars["levels"])[..., :3]
    rgb = jnp.where((status == 1)[..., None], fb_rgb, rgb)
    rgb = jnp.where((status == 3)[..., None], prev * ss, rgb)
    return np.asarray(rgb), np.asarray(status)


@pytest.mark.parametrize("screen", [True, False], ids=["screen", "no_screen"])
@pytest.mark.parametrize("trilinear", [True, False], ids=["trilinear", "nearest"])
@pytest.mark.parametrize("spec", [False, True], ids=["diffuse", "specular"])
def test_fast_ray_plain_matches_jax(spec, trilinear, screen):
    arrays, scalars = random_rays(3 + 2 * spec + trilinear, n=64 * 48)
    args = ray_call_args(arrays, scalars, "cpu", spec=spec, gi_fast_fog_trilinear=trilinear,
                         gi_fast_screen_probe=screen)
    rgb, status = (x.numpy() for x in tgi.fast_ray_resolve_plain(*args))
    want_rgb, want_status = _jax_ray(arrays, scalars, spec, trilinear, screen)
    assert rgb.shape == want_rgb.shape == arrays["pw"].shape
    if not screen:
        assert (status == 2).all()
        np.testing.assert_allclose(rgb, want_rgb, rtol=0, atol=1e-6)
        return
    same = status == want_status
    assert same.mean() >= 0.999, same.mean()
    assert set(np.unique(want_status)) == {1, 2, 3}
    resolved = same & (status == 3)
    assert resolved.sum() > 100
    np.testing.assert_allclose(rgb[same & ~resolved], want_rgb[same & ~resolved], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rgb[resolved], want_rgb[resolved], rtol=0, atol=1e-5)


def test_fast_ray_wrapper_cpu_dispatch_and_checks():
    """CPU tensors take the plain version (no launch); a wrong dtype, shape,
    device or a non-contiguous input raises ValueError before any dispatch."""
    arrays, scalars = random_rays(7, n=512)
    args = ray_call_args(arrays, scalars, "cpu", spec=True)
    before = tgi.fast_ray_resolve.launches
    got = tgi.fast_ray_resolve(*args)
    want = tgi.fast_ray_resolve_plain(*args)
    assert tgi.fast_ray_resolve.launches == before
    for a, b in zip(got, want):
        _eq(a, b)
    pw = args[8]
    bad = {0: args[0].float(),                       # table not u8
           1: args[1],                               # (placeholder, replaced below)
           2: args[2].double(),                      # trace table not f32
           3: args[3].float(),                       # pyramid not bf16
           4: args[4][:3],                           # matrix not [4,4]
           8: pw.t().contiguous().t(),               # pw not contiguous
           9: args[9][:100],                         # rd of another shape
           10: args[10].double(),                    # pv not f32
           11: args[11][:, None],                    # noise of another shape
           12: args[12][::2]}                        # foggyness of another shape
    bad[1] = tgi.pack_grid_f16_nearest(torch.zeros(4, 4, 4, 4))   # fgrid's grid differs
    for i, value in bad.items():
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            tgi.fast_ray_resolve(*call)
    assert tgi.fast_ray_resolve.launches == before
