"""Row bands: the y_origin / row_offset arguments that the row-sharded frame
(parallel/sharding.py) passes to the raster and shading modules, against
the JAX package's bands and against the port's own whole-frame passes.

A band is the rows [y0, y0 + rows) of a frame of `h` rows.  Tolerances:
bins, ids and packed voxel words exactly equal; a band of the port equal to
the same rows of its whole-frame pass bit for bit (raster, G-buffer, TAA);
against JAX, depth atol 1e-6 (as test_torch_raster.py), the G-buffer atol
1e-5 and its base colour 1e-4 (as test_torch_shade.py), TAA atol 1e-5, and
the GI lighting pass >= 99% of values within 1e-4 with the mean |difference|
below 1e-4 (as test_torch_gi_pass.py).
"""

import functools
import threading


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer_tpu.bake import ibl as jibl
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu.raster import binning as jbin
from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu.raster import visibility as jvis
from vulkan_pbr_renderer_tpu.raster import visibility_v2 as jv2
from vulkan_pbr_renderer_tpu.raster import xla_raster as jxla
from vulkan_pbr_renderer_tpu.shade import gbuffer as jgb
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu.shade import shadow as jshadow
from vulkan_pbr_renderer_tpu.shade import taa as jtaa
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.raster import binning as tbin
from vulkan_pbr_renderer_tpu_torch.raster import setup as tsetup
from vulkan_pbr_renderer_tpu_torch.raster import visibility as tvis
from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as tv2
from vulkan_pbr_renderer_tpu_torch.raster import xla_raster as txla
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as tgb
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow
from vulkan_pbr_renderer_tpu_torch.shade import taa as ttaa


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_tris(n, seed):
    """tests/test_raster_pallas.py::_random_tris."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).repeat(3, 1)
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


def _crossing_tris(n, seed):
    """tests/test_raster_pallas.py::test_near_plane_crossing_bbox_conservative."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-2, 2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32).repeat(3, 1)
    w = rng.uniform(-0.5, 1.5, (n, 3, 1)).astype(np.float32)
    return np.concatenate([verts * np.abs(w), z * np.abs(w), w], -1)


# (triangles, width, height); bands (y0, rows): tile-aligned and not
CASES = {"random600_seed11": (lambda: _random_tris(600, 11), 128, 96),
         "crossing40_seed21": (lambda: _crossing_tris(40, 21), 160, 96)}
BANDS = [(32, 64), (16, 48)]


@functools.cache
def _setups(case):
    """The JAX triangle setup over the whole viewport and the same arrays as
    the port's TriSetup."""
    make, w, h = CASES[case]
    s = jsetup.setup_triangles(jnp.asarray(make()), w, h, cull="none")
    return s, tsetup.TriSetup(*(torch.from_numpy(np.asarray(x)) for x in s)), w, h


def _depth_eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_allclose(np.where(np.isinf(a), -1, a), np.where(np.isinf(b), -1, b),
                               atol=1e-6, rtol=0)


def _exact(got, want):
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# JAX's binning and TAA compiled once (row_offset traced; op by op they
# cost seconds each here).  The other JAX passes stay op by op, as in
# test_torch_raster.py, test_torch_shade.py and test_torch_gi.py: compiled,
# XLA fuses their products into FMAs that move values past those files'
# tolerances.
_jax_bin = jax.jit(jbin.bin_triangles, static_argnums=(1, 2, 3, 4, 5),
                   static_argnames=("tile_capacity", "chunk", "y_origin", "z_order", "fmt"))
_jax_taa = jax.jit(jtaa.taa_resolve, static_argnames=("catmull_history", "full_rgb_catmull",
                                                      "halo", "full_height"))


# ---------------------------------------------------------------------------
# raster


@pytest.mark.parametrize("fmt,z_order", [("slim13", False), ("slim13", True),
                                         ("wide16", False)])
@pytest.mark.parametrize("y0,rows", BANDS)
def test_bin_band_matches_jax(fmt, z_order, y0, rows):
    jset, tset, w, _ = _setups("random600_seed11")
    n = jset.adj.shape[0]
    tile_w = 128 if fmt == "wide16" else 32
    jb = _jax_bin(jset, w, rows, 32, tile_w, 6 * n, tile_capacity=0, chunk=128,
                  y_origin=y0, z_order=z_order, fmt=fmt)
    tb = tbin.bin_triangles(tset, w, rows, 32, 6 * n, 128, fmt=fmt, tile_w=tile_w,
                            z_order=z_order, y_origin=y0)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    names = ["starts", "pair_data", "total_pairs", "max_segment"] + (["chunk_minz"] if z_order
                                                                     else [])
    for name in names:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    full = tbin.bin_triangles(tset, w, 96, 32, 6 * n, 128, fmt=fmt, tile_w=tile_w)
    assert 0 < int(tb.total_pairs) < int(full.total_pairs)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("y0,rows", BANDS)
def test_rasterize_vis_band(case, y0, rows):
    """The brute-force raster's band: equal to the same rows of the port's
    whole screen, and on the first case its ids exact against JAX's band
    (op by op, JAX compiles anew for each shape: seconds each here)."""
    jset, tset, w, h = _setups(case)
    d_t, i_t = txla.rasterize_vis(tset, w, rows, y_origin=y0)
    if case == "random600_seed11":
        d_j, i_j = jxla.rasterize_vis(jset, w, rows, y_origin=y0)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        _depth_eq(d_t.numpy(), d_j)
    d_f, i_f = txla.rasterize_vis(tset, w, h)
    _exact(i_t, i_f[y0:y0 + rows])
    _exact(d_t, d_f[y0:y0 + rows])
    assert (i_t >= 0).any()


def _port_band(kernel, tset, w, rows, y0):
    """(depth, ids) of the port's kernel route (its plain version on the
    CPU) over the band."""
    cap = 8 * tset.adj.shape[0]
    if kernel == "rowblock":
        return tvis.rasterize_vis_tiled(tset, w, rows, tile_capacity=4096, chunk=128,
                                        pair_capacity=cap, y_origin=y0)
    d, i, _ = tv2.rasterize_vis_folded(tset, w, rows, pair_capacity=cap,
                                       hiz=kernel == "hiz", y_origin=y0)
    return d, i


KERNELS = ["folded", "hiz", "rowblock"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("y0,rows", BANDS)
def test_plain_kernel_band_equals_full_pass(kernel, case, y0, rows):
    """K1, K1-hiz and K2's plain versions: a band equals the same rows of
    the whole-screen pass, depth and ids bit for bit."""
    _, tset, w, h = _setups(case)
    d_b, i_b = _port_band(kernel, tset, w, rows, y0)
    d_f, i_f = _port_band(kernel, tset, w, h, 0)
    _exact(i_b, i_f[y0:y0 + rows])
    _exact(d_b, d_f[y0:y0 + rows])
    assert (i_b >= 0).any()


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_kernel_band_matches_jax_interpret(kernel):
    """The band against the JAX kernel's band with the same y_origin, in
    interpret mode: ids exact."""
    jset, tset, w, _ = _setups("random600_seed11")
    y0, rows = BANDS[1]
    cap = 8 * jset.adj.shape[0]
    if kernel == "rowblock":
        d_j, i_j = jvis.rasterize_vis_tiled(jset, w, rows, tile_capacity=4096, chunk=128,
                                            pair_capacity=cap, y_origin=y0)
    else:
        d_j, i_j = jv2.rasterize_vis_folded(jset, w, rows, pair_capacity=cap, y_origin=y0,
                                            hiz=kernel == "hiz")
    d_t, i_t = _port_band(kernel, tset, w, rows, y0)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _depth_eq(d_t.numpy(), d_j)


@pytest.mark.parametrize("y0,rows", BANDS)
def test_hiz_pieces_band_matches_plain(y0, rows):
    """The CPU model of K1-hiz's piece merge takes the origin too."""
    _, tset, w, _ = _setups("random600_seed11")
    bins = tbin.bin_triangles(tset, w, rows, 32, 8 * tset.adj.shape[0], 128, z_order=True,
                              y_origin=y0)
    d_p, i_p = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                        bins.tiles_x, y_origin=y0)
    d_m, i_m, _ = tv2.vis_folded_hiz_pieces(bins.starts, bins.pair_data, bins.chunk_minz,
                                            bins.tiles_x, y_origin=y0)
    _exact(i_m, i_p)
    _exact(d_m, d_p)


# ---------------------------------------------------------------------------
# shading: G-buffer, GI lighting, TAA

JCFG = JaxConfig(width=96, height=64, shadow_map_size=128, lightgrid_size=16,
                 lightgrid_extent=8.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
                 prefilter_samples=64, brdf_lut_size=16, brdf_lut_samples=64,
                 bloom_pass_count=3, light_shaft_steps=4)
# the sharded frame's config: GI and shafts at full resolution
JCFG_SHARDED = JCFG.replace(gi_res_divisor=1, gi_res_divisor_diffuse=1, shaft_res_divisor=1,
                            gi_temporal_div=1)
JCFG_NO_GI = JCFG_SHARDED.replace(enable_gi=False)
SHADE_BANDS = [(0, 32), (32, 32), (16, 32)]   # a 2-way split, and a band across it


def _port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


@functools.cache
def _frame():
    """The inputs of both packages' passes, made by the port (each piece is
    held to the JAX package in test_torch_frame.py, test_torch_raster.py,
    test_torch_gi.py and test_torch_shade.py; op by op, JAX would spend ten
    seconds here): the plane + cube scene at 96x64 (frame 3), its camera,
    frame inputs, triangle setup, raster, sun map, swept lightgrid and IBL
    bakes, and a seed-made previous bloom pyramid."""
    from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
    from vulkan_pbr_renderer_tpu_torch.assets import procedural as tproc
    from vulkan_pbr_renderer_tpu_torch.bake import ibl as tibl
    from vulkan_pbr_renderer_tpu_torch.gpu import sampling as tsamp

    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4),
                         normal=procedural.bump_normal_texture(32), orm_factor=(1, .6, .3)),
            MaterialDesc(base_color_factor=(0.7, 0.2, 0.15, 1.0), orm_factor=(1.0, .35, 0),
                         emissive_factor=(0.5, 0.2, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (14, 14), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    scene = build_scene(parts, mats, texture_size=32)
    tscene = convert.scene_from_numpy({k: np.asarray(v) for k, v in scene._asdict().items()},
                                      device="cpu")
    cfg = _port_cfg(JCFG)
    cam = tr.make_camera((5.0, -6.0, 3.0), (0.0, 0.0, 1.0), cfg, device="cpu")
    state = tr.init_frame_state(cfg, "cpu")
    state.frame_idx = 3
    fi = tr.frame_inputs(state, cam, (40.0, 20.0), cfg)
    s, depth, tri, _ = tr._rasterize(tscene, cam.clip_from_world, 96, 64, cfg,
                                     jitter=fi.jitter)
    depth1 = torch.where(torch.isinf(depth), 1.0, depth)
    _, sd, _, _ = tr._rasterize(tscene, fi.sun_from_world, 128, 128, cfg, cull="none")
    sun_depth = torch.where(torch.isinf(sd), 1.0, sd)
    grid = tgi.decode_voxel_grid(tgi.voxelize_scene(
        tscene, 16, cfg.lightgrid_scale, sun_depth, fi.sun_from_world, fi.sun_dir,
        5.0 * torch.tensor(cfg.sun_color), total_samples=1 << 14))
    for ax in (2, 1, 0):
        grid = tgi.sweep_lightgrid(grid, ax)
    env = torch.from_numpy(tproc.make_sky_cubemap(16))
    raw = tibl.bake_prefiltered_env(tsamp.build_cube_mip_atlas(env), 16, 16, 8, 64).numpy()
    lut = tibl.bake_brdf_lut(16, 64, device="cpu").numpy()
    cam = jr.CameraState(*(jnp.asarray(x.numpy()) for x in cam))
    fi = fi._replace(**{k: jnp.asarray(getattr(fi, k).numpy())
                        for k in ("jitter", "jitter_prev", "sun_from_world", "sun_dir")})
    rng = np.random.default_rng(11)
    _, wa = js.mip_offsets(32, 48, 3)
    prev = rng.uniform(0, 3, (32, wa, 3)).astype(np.float32)
    prev = np.asarray(jnp.asarray(prev).astype(jnp.bfloat16).astype(jnp.float32))
    s = jsetup.TriSetup(*(jnp.asarray(x.numpy()) for x in s))
    return dict(scene=scene, tscene=tscene, cam=cam, fi=fi, s=s, depth1=depth1.numpy(),
                tri=tri.numpy(), sun_depth=sun_depth.numpy(), grid=grid.numpy(), raw=raw,
                lut=lut, prev=prev)


def _gbuffer(port, row_offset, rows, material_filter="stochastic"):
    """G-buffer of the band through the JAX package (op by op, as in
    test_torch_shade.py) or the port."""
    f = _frame()
    cam, fi, s = f["cam"], f["fi"], f["s"]
    band = slice(row_offset, row_offset + rows)
    old = cam.clip_from_world @ jnp.asarray(np.eye(4, dtype=np.float32) + 0.01)
    kw = dict(row_offset=row_offset, material_filter=material_filter, full_size=(64, 96))
    if not port:
        return jgb.gbuffer_pass(f["scene"], s, jnp.asarray(f["depth1"][band]),
                                jnp.asarray(f["tri"][band]), cam.clip_from_world, old, 0.3,
                                world_from_clip=cam.world_from_clip, jitter=fi.jitter,
                                frame_idx_mod_59=jnp.float32(3.0), **kw)
    return tgb.gbuffer_pass(f["tscene"], tsetup.TriSetup(*map(_t, s)), _t(f["depth1"][band]),
                            _t(f["tri"][band]), _t(cam.clip_from_world), _t(old), 0.3,
                            world_from_clip=_t(cam.world_from_clip), jitter=_t(fi.jitter),
                            frame_idx_mod_59=3.0, **kw)


@pytest.mark.parametrize("y0,rows", SHADE_BANDS)
def test_gbuffer_band_matches_jax(y0, rows):
    """Against JAX's band at test_torch_shade.py's tolerances."""
    want = _jax_ref(("gbuffer", y0, rows))
    got = _gbuffer(True, y0, rows)
    assert bool(np.asarray(want.coverage).any())
    np.testing.assert_array_equal(got.coverage.numpy(), np.asarray(want.coverage))
    for name in ("normal", "orm", "emissive", "depth", "velocity", "base_color"):
        tol = 1e-4 if name == "base_color" else 1e-5
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("material_filter", ["stochastic", "nearest", "trilinear"])
@pytest.mark.parametrize("y0,rows", SHADE_BANDS)
def test_gbuffer_band_equals_full_frame(material_filter, y0, rows):
    got = _gbuffer(True, y0, rows, material_filter)
    full = _gbuffer(True, 0, 64, material_filter)
    for name, a in got._asdict().items():
        _exact(a, getattr(full, name)[y0:y0 + rows])


def _globals(port):
    f = _frame()
    cam, fi = f["cam"], f["fi"]
    fields = dict(
        clip_from_world=cam.clip_from_world, clip_from_view=cam.clip_from_view,
        world_from_clip=cam.world_from_clip, view_from_clip=cam.view_from_clip,
        view_from_world=cam.view_from_world, world_from_view=cam.world_from_view,
        sun_from_world=fi.sun_from_world, old_clip_from_world=cam.clip_from_world,
        sun_direction=fi.sun_dir, camera_pos=cam.position, taa_jitter=fi.jitter,
        taa_jitter_prev=fi.jitter_prev)
    if port:
        return tlight.Globals(frame_idx_mod_59=3.0, **{k: _t(v) for k, v in fields.items()})
    return jlight.Globals(frame_idx_mod_59=jnp.float32(3.0), **fields)


def _port_lighting(jcfg, row_offset, rows, full_height):
    """The port's lighting pass of rows [row_offset, row_offset + rows);
    full_height=None is the single-device call."""
    f = _frame()
    gbuf = _gbuffer(True, 0, 64)
    env16, tlut = convert.bakes_from_numpy(f["raw"], f["lut"], device="cpu")
    res = tlight.LightingResources(sun_depth=_t(f["sun_depth"]), prefiltered_env=env16,
                                   brdf_lut=tlut, lightgrid=_t(f["grid"]),
                                   lightgrid_u8=tgi.quantize_grid_u8(_t(f["grid"])),
                                   prev_frame_atlas=_t(f["prev"]).to(torch.bfloat16))
    band = tgb.GBuffer(*(x[row_offset:row_offset + rows] for x in gbuf))
    return band, tlight.lighting_pass(band, _globals(True), res, _port_cfg(jcfg),
                                      row_offset=row_offset, full_height=full_height,
                                      depth_full=gbuf.depth)


def _jax_lighting_band(y0, rows):
    f = _frame()
    gbuf = _gbuffer(True, 0, 64)
    jband = jgb.GBuffer(*(jnp.asarray(x[y0:y0 + rows].numpy()) for x in gbuf))
    jres = jlight.LightingResources(
        sun_depth=jnp.asarray(f["sun_depth"]), lightgrid=jnp.zeros((4, 4, 4, 4)),
        prefiltered_env=js.pack_cube_mip_atlas_window(jnp.asarray(f["raw"]), 16),
        brdf_lut=jnp.asarray(f["lut"]), prev_frame_atlas=None)
    return jlight.lighting_pass(jband, _globals(False), jres, JCFG_NO_GI, row_offset=y0,
                                full_height=64)


@pytest.mark.parametrize("y0,rows", SHADE_BANDS)
def test_lighting_band_matches_jax(y0, rows):
    """A band of the lighting pass (sun, shadows, shafts, IBL and the sky at
    full resolution) against JAX's band at test_torch_shade.py's tolerance
    (GI off: JAX's GI block costs half a minute op by op here; the GI band
    is held to the port's whole frame below)."""
    want = _jax_ref(("lighting", y0, rows))
    _, got = _port_lighting(JCFG_NO_GI, y0, rows, 64)
    assert tuple(got.shape) == (rows, 96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("y0,rows", SHADE_BANDS)
def test_gi_lighting_band_equals_full_frame(y0, rows):
    """With GI on (the screen trace marching depth_full), a band equals the
    same rows of the whole-frame pass bit for bit on every pixel but the
    sky's, which the band computes at full resolution and the whole frame
    at half (lighting.py:305-318)."""
    band, got = _port_lighting(JCFG_SHARDED, y0, rows, 64)
    _, full = _port_lighting(JCFG_SHARDED, 0, 64, None)
    lit = band.coverage & (torch.abs(_port_world(band, y0)) <= JCFG.world_bounds).all(-1)
    assert bool(lit.any())
    _exact(got[lit], full[y0:y0 + rows][lit])


def _port_world(band, y0):
    f = _frame()
    cam = f["cam"]
    return tlight.reconstruct_positions(band.depth, _t(cam.world_from_clip),
                                        _t(cam.view_from_clip), y0, 64)[0]


@pytest.mark.parametrize("catmull,full_rgb", [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("y0,rows", [(0, 8), (8, 8), (16, 8)])
def test_taa_band(catmull, full_rgb, y0, rows):
    """taa_resolve(halo=1) on a band with one edge-clamped halo row each
    side: against JAX's band, and equal to the same rows of the port's
    whole-frame resolve."""
    rng = np.random.default_rng(2)
    h, w = 24, 40
    light = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    vel = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    vel_prev = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    hist = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    halo = np.clip(np.arange(y0 - 1, y0 + rows + 1), 0, h - 1)
    band = [a[halo] for a in (light, depth, vel)] + [vel_prev, hist]
    kw = dict(catmull_history=catmull, full_rgb_catmull=full_rgb)
    band_kw = dict(halo=1, row_offset=y0, full_height=h, **kw)
    got = ttaa.taa_resolve(*map(_t, band), 0.05, 1000.0, **band_kw)
    want = _jax_taa(*map(jnp.asarray, band), 0.05, 1000.0, **band_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    full = ttaa.taa_resolve(*map(_t, (light, depth, vel, vel_prev, hist)), 0.05, 1000.0, **kw)
    _exact(got, full[y0:y0 + rows])


# ---------------------------------------------------------------------------
# voxelize: the sample stream split over shards

VOXEL_SCALE, VOXEL_SUN = 1.0 / 8.0, (40.0, 20.0, 40.0)
VOXEL_EMISSION = 5.0 * np.asarray((1.0, 0.9, 0.7), np.float32)


@functools.cache
def _voxel_inputs():
    mats = [MaterialDesc(base_color=procedural.checker_texture(32, 4), orm_factor=(1, .6, 0)),
            MaterialDesc(base_color_factor=(0.8, 0.2, 0.2, 1.0),
                         emissive_factor=(0.6, 0.3, 0.1))]
    parts = [procedural.make_plane((0, 0, 0), (12, 12), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1),
             procedural.make_uv_sphere((2.5, 1.0, 1.0), 0.8, 8, 16, 1)]
    scene = build_scene(parts, mats, texture_size=32)
    sun_depth = np.random.default_rng(5).uniform(0.3, 1.0, (64, 64)).astype(np.float32)
    tscene = convert.scene_from_numpy({k: np.asarray(v) for k, v in scene._asdict().items()},
                                      device="cpu")
    return scene, tscene, sun_depth


def _jax_voxel_words(shards):
    """JAX's packed words of each shard.  The stream is sized so that every
    shard has the same length at both counts (any size at or above the
    sample count gives the same samples): JAX reuses its per-op
    compilations."""
    scene, _, sun_depth = _voxel_inputs()
    total = jgi.voxelize_sample_capacity(scene, 16, VOXEL_SCALE) * shards // 2
    jm, jd = jshadow.sun_matrices(*VOXEL_SUN)
    return [np.asarray(jgi.voxelize_scene(
        scene, 16, VOXEL_SCALE, jnp.asarray(sun_depth), jm, jd, jnp.asarray(VOXEL_EMISSION),
        total_samples=total, shard_idx=i, shard_count=shards)).astype(np.int64)
        for i in range(shards)]


_REFS, _REF_THREADS = {}, []


def _compute(jobs):
    for key, fn in jobs:
        try:
            _REFS[key] = fn()
        except Exception as e:   # raised again by the test that reads it
            _REFS[key] = e


@pytest.fixture(scope="module", autouse=True)
def _jax_references():
    """JAX's op-by-op references of the G-buffer, lighting and voxelize
    tests, computed in two threads while the raster tests run: op by op,
    JAX spends most of a minute compiling them here, mostly outside the
    GIL.  Their inputs are built first, in this thread."""
    _frame()
    _voxel_inputs()
    jobs = [[(("voxelize", n), functools.partial(_jax_voxel_words, n)) for n in (2, 4)],
            [(("gbuffer", y0, rows), functools.partial(_gbuffer, False, y0, rows))
             for y0, rows in SHADE_BANDS]
            + [(("lighting", y0, rows), functools.partial(_jax_lighting_band, y0, rows))
               for y0, rows in SHADE_BANDS]]
    _REF_THREADS[:] = [threading.Thread(target=_compute, args=(j,)) for j in jobs]
    for t in _REF_THREADS:
        t.start()
    yield
    for t in _REF_THREADS:
        t.join()


def _jax_ref(key):
    for t in _REF_THREADS:
        t.join()
    ref = _REFS[key]
    if isinstance(ref, Exception):
        raise ref
    return ref


@pytest.mark.parametrize("shards", [2, 4])
def test_voxelize_shards_match_jax(shards):
    """Each shard's packed words equal JAX's shard's (JAX op by op, as
    test_torch_gi.py); their max equals the unsharded grid."""
    scene, tscene, sun_depth = _voxel_inputs()
    total = jgi.voxelize_sample_capacity(scene, 16, VOXEL_SCALE) * shards // 2
    tm, td = tshadow.sun_matrices(*VOXEL_SUN)
    whole = tgi.voxelize_scene(tscene, 16, VOXEL_SCALE, _t(sun_depth), tm, td,
                               _t(VOXEL_EMISSION), total_samples=total)
    combined = torch.zeros_like(whole)
    for i, want in enumerate(_jax_ref(("voxelize", shards))):
        got = tgi.voxelize_scene(tscene, 16, VOXEL_SCALE, _t(sun_depth), tm, td,
                                 _t(VOXEL_EMISSION), total_samples=total, shard_idx=i,
                                 shard_count=shards)
        np.testing.assert_array_equal(got.numpy(), want)
        combined = torch.maximum(combined, got)
    assert int((whole != 0).sum()) > 0
    _exact(combined, whole)
