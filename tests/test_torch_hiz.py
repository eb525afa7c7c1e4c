"""K1's hierarchical-z variant in the port against the JAX package: z-order
binning (binning.py:222-243), the plain version of the hiz kernel
(`vis_folded_hiz_plain`) and `rasterize_vis_folded(hiz=True)` against the
JAX folded kernel with hiz=True in interpret mode and the JAX brute force.

Tolerances: bins (starts, pair_data, chunk_minz, max_segment, total_pairs)
and ids exactly equal; depth atol 1e-6 (test_raster_pallas.py:97).  The
kernel itself is held against its plain version on the card in
test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer_tpu.raster import binning as jbin
from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu.raster import visibility_v2 as jv2
from vulkan_pbr_renderer_tpu.raster import xla_raster as jxla
from vulkan_pbr_renderer_tpu.utils import math3d as jm3
from vulkan_pbr_renderer_tpu_torch.raster import binning as tbin
from vulkan_pbr_renderer_tpu_torch.raster import setup as tsetup
from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as tv2


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


def _dup_tris(n, seed, copies=3):
    """n random triangles, each `copies` times under shuffled ids: exact
    depth ties between triangles of equal zq."""
    base = _random_tris(n, seed)
    perm = np.random.default_rng(seed + 1).permutation(n * copies)
    return np.concatenate([base] * copies)[perm]


def _stack_tris(n, seed):
    """n screen-covering triangles at random depths, some tilted: every tile's
    segment runs several blocks and the first block already covers the
    tile, so the walk exits early."""
    rng = np.random.default_rng(seed)
    verts = np.array([(-3.0, -3.0), (5.0, -3.0), (-3.0, 5.0)]) + rng.uniform(-0.2, 0.2, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


def _tri(xy, z):
    xy = np.asarray(xy, np.float32)
    return np.concatenate([xy, np.asarray(z, np.float32)[:, None],
                           np.ones((3, 1), np.float32)], -1)


def _slot_tie_tris():
    """One 32x32 tile where the JAX kernel's per-slot tie rule differs from
    "smallest id": A (id 128) under the whole tile and B (id 0) inside it lie
    on the plane z = 0.5 + x/8 with dyadic vertices, so their depths tie
    exactly; A's nearer vertex sorts it first, 127 small constant-depth
    triangles with zq between theirs put B 128 rows later, in A's slot,
    where the first processed row (A) keeps the tie."""
    def plane(xy):
        return 0.5 + 0.125 * np.asarray(xy, np.float32)[:, 0]

    a_xy = [(-1.25, -1.25), (3.0, -1.25), (-1.25, 3.0)]
    b_xy = [(-0.5, -0.5), (0.75, -0.5), (-0.5, 0.75)]
    fill = []
    for k in range(127):
        x0, y0 = 0.75 + 0.0625 * (k % 4), 0.75 + 0.0625 * (k // 4 % 4)
        fill.append(_tri([(x0, y0), (x0 + 0.0625, y0), (x0, y0 + 0.0625)],
                         np.full(3, 0.36 + 0.0005 * k)))
    return np.stack([_tri(b_xy, plane(b_xy))] + fill + [_tri(a_xy, plane(a_xy))])


# name -> (clip-space triangles, width, height, pair capacity factor)
CASES = {
    "random600_seed11": (lambda: _random_tris(600, 11), 128, 96, 4),
    "crossing40_seed21": (lambda: _crossing_tris(40, 21), 160, 96, 8),
    "random300_seed1": (lambda: _random_tris(300, 1), 256, 160, 8),
    "dup200x3_seed7": (lambda: _dup_tris(200, 7), 128, 96, 8),
    "slot_ties": (_slot_tie_tris, 32, 32, 4),
    "stack600_seed5": (lambda: _stack_tris(600, 5), 64, 64, 4),
    # every triangle right of the screen: no pair at all, chunk_minz all 1
    "offscreen50_seed2": (lambda: _random_tris(50, 2) + np.float32([5, 0, 0, 0]), 64, 64, 4),
}


@functools.cache
def _scene_clip():
    """test_scene_raster_through_pipeline's scene and camera, clip space."""
    parts = [procedural.make_plane((0, 0, 0), (10, 10), 2, 0),
             procedural.make_cube((0, 0, 1), (1.5, 1.5, 1.5), 0),
             procedural.make_uv_sphere((2, 1, 1), 0.8, 8, 16, 0)]
    scene = build_scene(parts, [MaterialDesc()], texture_size=16)
    cam = jm3.perspective_lh_zo(np.deg2rad(60.0), 1.5, 0.1, 100.0) @ jm3.look_at(
        jnp.array([4.0, -5.0, 3.0]), jnp.array([0.0, 0.0, 0.5]))
    clip = jsetup.transform_to_clip(scene.positions, cam)
    return np.asarray(clip[scene.indices])


@functools.cache
def _jax_setup(case):
    if case == "scene_camera":
        return jsetup.setup_triangles(jnp.asarray(_scene_clip()), 192, 128, cull="back"), \
            192, 128, 4
    make, w, h, capf = CASES[case]
    return jsetup.setup_triangles(jnp.asarray(make()), w, h, cull="none"), w, h, capf


@functools.cache
def _jax_hiz(case):
    js, w, h, capf = _jax_setup(case)
    d, t = jv2.rasterize_vis_folded(js, w, h, pair_capacity=capf * js.adj.shape[0], hiz=True)
    return np.asarray(d), np.asarray(t)


def _to_torch_setup(s):
    return tsetup.TriSetup(*(torch.from_numpy(np.array(x)) for x in s))


def _depth_eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    np.testing.assert_allclose(np.where(np.isinf(a), -1, a), np.where(np.isinf(b), -1, b),
                               atol=1e-6, rtol=0)


# the JAX binning under jit: one compile per case instead of one per op
_jax_bin = jax.jit(jbin.bin_triangles, static_argnums=(1, 2, 3, 4, 5),
                   static_argnames=("tile_capacity", "chunk", "z_order", "fmt"))


def _bins_equal(tb, jb):
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    for name in ("starts", "pair_data", "chunk_minz", "max_segment", "total_pairs"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


ALL_CASES = list(CASES) + ["scene_camera"]


@pytest.mark.parametrize("case,cap_factor", [(c, None) for c in ALL_CASES]
                         + [("random600_seed11", 1), ("crossing40_seed21", 1)])
def test_bin_z_order_matches_jax(case, cap_factor):
    """z-order TileBins bit-equal to JAX, also with a pair buffer of one
    pair per triangle (dropped pairs, no dead tail rows)."""
    js, w, h, capf = _jax_setup(case)
    cap = (cap_factor or capf) * js.adj.shape[0]
    jb = _jax_bin(js, w, h, 32, 32, cap, tile_capacity=0, chunk=128, z_order=True,
                  fmt="slim13")
    tb = tbin.bin_triangles(_to_torch_setup(js), w, h, 32, cap, 128, z_order=True)
    _bins_equal(tb, jb)
    zq = tb.chunk_minz.numpy()
    assert (zq >= 0).all() and (zq <= 1).all()


def test_bin_z_order_many_triangles_matches_jax():
    """More than 2^18 triangles: tri_bits 19, so zq has 11 bits, not 12."""
    rng = np.random.default_rng(3)
    n = (1 << 18) + 4321
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.03, 0.03, (n, 3, 2))
    z = rng.uniform(0.05, 0.95, (n, 3, 1))
    clip = np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)
    js = jsetup.setup_triangles(jnp.asarray(clip), 64, 64, cull="none")
    jb = _jax_bin(js, 64, 64, 32, 32, 2 * n, tile_capacity=0, chunk=128, z_order=True,
                  fmt="slim13")
    tb = tbin.bin_triangles(_to_torch_setup(js), 64, 64, 32, 2 * n, 128, z_order=True)
    _bins_equal(tb, jb)
    # 11-bit quantization: every bound is a multiple of 1/2047
    zq = np.round(tb.chunk_minz.numpy() * 2047.0)
    np.testing.assert_allclose(zq / 2047.0, tb.chunk_minz.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", ["random600_seed11", "dup200x3_seed7", "slot_ties",
                                  "stack600_seed5", "scene_camera"])
def test_vis_folded_hiz_plain_matches_jax(case):
    js, w, h, capf = _jax_setup(case)
    bins = tbin.bin_triangles(_to_torch_setup(js), w, h, 32, capf * js.adj.shape[0], 128,
                              z_order=True)
    d_t, i_t = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                        bins.tiles_x)
    d_j, i_j = _jax_hiz(case)
    unfold = functools.partial(tv2.unfold_tiles, tiles_y=bins.tiles_y, tiles_x=bins.tiles_x,
                               height=h, width=w)
    np.testing.assert_array_equal(unfold(i_t).numpy(), i_j)
    _depth_eq(unfold(d_t).numpy(), d_j)
    assert (i_j >= 0).sum() > 0


@pytest.mark.parametrize("case", ALL_CASES)
def test_rasterize_vis_folded_hiz_matches_brute_force_where_jax_does(case):
    """The port's hiz ids equal the JAX hiz ids, so they equal the brute
    force exactly where the JAX ones do.  Only the slot-tie case differs
    from the brute force: there the first processed of two tied rows in
    one slot wins, as in the JAX kernel."""
    js, w, h, capf = _jax_setup(case)
    d_got, t_got, ovf = tv2.rasterize_vis_folded(_to_torch_setup(js), w, h,
                                                 pair_capacity=capf * js.adj.shape[0],
                                                 hiz=True)
    d_j, t_j = _jax_hiz(case)
    d_x, t_x = (np.asarray(a) for a in jxla.rasterize_vis(js, w, h))
    t_got = t_got.numpy()
    np.testing.assert_array_equal(t_got, t_j)
    agree = t_j == t_x
    np.testing.assert_array_equal(t_got[agree], t_x[agree])
    _depth_eq(d_got.numpy(), d_j)
    _depth_eq(d_got.numpy(), d_x)
    assert int(ovf[0]) == 0
    if case == "slot_ties":
        assert (~agree).sum() > 100          # B's pixels keep A's id
    else:
        assert agree.all()
    if case == "offscreen50_seed2":
        assert (t_got == -1).all()


def test_hiz_early_exit_is_exact():
    """On the stacked set the walk stops early and the result equals the
    full walk's (bounds of 0 never stop it).  The deepest tile's last block
    is overwritten with a screen-covering row at depth 0.001: the full walk
    picks it up, the early-exit walk never reads it."""
    js, w, h, capf = _jax_setup("stack600_seed5")
    bins = tbin.bin_triangles(_to_torch_setup(js), w, h, 32, capf * js.adj.shape[0], 128,
                              z_order=True)
    no_exit = torch.zeros_like(bins.chunk_minz)
    d_e, i_e = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                        bins.tiles_x)
    d_f, i_f = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, no_exit, bins.tiles_x)
    np.testing.assert_array_equal(i_e.numpy(), i_f.numpy())
    np.testing.assert_array_equal(d_e.numpy(), d_f.numpy())

    starts = bins.starts.numpy().astype(np.int64)
    t = int(np.argmax(np.diff(starts)))
    lo, hi = starts[t], starts[t + 1]
    assert (hi - 1) // 128 > lo // 128 + 2  # the segment spans four blocks
    rows = bins.pair_data.reshape(-1, 13).clone()
    poison = torch.tensor([0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.001, -10000.0])
    rows[max(lo, (hi - 1) // 128 * 128):hi] = poison
    poisoned = rows.reshape(bins.pair_data.shape)
    tile = torch.tensor([t])
    _, i_p = tv2.vis_folded_hiz_plain(bins.starts, poisoned, bins.chunk_minz, bins.tiles_x,
                                      tiles=tile)
    np.testing.assert_array_equal(i_p.numpy(), i_e[tile].numpy())
    _, i_pf = tv2.vis_folded_hiz_plain(bins.starts, poisoned, no_exit, bins.tiles_x,
                                       tiles=tile)
    assert (i_pf.numpy() == 9999).all()


def test_hiz_rows_walked():
    """rows_walked counts the segment rows each tile evaluates: all of them
    without an exit, fewer on the stacked set's deep tiles with it, and the
    same result either way."""
    js, w, h, capf = _jax_setup("stack600_seed5")
    bins = tbin.bin_triangles(_to_torch_setup(js), w, h, 32, capf * js.adj.shape[0], 128,
                              z_order=True)
    seg = (bins.starts[1:] - bins.starts[:-1]).to(torch.int64)
    d_e, i_e = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                        bins.tiles_x)
    d_w, i_w, walked = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                                bins.tiles_x, group=3, rows_walked=True)
    np.testing.assert_array_equal(i_w.numpy(), i_e.numpy())
    np.testing.assert_array_equal(d_w.numpy(), d_e.numpy())
    assert bool((walked <= seg).all()) and int(walked.sum()) < int(seg.sum())
    _, _, full = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data,
                                          torch.zeros_like(bins.chunk_minz), bins.tiles_x,
                                          rows_walked=True)
    np.testing.assert_array_equal(full.numpy(), seg.numpy())


def test_vis_folded_hiz_plain_tile_subset():
    js, w, h, capf = _jax_setup("dup200x3_seed7")
    bins = tbin.bin_triangles(_to_torch_setup(js), w, h, 32, capf * js.adj.shape[0], 128,
                              z_order=True)
    d_all, i_all = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                            bins.tiles_x)
    tiles = torch.tensor([7, 0, 3, 11])
    d_sub, i_sub = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                            bins.tiles_x, tiles=tiles, group=3)
    np.testing.assert_array_equal(i_sub.numpy(), i_all[tiles].numpy())
    np.testing.assert_array_equal(d_sub.numpy(), d_all[tiles].numpy())


def test_vis_folded_hiz_cpu_takes_plain_version():
    js, w, h, capf = _jax_setup("random300_seed1")
    before = (tv2.vis_folded_hiz_tiles.launches, tv2.vis_folded_tiles.launches)
    tv2.rasterize_vis_folded(_to_torch_setup(js), w, h, hiz=True)
    assert (tv2.vis_folded_hiz_tiles.launches, tv2.vis_folded_tiles.launches) == before
