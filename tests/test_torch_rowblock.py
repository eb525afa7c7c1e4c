"""The port's rowblock rasterizer (raster/visibility.py, `fmt="wide16"`
binning) against the JAX package's rasterize_vis_tiled, run in interpret
mode as tests/test_raster_pallas.py runs it, on the same seed-made
triangles.

Tolerances: bins (starts, wide16 rows, overflow counters) and triangle ids
exactly equal, including where a tile's segment overflows tile_capacity;
depth atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.raster import binning as jbin
from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu.raster import visibility as jvis
from vulkan_pbr_renderer_tpu_torch.raster import binning as tbin
from vulkan_pbr_renderer_tpu_torch.raster import setup as tsetup
from vulkan_pbr_renderer_tpu_torch.raster import visibility as tvis


def _random_tris(n, seed, scale=1.0):
    """tests/test_raster_pallas.py::_random_tris, xy scaled by `scale`."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).repeat(3, 1)
    clip = np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)
    clip[:, :, :2] *= scale
    return clip


def _crossing_tris(n, seed):
    """tests/test_raster_pallas.py::test_near_plane_crossing_bbox_conservative."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-2, 2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32).repeat(3, 1)
    w = rng.uniform(-0.5, 1.5, (n, 3, 1)).astype(np.float32)
    return np.concatenate([verts * np.abs(w), z * np.abs(w), w], -1)


def _setups(clip, w, h):
    """The JAX triangle setup and the same arrays as the port's TriSetup
    (raster setup itself is held to the JAX package in test_torch_raster.py;
    here both rasterizers read identical coefficients)."""
    js = jsetup.setup_triangles(jnp.asarray(clip), w, h, cull="none")
    return js, tsetup.TriSetup(*(torch.from_numpy(np.asarray(x)) for x in js))


# (name, clip, w, h, tile_capacity, chunk): test_raster_pallas.py's cases,
# among them the overflowing one of test_overflow_counters_surface_dropped_
# triangles (5 triangles in one tile, capacity 4, chunk 4) and a 300-triangle
# set whose deepest segment (80) exceeds a capacity of 64
CASES = [
    ("random300_seed1", _random_tris(300, 1), 256, 160, 512, 128),
    ("random8_seed2_big", _random_tris(8, 2, 3.0), 384, 160, 256, 128),
    ("crossing40_seed21", _crossing_tris(40, 21), 160, 96, 256, 128),
    ("overflow5_seed7", _random_tris(5, 7, 0.1), 128, 32, 4, 4),
    ("overflow300_seed1", _random_tris(300, 1), 256, 160, 64, 16),
]


@pytest.mark.parametrize("name,clip,w,h,cap,chunk", CASES, ids=[c[0] for c in CASES])
def test_rasterize_vis_tiled_matches_jax_kernel(name, clip, w, h, cap, chunk):
    js, ts = _setups(clip, w, h)
    d_j, t_j, o_j = jvis.rasterize_vis_tiled(js, w, h, tile_capacity=cap, chunk=chunk,
                                             return_overflow=True)
    d_t, t_t, o_t = tvis.rasterize_vis_tiled(ts, w, h, tile_capacity=cap, chunk=chunk,
                                             return_overflow=True)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    d_j, d_t = np.asarray(d_j), d_t.numpy()
    np.testing.assert_array_equal(np.isinf(d_t), np.isinf(d_j))
    fin = np.isfinite(d_j)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=0, atol=1e-6)
    if name.startswith("overflow"):
        assert int(o_t[0]) > cap      # the capacity cut is in force


@pytest.mark.parametrize("name,clip,w,h,cap,chunk", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_bin_triangles_wide16_matches_jax(name, clip, w, h, cap, chunk):
    js, ts = _setups(clip, w, h)
    n = clip.shape[0]
    jb = jbin.bin_triangles(js, w, h, 32, 128, 6 * n, tile_capacity=cap, chunk=chunk)
    tb = tbin.bin_triangles(ts, w, h, 32, 6 * n, chunk, fmt="wide16", tile_w=128)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    np.testing.assert_array_equal(tb.starts.numpy(), np.asarray(jb.starts))
    np.testing.assert_array_equal(tb.pair_data.numpy(), np.asarray(jb.pair_data))
    assert int(tb.max_segment) == int(jb.max_segment)
    assert int(tb.total_pairs) == int(jb.total_pairs)


def test_vis_rowblock_plain_tile_subset():
    _, ts = _setups(_random_tris(300, 1), 256, 160)
    bins = tbin.bin_triangles(ts, 256, 160, 32, 1800, 16, fmt="wide16", tile_w=128)
    d_all, i_all = tvis.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x, 64, 16)
    tiles = torch.tensor([7, 0, 3])
    d_sub, i_sub = tvis.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x, 64, 16,
                                           tiles=tiles)
    torch.testing.assert_close(i_sub, i_all[tiles], rtol=0, atol=0)
    torch.testing.assert_close(d_sub, d_all[tiles], rtol=0, atol=0)


def test_vis_rowblock_cpu_takes_plain_version():
    _, ts = _setups(_random_tris(60, 3), 256, 96)
    bins = tbin.bin_triangles(ts, 256, 96, 32, 600, 128, fmt="wide16", tile_w=128)
    before = tvis.vis_rowblock_tiles.launches
    d, i = tvis.vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x, 4096, 128)
    assert tvis.vis_rowblock_tiles.launches == before
    d_p, i_p = tvis.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x, 4096, 128)
    torch.testing.assert_close(i, i_p, rtol=0, atol=0)
    assert int((i >= 0).sum()) > 0


def test_rasterize_vis_tiled_rejects_other_tiles():
    _, ts = _setups(_random_tris(10, 4), 128, 64)
    with pytest.raises(ValueError, match="32x128"):
        tvis.rasterize_vis_tiled(ts, 128, 64, tile_h=16)
