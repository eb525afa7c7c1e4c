"""The port's binning (raster/binning.py) on the edge cases where a direct
pair expansion can differ from the scatter + cummax fill: its plain version
bin_triangles_plain against the JAX package's bin_triangles, every field
exactly equal (starts, pair_data, total_pairs, max_segment, chunk_minz).
The sets where the kernels' counting sort could differ are here too: a tile
run longer than their short sort takes, and z_order sets whose triangles
all share one zq.  The kernels of csrc/binning.cu run only on the
card; test_torch_cuda.py and chip_smoke.py hold them against the plain
version there bit for bit.  Here
bin_triangles takes the plain version because the tensors lie on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.raster import binning as jbin
from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu_torch.raster import binning as tbin
from vulkan_pbr_renderer_tpu_torch.raster import setup as tsetup

# compiled once per static shape: op by op JAX's binning costs seconds here
_jax_bin = jax.jit(jbin.bin_triangles, static_argnums=(1, 2, 3, 4, 5),
                   static_argnames=("tile_capacity", "chunk", "y_origin", "z_order", "fmt"))


def _random_tris(n, seed, spread=1.0, size=0.4, flat_z=False):
    """tests/test_raster_pallas.py::_random_tris, centres within +-spread,
    vertices within +-size of them, depth varying over each triangle (so zq
    differs between triangles), or with flat_z every vertex at depth 0.5
    (every triangle's zq equal)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-spread, spread, (n, 1, 2))
    verts = center + rng.uniform(-size, size, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    if flat_z:
        z = np.full_like(z, 0.5)
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


@functools.cache
def _setups(n, seed, w, h, spread=1.0, size=0.4, flat_z=False):
    clip = _random_tris(n, seed, spread, size, flat_z)
    js = jsetup.setup_triangles(jnp.asarray(clip), w, h, cull="none")
    return js, tsetup.TriSetup(*(torch.from_numpy(np.array(x)) for x in js))


def _no_valid(js, ts):
    return (js._replace(valid=jnp.zeros_like(js.valid)),
            ts._replace(valid=torch.zeros_like(ts.valid)))


def _compare(js, ts, w, h, cap, chunk=128, fmt="slim13", tile_w=32, z_order=False, y0=0):
    """Both packages' bins of the same setup, every field exactly equal;
    returns the port's bins."""
    jb = _jax_bin(js, w, h, 32, tile_w, cap, tile_capacity=0, chunk=chunk, y_origin=y0,
                  z_order=z_order, fmt=fmt)
    tb = tbin.bin_triangles_plain(ts, w, h, 32, cap, chunk, fmt=fmt, tile_w=tile_w,
                                  z_order=z_order, y_origin=y0)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    for name in ("starts", "pair_data", "total_pairs", "max_segment", "chunk_minz"):
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    return tb


# the z_order sets (_setups' arguments): random depths; one depth for every
# triangle (each tile's order then falls to the triangle id); 6,000 small
# triangles over one tile, whose cut run is still longer than the kernels'
# short sort takes
Z_SETS = {"random": (300, 1, 256, 160), "equal_zq": (300, 1, 256, 160, 1.0, 0.4, True),
          "long_segment": (6000, 13, 32, 32, 0.9, 0.02)}


@pytest.mark.parametrize("cap_factor,zset", [
    pytest.param(1, "random", id="1"), pytest.param(0.25, "random", id="0.25"),
    pytest.param(1, "equal_zq", id="equal_zq-1"),
    pytest.param(0.25, "equal_zq", id="equal_zq-0.25"),
    pytest.param(0.25, "long_segment", id="long_segment-0.25")])
def test_z_order_overflow(cap_factor, zset):
    """z_order with a pair buffer smaller than the pairs: a run cut at the
    buffer's end and no dead rows."""
    js, ts = _setups(*Z_SETS[zset])
    n, w, h = js.adj.shape[0], Z_SETS[zset][2], Z_SETS[zset][3]
    tb = _compare(js, ts, w, h, int(cap_factor * n), z_order=True)
    assert int(tb.total_pairs) > tb.pair_data.shape[0] * tb.pair_data.shape[1]
    if zset == "equal_zq":
        assert len(np.unique(tb.chunk_minz.numpy())) == 1
    if zset == "long_segment":
        assert tbin.long_path_tiles(tb) == 1


@pytest.mark.parametrize("fmt,tile_w,z_order", [("slim13", 32, False), ("slim13", 32, True),
                                                ("wide16", 128, False)])
def test_long_segment(fmt, tile_w, z_order):
    """6,000 small triangles over one tile: a run longer than the kernels'
    short sort takes (binning.SORT_KEYS), with dead rows after it."""
    js, ts = _setups(6000, 13, tile_w, 32, spread=0.9, size=0.02)
    tb = _compare(js, ts, tile_w, 32, 8000, fmt=fmt, tile_w=tile_w, z_order=z_order)
    assert int(tb.max_segment) == int(tb.total_pairs) > tbin.SORT_KEYS
    assert tbin.long_path_tiles(tb) == 1


def test_z_order_short_run_dead_tail():
    """z_order with a few live rows and whole dead chunks after them: the
    dead rows carry the last triangle's zq into chunk_minz."""
    js, ts = _setups(12, 7, 128, 96, spread=0.5)
    tb = _compare(js, ts, 128, 96, 64 * 12, chunk=16, z_order=True)
    rows = tb.pair_data.shape[0] * tb.pair_data.shape[1]
    assert 0 < int(tb.total_pairs) < rows - 2 * 16
    assert len(np.unique(tb.chunk_minz.numpy())) > 1


@pytest.mark.parametrize("z_order", [False, True])
def test_no_valid_triangle(z_order):
    """No triangle is valid: no pair, every row dead, and under z_order every
    chunk_minz is zq_max / zq_max."""
    js, ts = _no_valid(*_setups(50, 3, 128, 96))
    tb = _compare(js, ts, 128, 96, 400, chunk=16, z_order=z_order)
    assert int(tb.total_pairs) == 0 and int(tb.max_segment) == 0
    assert (tb.chunk_minz.numpy() == (1.0 if z_order else 0.0)).all()


@pytest.mark.parametrize("fmt,tile_w,z_order", [("slim13", 32, True), ("wide16", 128, False)])
def test_band_without_triangles(fmt, tile_w, z_order):
    """A y_origin band below every triangle's bbox: no pair."""
    js, ts = _setups(40, 5, 128, 96, spread=0.3)
    tb = _compare(js, ts, 128, 32, 8 * 40, fmt=fmt, tile_w=tile_w, z_order=z_order, y0=96)
    assert int(tb.total_pairs) == 0


def test_wide16_sparse_large_grid():
    """wide16 on 32x128 tiles of a 2048^2 grid (1,024 tiles), few triangles:
    most tiles empty, starts equal across the empty runs."""
    js, ts = _setups(30, 9, 2048, 2048, spread=0.9, size=0.05)
    tb = _compare(js, ts, 2048, 2048, 8 * 30, chunk=128, fmt="wide16", tile_w=128)
    assert tb.starts.shape[0] == 1024 + 1
    seg = np.diff(tb.starts.numpy())
    assert (seg == 0).sum() > 900 and int(tb.total_pairs) > 0


def test_cpu_tensor_takes_plain_version():
    """On a CPU tensor bin_triangles is the plain version (no kernel launch
    counted); an unknown format raises."""
    _, ts = _setups(60, 2, 128, 96)
    before = tbin.bin_triangles.launches
    got = tbin.bin_triangles(ts, 128, 96, 32, 480, 128, z_order=True)
    want = tbin.bin_triangles_plain(ts, 128, 96, 32, 480, 128, z_order=True)
    assert tbin.bin_triangles.launches == before == 0
    for name in ("starts", "pair_data", "total_pairs", "max_segment", "chunk_minz"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with pytest.raises(ValueError, match="unknown binning fmt"):
        tbin.bin_triangles(ts, 128, 96, 32, 480, 128, fmt="wide13")
