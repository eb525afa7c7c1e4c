"""K2's work list (visibility.rowblock_work_list over
visibility_v2.segment_work_list), which cuts each 32x128 tile's
capacity-cut pair range into pieces of at most `piece_rows` rows, one CUDA
block each.

Checked on the CPU: every capacity-cut range [starts[t], min(starts[t+1],
(starts[t] // chunk + capacity // chunk) * chunk)) is covered exactly once,
in order, by pieces of at most piece_rows rows (an empty or fully cut tile by
one empty piece), the surplus entries after the last piece are
(-1, 0, 0, 0), and the static length (work_list_length) holds every piece —
on hand-made segments where the cut falls inside a piece and on the bins of
test_torch_rowblock.py's cases, among them two where the cut is in force.
Then the pieces, each brute-forced on its own and merged by the minimum
(depth bits, pair index) key as the kernel merges them, give exactly
vis_rowblock_plain's depth and ids, and ids equal to the JAX
rasterize_vis_tiled run in interpret mode; on a one-tile set of duplicated
triangles whose exact ties fall in different pieces the earlier pair wins.
The kernel itself is held against the plain version on the card
(test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu.raster import visibility as jvis
from vulkan_pbr_renderer_tpu_torch.raster import binning, visibility, visibility_v2, xla_raster
from vulkan_pbr_renderer_tpu_torch.raster.binning import NCOL_WIDE
from vulkan_pbr_renderer_tpu_torch.raster.setup import TriSetup


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


def _stack_tris(n, seed):
    """Screen-covering triangles at random depths (chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    verts = np.array([(-3.0, -3.0), (5.0, -3.0), (-3.0, 5.0)]) + rng.uniform(-0.2, 0.2, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


# test_torch_rowblock.py's cases: name -> (triangles, w, h, tile_capacity, chunk);
# the two "overflow" ones have segments deeper than tile_capacity
CASES = {
    "random300_seed1": (lambda: _random_tris(300, 1), 256, 160, 512, 128),
    "random8_seed2_big": (lambda: _random_tris(8, 2, 3.0), 384, 160, 256, 128),
    "crossing40_seed21": (lambda: _crossing_tris(40, 21), 160, 96, 256, 128),
    "overflow5_seed7": (lambda: _random_tris(5, 7, 0.1), 128, 32, 4, 4),
    "overflow300_seed1": (lambda: _random_tris(300, 1), 256, 160, 64, 16),
}


def _cut_ranges(starts, cap, chunk):
    """The capacity rule written out (visibility.py:58-61 of the JAX package)."""
    starts = np.asarray(starts, np.int64)
    lo = starts[:-1]
    hi = np.minimum(starts[1:], (lo // chunk + cap // chunk) * chunk)
    return lo, np.maximum(hi, lo)


def _check_work_list(starts, cap, chunk, piece_rows, n_items):
    """The list covers each capacity-cut range exactly once; returns the
    live items."""
    starts = np.asarray(starts, np.int64)
    items = visibility.rowblock_work_list(torch.as_tensor(starts, dtype=torch.int32), cap,
                                          chunk, piece_rows, n_items)
    assert items.dtype == torch.int32 and tuple(items.shape) == (n_items, 4)
    items = items.numpy().astype(np.int64)
    lo, hi = _cut_ranges(starts, cap, chunk)
    live = items[:, 0] >= 0
    n_live = int(live.sum())
    assert live[:n_live].all(), "surplus entries must follow every live one"
    assert (items[n_live:] == [-1, 0, 0, 0]).all()
    assert (np.diff(items[:n_live, 0]) >= 0).all(), "tiles in order"
    for t in range(starts.shape[0] - 1):
        mine = items[:n_live][items[:n_live, 0] == t]
        seg = hi[t] - lo[t]
        want = max(1, -(-seg // piece_rows))
        assert mine.shape[0] == want, (t, mine, seg)
        assert (mine[:, 3] == want).all()
        assert mine[0, 1] == lo[t] and mine[-1, 2] == hi[t]
        assert (mine[1:, 1] == mine[:-1, 2]).all(), "pieces are contiguous"
        size = mine[:, 2] - mine[:, 1]
        assert (size <= piece_rows).all()
        assert (size > 0).all() or (seg == 0 and (size == 0).all())
    return items[:n_live]


@pytest.mark.parametrize("piece_rows", [16, 128])
@pytest.mark.parametrize("lens,cap,chunk", [
    ([300, 0, 37, 129, 5], 64, 16),     # tiles 0 and 3 cut to 64 and 63 rows
    ([7, 9, 2, 40], 4, 4),              # every tile cut to one chunk or less
    ([20, 0, 33], 0, 16),               # capacity 0: every tile cut to nothing
    ([500, 3, 0, 257], 4096, 128),      # no cut: the whole segments
])
def test_work_list_covers_cut_ranges(piece_rows, lens, cap, chunk):
    starts = np.concatenate([[0], np.cumsum(lens)])
    n_items = len(lens) + int(starts[-1]) // piece_rows
    live = _check_work_list(starts, cap, chunk, piece_rows, n_items)
    lo, hi = _cut_ranges(starts, cap, chunk)
    assert live.shape[0] == sum(max(1, -(-int(n) // piece_rows)) for n in hi - lo)
    if (hi - lo == np.diff(starts)).all():   # no cut: the list K1's builder gives
        np.testing.assert_array_equal(
            visibility_v2.folded_work_list(torch.as_tensor(starts, dtype=torch.int32),
                                           piece_rows, n_items).numpy()[:live.shape[0]], live)
    # a longer list only adds surplus entries
    assert _check_work_list(starts, cap, chunk, piece_rows, n_items + 5).shape == live.shape


def test_work_list_cut_inside_a_piece():
    """A segment of 300 rows from row 0 with capacity 64, chunk 16 and
    pieces of 48 rows: the cut at row 64 ends the second piece after 16."""
    starts = torch.tensor([0, 300, 310], dtype=torch.int32)
    items = visibility.rowblock_work_list(starts, 64, 16, 48, 2 + 310 // 48).numpy()
    # tile 1 starts at 300 (block 18): its cut is (18 + 4) * 16 = 352 > 310
    np.testing.assert_array_equal(items[:3], [[0, 0, 48, 2], [0, 48, 64, 2],
                                              [1, 300, 310, 1]])
    assert (items[3:] == [-1, 0, 0, 0]).all()


def _setups(clip, w, h):
    """The JAX triangle setup and the same arrays as the port's TriSetup
    (test_torch_rowblock.py's)."""
    js = jsetup.setup_triangles(jnp.asarray(clip), w, h, cull="none")
    return js, TriSetup(*(torch.from_numpy(np.array(x)) for x in js))


@functools.cache
def _case(name):
    """(bins, JAX ids [h, w]) of a case; the JAX kernel runs in interpret
    mode."""
    make, w, h, cap, chunk = CASES[name]
    clip = make()
    js, ts = _setups(clip, w, h)
    bins = binning.bin_triangles(ts, w, h, 32, 6 * clip.shape[0], chunk, fmt="wide16",
                                 tile_w=128)
    _, t_j = jvis.rasterize_vis_tiled(js, w, h, tile_capacity=cap, chunk=chunk)
    return bins, np.asarray(t_j)


def _merged_pieces(bins, cap, chunk, piece_rows):
    """The kernel's arithmetic on the CPU: each piece of the work list
    brute-forced over its own rows on its bbox row blocks, merged by the
    minimum (depth, pair index) key; the id is the winning row's column 12."""
    n_tiles = bins.starts.shape[0] - 1
    items = visibility.rowblock_work_list(
        bins.starts, cap, chunk, piece_rows,
        visibility_v2.work_list_length(n_tiles, bins.pair_data, piece_rows))
    rows_all = bins.pair_data.reshape(-1, NCOL_WIDE)
    q = torch.arange(visibility.PIX)
    qx, qy = q % visibility.TILE_W, q // visibility.TILE_W
    best = torch.full((n_tiles, visibility.PIX), xla_raster.INT64_MAX, dtype=torch.int64)
    for t, lo, hi, _ in items.tolist():
        if t < 0 or hi == lo:
            continue
        rows = rows_all[lo:hi]
        y0 = float((t // bins.tiles_x) * visibility.TILE_H)
        px = ((t % bins.tiles_x) * visibility.TILE_W + qx).to(torch.float32) + 0.5
        py = y0 + (qy.to(torch.float32) + 0.5)
        z = xla_raster.depth_at(rows, px, py, vert=rows[:, 15:16] > 0.5)
        rb0 = torch.clamp(torch.floor((rows[:, 13] - y0) / 8), min=0)
        rb1 = torch.clamp(torch.floor((rows[:, 14] - 1.0 - y0) / 8), max=3)
        blk = (qy // 8)[None, :]
        z = torch.where((blk < rb0[:, None]) | (blk > rb1[:, None]), float("inf"), z)
        key = xla_raster.depth_id_key(z, torch.arange(lo, hi)[:, None])
        best[t] = torch.minimum(best[t], key.amin(0))
    empty = best == xla_raster.INT64_MAX
    depth = torch.where(empty, float("inf"), (best >> 32).to(torch.int32).view(torch.float32))
    ids = rows_all[torch.where(empty, 0, best & 0xFFFFFFFF), 12].to(torch.int32)
    return items, depth, torch.where(empty, -1, ids)


@pytest.mark.parametrize("name", list(CASES))
def test_work_list_on_bins(name):
    bins, _ = _case(name)
    _, _, _, cap, chunk = CASES[name]
    n_tiles = bins.starts.shape[0] - 1
    cap_rows = bins.pair_data.numel() // NCOL_WIDE
    for piece_rows in (16, 128):
        n_items = visibility_v2.work_list_length(n_tiles, bins.pair_data, piece_rows)
        assert n_items == n_tiles + cap_rows // piece_rows
        _check_work_list(bins.starts.numpy(), cap, chunk, piece_rows, n_items)
    if name.startswith("overflow"):
        assert int(bins.max_segment) > cap   # the capacity cut is in force


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("piece_rows", [16, 128])
def test_merged_pieces_match_plain_and_jax(name, piece_rows):
    """Pieces merged by key equal vis_rowblock_plain exactly, and their ids
    the JAX kernel's (interpret mode), capacity cut included."""
    bins, t_jax = _case(name)
    make, w, h, cap, chunk = CASES[name]
    items, d_m, i_m = _merged_pieces(bins, cap, chunk, piece_rows)
    d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x, cap,
                                             chunk)
    np.testing.assert_array_equal(i_m.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_m.numpy(), d_p.numpy())
    if piece_rows == 16 and name in ("random300_seed1", "overflow300_seed1"):
        assert int((items[:, 3] > 1).sum()) > 0, "some tile is split"
    i_u = visibility.unfold_tiles(i_m, bins.tiles_y, bins.tiles_x, h, w)
    np.testing.assert_array_equal(i_u.numpy(), t_jax)


@pytest.mark.parametrize("piece_rows", [16, 128])
def test_cross_piece_ties_keep_the_earlier_pair(piece_rows):
    """One 32x128 tile of 4P screen-covering triangles where triangle
    k + 2P repeats triangle k: exact depth ties 2P rows apart, in different
    pieces.  The earlier pair (the smaller id) must win on every pixel, in
    the merged pieces, the plain version and, at P=16, the JAX kernel."""
    n = 2 * piece_rows
    base = _stack_tris(n, 4)
    clip = np.concatenate([base, base])
    w, h, cap, chunk = 128, 32, 4 * n, 128
    js, ts = _setups(clip, w, h)
    bins = binning.bin_triangles(ts, w, h, 32, 2 * clip.shape[0], chunk, fmt="wide16",
                                 tile_w=128)
    assert int(bins.starts[-1]) == clip.shape[0] and bins.starts.shape[0] == 2
    items, d_m, i_m = _merged_pieces(bins, cap, chunk, piece_rows)
    assert int(items[0, 3]) == 4
    d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x, cap,
                                             chunk)
    np.testing.assert_array_equal(i_m.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_m.numpy(), d_p.numpy())
    assert bool((i_m >= 0).all()) and bool((i_m < n).all()), "a tie kept the later pair"
    if piece_rows == 16:
        _, t_j = jvis.rasterize_vis_tiled(js, w, h, tile_capacity=cap, chunk=chunk)
        np.testing.assert_array_equal(
            visibility.unfold_tiles(i_m, bins.tiles_y, bins.tiles_x, h, w).numpy(),
            np.asarray(t_j))
