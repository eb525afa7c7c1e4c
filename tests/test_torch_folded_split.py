"""K1's work list (visibility_v2.folded_work_list), which cuts each tile's
pair segment into pieces of at most `piece_rows` rows, one CUDA block each.

Checked on the CPU: every segment is covered exactly once, in order, by
pieces of at most piece_rows rows (an empty tile by one empty piece), the
surplus entries after the last piece are (-1, 0, 0, 0), and the list's
static length (work_list_length, from the buffer's capacity) holds every
piece — on hand-made segments (empty tiles, tiles of exactly P and P + 1
rows), a buffer with no pair at all, a pair count clipped at
pair_capacity, and the bins of test_torch_raster.py's cases.  Then the
pieces, each brute-forced on its own and merged by the minimum (depth bits,
id) key as the kernel merges them, give exactly the plain version's depth
and ids and the JAX brute force's ids.  The kernel itself is held against
the plain version on the card (test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu.raster import xla_raster as jxla
from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility_v2, xla_raster
from vulkan_pbr_renderer_tpu_torch.raster.binning import NCOL


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


# test_torch_raster.py's cases: (triangles, width, height)
CASES = {
    "random600_seed11": (lambda: _random_tris(600, 11), 128, 96),
    "crossing40_seed21": (lambda: _crossing_tris(40, 21), 160, 96),
    "random300_seed1": (lambda: _random_tris(300, 1), 256, 160),
}


def _check_work_list(starts, piece_rows, n_items):
    """The list covers each segment exactly once; returns the live count."""
    starts = np.asarray(starts, np.int64)
    items = visibility_v2.folded_work_list(torch.as_tensor(starts, dtype=torch.int32),
                                           piece_rows, n_items)
    assert items.dtype == torch.int32 and tuple(items.shape) == (n_items, 4)
    items = items.numpy().astype(np.int64)
    n_tiles = starts.shape[0] - 1
    live = items[:, 0] >= 0
    n_live = int(live.sum())
    assert live[:n_live].all(), "surplus entries must follow every live one"
    assert (items[n_live:] == [-1, 0, 0, 0]).all()
    assert (np.diff(items[:n_live, 0]) >= 0).all(), "tiles in order"
    for t in range(n_tiles):
        mine = items[:n_live][items[:n_live, 0] == t]
        seg = starts[t + 1] - starts[t]
        want = max(1, -(-seg // piece_rows))
        assert mine.shape[0] == want, (t, mine, seg)
        assert (mine[:, 3] == want).all()
        assert mine[0, 1] == starts[t] and mine[-1, 2] == starts[t + 1]
        assert (mine[1:, 1] == mine[:-1, 2]).all(), "pieces are contiguous"
        size = mine[:, 2] - mine[:, 1]
        assert (size <= piece_rows).all()
        assert (size > 0).all() or (seg == 0 and (size == 0).all())
    return n_live


@pytest.mark.parametrize("piece_rows", [128, 256])
@pytest.mark.parametrize("lens", [        # segment lengths as (multiple of P, + rows)
    [(0, 0), (0, 0), (0, 0)],                     # empty tiles only
    [(0, 0), (0, 5), (0, 0), (0, 0), (0, 3)],     # empty tiles between short ones
    [(1, 0), (1, 1), (0, 0), (2, 0), (2, 1)],     # exactly P, P + 1, 2P, 2P + 1 rows
    [(4, 0), (0, 1), (1, -1)],                    # one deep tile
])
def test_work_list_covers_segments(piece_rows, lens):
    lens = [m * piece_rows + a for m, a in lens]
    starts = np.concatenate([[0], np.cumsum(lens)])
    n_items = len(lens) + int(starts[-1]) // piece_rows
    n_live = _check_work_list(starts, piece_rows, n_items)
    assert n_live == sum(max(1, -(-n // piece_rows)) for n in lens)
    # a longer list only adds surplus entries
    assert _check_work_list(starts, piece_rows, n_items + 7) == n_live


def test_work_list_of_exactly_p_and_p_plus_1():
    """A tile of exactly P rows is one piece; P + 1 rows are two, the second
    of one row."""
    items = visibility_v2.folded_work_list(
        torch.tensor([0, 128, 257], dtype=torch.int32), 128, 2 + 257 // 128).numpy()
    np.testing.assert_array_equal(items[:3], [[0, 0, 128, 1], [1, 128, 256, 2],
                                              [1, 256, 257, 2]])
    np.testing.assert_array_equal(items[3:], [[-1, 0, 0, 0]])


def test_work_list_without_tiles():
    items = visibility_v2.folded_work_list(torch.tensor([0], dtype=torch.int32), 128, 3)
    np.testing.assert_array_equal(items.numpy(), [[-1, 0, 0, 0]] * 3)


def _bins(case, cap_factor=8, chunk=128):
    make, w, h = CASES[case]
    clip = make()
    s = setup.setup_triangles(torch.from_numpy(clip), w, h, cull="none")
    return s, binning.bin_triangles(s, w, h, 32, cap_factor * clip.shape[0], chunk), w, h


def _merged_pieces(bins, piece_rows):
    """The kernel's arithmetic on the CPU: each piece of the work list
    brute-forced over its own rows, merged by the minimum (depth, id) key."""
    n_tiles = bins.starts.shape[0] - 1
    items = visibility_v2.folded_work_list(
        bins.starts, piece_rows,
        visibility_v2.work_list_length(n_tiles, bins.pair_data, piece_rows))
    rows_all = bins.pair_data.reshape(-1, NCOL)
    best = torch.full((n_tiles, visibility_v2.PIX), xla_raster.INT64_MAX, dtype=torch.int64)
    for t, lo, hi, _ in items.tolist():
        if t < 0 or hi == lo:
            continue
        rows = rows_all[lo:hi]
        px, py = visibility_v2._tile_pixel_centers(torch.tensor([t]), bins.tiles_x, "cpu")
        ids = (rows[:, 12].abs() - 1.0).to(torch.int32)
        key = xla_raster.depth_id_key(xla_raster.depth_at(rows, px, py), ids[:, None])
        best[t] = torch.minimum(best[t], key.amin(0))
    return items, xla_raster.key_to_depth_id(best)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cap_factor", [8, 1])
@pytest.mark.parametrize("piece_rows", [16, 128])
def test_work_list_on_bins(case, cap_factor, piece_rows):
    """The bins of test_torch_raster.py's cases, with the buffer sized for
    the scene (8 pairs per triangle) and clipped at pair_capacity (1 per
    triangle: every case overflows, the last segments end at the capacity)."""
    _, bins, _, _ = _bins(case, cap_factor)
    n_tiles = bins.starts.shape[0] - 1
    cap_rows = bins.pair_data.numel() // NCOL
    if cap_factor == 1:
        assert int(bins.total_pairs) > cap_rows and int(bins.starts[-1]) == cap_rows
    n_items = visibility_v2.work_list_length(n_tiles, bins.pair_data, piece_rows)
    assert n_items == n_tiles + cap_rows // piece_rows
    _check_work_list(bins.starts.numpy(), piece_rows, n_items)


def test_work_list_without_pairs():
    """Triangles all off screen: every tile empty, one empty piece each."""
    clip = _random_tris(50, 3)
    clip[..., 0] += 10.0 * clip[..., 3]
    s = setup.setup_triangles(torch.from_numpy(clip), 64, 64, cull="none")
    bins = binning.bin_triangles(s, 64, 64, 32, 200)
    assert int(bins.total_pairs) == 0 and int(bins.starts[-1]) == 0
    n_tiles = bins.starts.shape[0] - 1
    n_live = _check_work_list(bins.starts.numpy(), 128,
                              visibility_v2.work_list_length(n_tiles, bins.pair_data, 128))
    assert n_live == n_tiles
    _, (depth, ids) = _merged_pieces(bins, 128)
    assert torch.isinf(depth).all() and (ids == -1).all()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("piece_rows", [16, 128])
def test_merged_pieces_match_plain_and_jax(case, piece_rows):
    """Pieces merged by key equal vis_folded_plain exactly, and their ids the
    JAX brute force's (the buffer holds every pair)."""
    s, bins, w, h = _bins(case)
    items, (d_m, i_m) = _merged_pieces(bins, piece_rows)
    d_p, i_p = visibility_v2.vis_folded_plain(bins.starts, bins.pair_data, bins.tiles_x)
    np.testing.assert_array_equal(i_m.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_m.numpy(), d_p.numpy())
    if piece_rows == 16:
        assert int((items[:, 3] > 1).sum()) > 0, "some tile is split"
    make, _, _ = CASES[case]
    _, t_ref = jxla.rasterize_vis(jsetup.setup_triangles(jnp.asarray(make()), w, h, cull="none"),
                                  w, h)
    i_u = visibility_v2.unfold_tiles(i_m, bins.tiles_y, bins.tiles_x, h, w)
    np.testing.assert_array_equal(i_u.numpy(), np.asarray(t_ref))
