"""The hiz kernel's aligned work list (visibility_v2.aligned_work_list) and
the CPU model of its piece merge (visibility_v2.vis_folded_hiz_pieces).

The work list cuts each tile's segment at the multiples of `piece_rows` of
the global row index (the early-exit bound and the tie rule's slot are per
global 128-row block): every segment is covered exactly once, in order, by
pieces that never cross a multiple of piece_rows; an empty tile keeps one
empty piece; the surplus entries are (-1, 0, 0, 0); the static length holds
every piece; the piece-major order is a permutation of the tile-major one.

The model merges the pieces as the CUDA kernel does (nearer wins and equal
depths keep the smaller id inside a block, the minimum (depth, id) key
across pieces, a mark wherever pieces tie, the strict per-slot rule on the
marked pixels, blocks skipped against the tile's merged depths) and is held
to `vis_folded_hiz_plain` and to the JAX folded kernel with hiz=True in
interpret mode on test_torch_hiz.py's cases, at piece lengths 128 and 256,
in forward and reversed piece order, with and without the skip test.
Inputs are made from seeds with numpy.  Against the plain version ids and
depths are exactly equal (tolerance 0); against the JAX kernel ids exactly
equal and depth atol 1e-6, test_torch_hiz.py's tolerance for the plain
version itself.  The kernel itself is held against the plain version on the
card (test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_hiz as hz
from vulkan_pbr_renderer_tpu_torch.raster import binning as tbin
from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as tv2
from vulkan_pbr_renderer_tpu_torch.raster import xla_raster


def _check_aligned_list(starts, piece_rows, n_items, piece_major):
    """Every segment exactly once by aligned pieces; returns the live count."""
    starts = np.asarray(starts, np.int64)
    items = tv2.aligned_work_list(torch.as_tensor(starts, dtype=torch.int32), piece_rows,
                                  n_items, piece_major=piece_major)
    assert items.dtype == torch.int32 and tuple(items.shape) == (n_items, 4)
    items = items.numpy().astype(np.int64)
    n_tiles = starts.shape[0] - 1
    live = items[:, 0] >= 0
    n_live = int(live.sum())
    assert live[:n_live].all(), "surplus entries must follow every live one"
    assert (items[n_live:] == [-1, 0, 0, 0]).all()
    for t in range(n_tiles):
        mine = items[:n_live][items[:n_live, 0] == t]
        lo, hi = starts[t], starts[t + 1]
        want = (hi - 1) // piece_rows - lo // piece_rows + 1 if hi > lo else 1
        assert mine.shape[0] == want, (t, mine, lo, hi)
        assert (mine[:, 3] == want).all()
        assert (np.diff(mine[:, 1]) > 0).all() or want == 1, "a tile's pieces front to back"
        assert mine[0, 1] == lo and mine[-1, 2] == hi
        assert (mine[1:, 1] == mine[:-1, 2]).all(), "pieces are contiguous"
        assert (mine[1:, 1] % piece_rows == 0).all(), "cuts at multiples of piece_rows"
        size = mine[:, 2] - mine[:, 1]
        assert (size > 0).all() or (hi == lo and (size == 0).all())
        # a piece never crosses a multiple of piece_rows
        assert ((mine[:, 2] - 1) // piece_rows == mine[:, 1] // piece_rows)[size > 0].all()
    if piece_major:
        # ordered by (piece index in its tile, tile)
        index = [(lo // piece_rows - starts[t] // piece_rows, t) for t, lo, _, _ in
                 items[:n_live]]
        assert index == sorted(index)
    else:
        assert (np.diff(items[:n_live, 0]) >= 0).all(), "tiles in order"
    return n_live


@pytest.mark.parametrize("piece_major", [True, False])
@pytest.mark.parametrize("piece_rows", [128, 256])
@pytest.mark.parametrize("first,lens", [    # first start, then lengths as (multiple of P, + rows)
    (0, [(0, 0), (0, 0), (0, 0)]),                      # empty tiles only
    (0, [(1, 0), (2, 0), (0, 0), (1, 0)]),              # aligned segments
    (0, [(0, 5), (0, 0), (0, 100), (0, 40), (0, 3)]),   # short ones, one straddles a cut
    (0, [(1, 0), (1, 1), (0, 0), (2, 0), (2, 1)]),      # exactly P, P + 1, 2P, 2P + 1 rows
    (77, [(1, 0), (1, 1), (4, 0), (0, 1), (1, -1)]),    # the same from an unaligned start
    (127, [(0, 2), (0, 2), (3, 126)]),                  # every tile straddles a cut
])
def test_aligned_work_list_covers_segments(piece_major, piece_rows, first, lens):
    lens = [m * piece_rows + a for m, a in lens]
    starts = first + np.concatenate([[0], np.cumsum(lens)])
    cap = -(-int(starts[-1]) // 128) * 128
    n_items = tv2.aligned_work_list_length(len(lens), torch.zeros(cap // 128, 128, 13),
                                           piece_rows)
    assert n_items == len(lens) + -(-cap // piece_rows)
    n_live = _check_aligned_list(starts, piece_rows, n_items, piece_major)
    assert n_live <= n_items
    # a longer list only adds surplus entries
    assert _check_aligned_list(starts, piece_rows, n_items + 7, piece_major) == n_live


def test_aligned_work_list_of_exactly_p_and_p_plus_1():
    """Aligned tiles of exactly P and P + 1 rows are one piece and two; from
    an unaligned start a tile of P rows is two pieces, cut at the multiple."""
    items = tv2.aligned_work_list(torch.tensor([0, 128, 257], dtype=torch.int32), 128, 5,
                                  piece_major=False).numpy()
    np.testing.assert_array_equal(items, [[0, 0, 128, 1], [1, 128, 256, 2], [1, 256, 257, 2],
                                          [-1, 0, 0, 0], [-1, 0, 0, 0]])
    items = tv2.aligned_work_list(torch.tensor([100, 228], dtype=torch.int32), 128, 3).numpy()
    np.testing.assert_array_equal(items, [[0, 100, 128, 2], [0, 128, 228, 2], [-1, 0, 0, 0]])


def test_aligned_work_list_piece_major_order():
    """Three tiles of 3, 1 and 2 pieces: first pieces of all, then second
    pieces, then the third."""
    items = tv2.aligned_work_list(torch.tensor([0, 300, 310, 520], dtype=torch.int32), 128, 8)
    np.testing.assert_array_equal(items.numpy()[:, :3], [
        [0, 0, 128], [1, 300, 310], [2, 310, 384], [0, 128, 256], [2, 384, 512],
        [0, 256, 300], [2, 512, 520], [-1, 0, 0]])


def test_aligned_work_list_without_tiles():
    items = tv2.aligned_work_list(torch.tensor([0], dtype=torch.int32), 128, 3)
    np.testing.assert_array_equal(items.numpy(), [[-1, 0, 0, 0]] * 3)


@functools.cache
def _bins(case):
    js, w, h, capf = hz._jax_setup(case)
    return tbin.bin_triangles(hz._to_torch_setup(js), w, h, 32, capf * js.adj.shape[0], 128,
                              z_order=True), w, h


@pytest.mark.parametrize("piece_rows", [128, 256])
@pytest.mark.parametrize("case", hz.ALL_CASES)
def test_aligned_work_list_on_bins(case, piece_rows):
    """z-ordered bins of test_torch_hiz.py's cases (one has no pair at all):
    the static length holds every piece."""
    bins, _, _ = _bins(case)
    n_tiles = bins.starts.shape[0] - 1
    n_items = tv2.aligned_work_list_length(n_tiles, bins.pair_data, piece_rows)
    n_live = _check_aligned_list(bins.starts.numpy(), piece_rows, n_items, True)
    if case == "offscreen50_seed2":
        assert int(bins.starts[-1]) == 0 and n_live == n_tiles


@functools.cache
def _plain(case):
    bins, _, _ = _bins(case)
    return tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x,
                                    rows_walked=True)


MERGE_CASES = ["random600_seed11", "dup200x3_seed7", "slot_ties", "stack600_seed5",
               "scene_camera", "offscreen50_seed2"]


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
@pytest.mark.parametrize("piece_rows", [128, 256])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_piece_merge_matches_plain_and_jax(case, piece_rows, reverse, skip):
    """The model of the kernel's piece merge equals the plain version bit for
    bit and the JAX kernel in interpret mode, whatever the order of the
    pieces and whether or not blocks are skipped."""
    bins, w, h = _bins(case)
    d_m, i_m, stats = tv2.vis_folded_hiz_pieces(bins.starts, bins.pair_data, bins.chunk_minz,
                                                bins.tiles_x, piece_rows=piece_rows,
                                                reverse=reverse, skip=skip)
    d_p, i_p, walked_serial = _plain(case)
    np.testing.assert_array_equal(i_m.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_m.numpy(), d_p.numpy())
    d_j, i_j = hz._jax_hiz(case)
    unfold = functools.partial(tv2.unfold_tiles, tiles_y=bins.tiles_y, tiles_x=bins.tiles_x,
                               height=h, width=w)
    np.testing.assert_array_equal(unfold(i_m).numpy(), i_j)
    hz._depth_eq(unfold(d_m).numpy(), d_j)
    total = int(bins.starts[-1])
    if not skip:
        assert stats["rows_walked"] == total
    else:
        assert stats["rows_walked"] <= total
    if case == "slot_ties":
        # A's and B's tie lies across pieces (or blocks of a piece): every
        # pixel where the rule differs from "smallest id" is re-resolved
        assert stats["marked_pixels"] > 100
    if case == "stack600_seed5" and skip and not reverse:
        # front to back, the first blocks cover the tiles: the rest is skipped
        assert stats["rows_walked"] < total
        if piece_rows == 128:
            assert stats["rows_walked"] >= int(walked_serial.sum())


@pytest.mark.parametrize("apart", [256, 384])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
def test_piece_merge_same_slot_ties_further_apart(apart, reverse):
    """test_torch_hiz.py's slot-tie tile with the two tied rows `apart` rows
    apart, still in one slot: the earlier row (the larger id) keeps the tie,
    in the model as in the plain version."""
    def plane(xy):
        return 0.5 + 0.125 * np.asarray(xy, np.float32)[:, 0]

    a_xy = [(-1.25, -1.25), (3.0, -1.25), (-1.25, 3.0)]
    b_xy = [(-0.5, -0.5), (0.75, -0.5), (-0.5, 0.75)]
    fill = []
    for k in range(apart - 1):
        x0, y0 = 0.75 + 0.0625 * (k % 4), 0.75 + 0.0625 * (k // 4 % 4)
        fill.append(hz._tri([(x0, y0), (x0 + 0.0625, y0), (x0, y0 + 0.0625)],
                            np.full(3, 0.36 + 0.064 * k / apart)))
    clip = np.stack([hz._tri(b_xy, plane(b_xy))] + fill + [hz._tri(a_xy, plane(a_xy))])
    s = hz.tsetup.setup_triangles(torch.from_numpy(clip), 32, 32, cull="none")
    bins = tbin.bin_triangles(s, 32, 32, 32, 2 * clip.shape[0], 128, z_order=True)
    assert int(bins.starts[-1]) == apart + 1
    d_p, i_p = tv2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                        bins.tiles_x)
    _, i_b = xla_raster.rasterize_vis(s, 32, 32)
    tied = (i_b == 0) & (i_p.reshape(32, 32) == apart)
    for piece_rows in (128, 256):
        d_m, i_m, stats = tv2.vis_folded_hiz_pieces(
            bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x, piece_rows=piece_rows,
            reverse=reverse)
        np.testing.assert_array_equal(i_m.numpy(), i_p.numpy())
        np.testing.assert_array_equal(d_m.numpy(), d_p.numpy())
        assert stats["marked_pixels"] > 100
    # "smallest id" gives B's pixels to id 0; the per-slot rule keeps A there
    assert int(tied.sum()) > 100 and not bool((i_p == 0).any())


def test_piece_merge_tile_major_order():
    """The (tile, piece) order of the work list gives the same result."""
    bins, _, _ = _bins("dup200x3_seed7")
    d_m, i_m, _ = tv2.vis_folded_hiz_pieces(bins.starts, bins.pair_data, bins.chunk_minz,
                                            bins.tiles_x, piece_major=False)
    d_p, i_p, _ = _plain("dup200x3_seed7")
    np.testing.assert_array_equal(i_m.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_m.numpy(), d_p.numpy())
