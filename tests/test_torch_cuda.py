"""The CUDA visibility kernels (folded K1, its hierarchical-z variant,
rowblock K2) against their plain PyTorch versions, on the card; K1 and K2
also on the regimes of their work lists (a deep one-tile stack, exact ties
in different pieces, single-piece tiles; for K2 a capacity cut inside a
piece; for the hiz kernel its aligned work list, same-slot ties across
pieces, both work-list orders and the early exit of a one-block grid).
The fast-GI ray kernel (csrc/gi_fast_ray.cu) against
gi.fast_ray_resolve_plain on seed-made lanes
(tests/test_torch_gi_ray_inputs.py), for each value of the fast path's
options, on ragged lane grids, and its wrapper's checks.  The binning
kernels (csrc/binning.cu) against binning.bin_triangles_plain, every field
bit for bit, on test_torch_binning.py's edge cases, the counting sort's
(one-tile runs longer than its sorts hold, natural and with the long sort
and its merge forced by small thresholds; overflows that cut a run; sets
whose triangles share one zq; the widest z_order key; 5,184 tiles; many
pairs in a few tiles) and the real passes of a 640x384 frame, and their
wrapper's checks.  The post kernels (csrc/post.cu: taa_resolve,
bloom_down_level, bloom_up_level) against their plain versions on the
card: TAA in every history mode on ragged frames, with row windows from
odd rows and at the frame's edges and the halo API, at still, slow and
far velocities and off screen; 2:1 and odd bloom chains with sizes down
to 1, the one-launch
down chain (bloom_down_chain) against the plain chain and the per-level
launches, with and without its atlas, repeated and on a side stream, the
one-launch up chain (bloom_up_chain) against the plain chain and the
per-level launches, whole and over row windows, with and without the
tonemap, repeated and on a side stream, the post stack with TAA and bloom
each on and off, and their wrappers' checks.  The tiled shade kernel against
shade_plain on ragged frames, bands and grids 0-3 exact 2x steps below the
pixels, and its occupancy; the tiled G-buffer on ragged frames and odd
bands, its atlas check and its occupancy.  The one-launch polar shafts
(csrc/lighting.cu) against shafts_polar_plain, one launch a call, with
shapes in turns (the plan cache and the epochs) at n_r 12 and 48.  The GI
lane inputs through their cached plan (gi_modes._LanePlan): one launch a
call, fresh outputs each call, inputs the plan refuses checked in full.
The lightgrid sweep (csrc/sweep.cu, gi.sweep_lightgrid_u8) against the
plain chain (sweep_lightgrid + quantize_grid_u8), grid and table bit for
bit, on every axis of seeded grids with no, ~30% and every voxel
occupied, odd lengths (the replay kernel), 16-256-voxel lines (the ring
kernel), a group left short, a line in dynamic shared memory and 128^3;
its refusals, both kernels' occupancy, and the fast GI's refusal of a
missing table.  Voxelize: the frame's one-launch pass (csrc/voxelize.cu
voxelize_pass_kernel, gi.voxelize_lightgrid) against the plain chain
(decode_voxel_grid_plain of voxelize_scene_plain), the decoded grid bit
for bit, on the seeded sets of tests/test_torch_voxelize_inputs.py (the
one-sample set without a search), repeated, with the emission by value,
on a long stream, a 128^3 grid and a cut one-sample stream; the sharded
frame's int64 route (gi.voxelize_scene and gi.decode_voxel_grid) words and
decoded grid bit for bit, whole, repeated, with the emission by value and
in 2, 4 and 8 shards, a long stream, a 128^3 grid, random words through
the decode; their refusals; one launch of the pass on the frames that
voxelize, none on a steady frame, none of the int64 route.

Needs a CUDA device and skips without one.  The file imports no jax, so it
also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: ids exactly equal, depth atol 1e-6 (the kernel rounds every
product, sum and the divide as the plain version does).  GI rays: statuses
equal, rgb atol 1e-5 (the kernel follows the plain version's order on the
card, down to the order in which torch.linalg.vector_norm sums its squares;
another PyTorch build's order would move the fallback's rgb by an ulp).
Post: TAA and the 2:1 bloom levels bit for bit, odd-size levels (whose
linear resize the plain version sums by einsum) atol 1e-5.
"""

import numpy as np
import pytest
import torch

from test_torch_gi_ray_inputs import random_rays, ray_call_args
from test_torch_reference_ray_inputs import SETS as REF_SETS
from test_torch_reference_ray_inputs import reference_call_args, reference_rays, set_call_args
from vulkan_pbr_renderer_tpu_torch.raster import (binning, setup, visibility, visibility_v2,
                                                   xla_raster)
from vulkan_pbr_renderer_tpu_torch.app import renderer as trender
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.gpu import sampling
from vulkan_pbr_renderer_tpu_torch.shade import bloom, gi, gi_modes, lighting, shadow, taa
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).repeat(3, 1)
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bins(n, seed, w, h, dev):
    s = setup.setup_triangles(torch.from_numpy(_random_tris(n, seed)).to(dev), w, h,
                              cull="none")
    bins = binning.bin_triangles(s, w, h, 32, pair_capacity=64 * n)
    assert int(bins.total_pairs) <= 64 * n  # no dropped pairs: the brute force sees all
    return s, bins


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,w,h", [(600, 11, 128, 96), (300, 1, 256, 160),
                                        (3000, 5, 640, 352)])
def test_kernel_matches_plain(cuda, n, seed, w, h):
    s, bins = _bins(n, seed, w, h, cuda)
    before = visibility_v2.vis_folded_tiles.launches
    d_k, i_k = visibility_v2.vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x)
    assert visibility_v2.vis_folded_tiles.launches == before + 1
    d_p, i_p = visibility_v2.vis_folded_plain(bins.starts, bins.pair_data, bins.tiles_x)
    torch.cuda.synchronize()
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-6)
    d_b, i_b = xla_raster.rasterize_vis(s, w, h)
    i_u = visibility_v2.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
    torch.testing.assert_close(i_u, i_b, rtol=0, atol=0)


def _tie_set(n, seed):
    """2n screen-covering triangles where triangle k + n repeats triangle k:
    exact depth ties between rows n apart, which the smaller id must win."""
    base = _stack_tris(n, seed)
    return np.concatenate([base, base])


def _small_tris(n, seed):
    """n triangles of at most a few pixels: every tile is one piece."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.02, 0.02, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 3, 1))
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deep_stack", "cross_piece_ties", "single_pieces"])
def test_kernel_split_matches_plain(cuda, name):
    """The work list's three regimes on one tile or many: a one-tile stack of
    4P triangles (at least 4 pieces), a one-tile set whose exact ties fall
    2P rows apart, in different pieces, and a set where every tile is one
    piece.  Ids exactly equal, depth within 1e-6."""
    piece_rows = visibility_v2._library().vis_folded_piece_rows()
    if name == "deep_stack":
        clip, w, h = _stack_tris(4 * piece_rows, 3), 32, 32
    elif name == "cross_piece_ties":
        clip, w, h = _tie_set(2 * piece_rows, 4), 32, 32
    else:
        clip, w, h = _small_tris(3000, 6), 640, 352
    n = clip.shape[0]
    s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), w, h, cull="none")
    bins = binning.bin_triangles(s, w, h, 32, pair_capacity=64 * n)
    items = visibility_v2.folded_work_list(
        bins.starts, piece_rows,
        visibility_v2.work_list_length(bins.starts.shape[0] - 1, bins.pair_data, piece_rows))
    pieces = int(items[:, 3].max())
    if name == "single_pieces":
        assert pieces == 1
    else:
        assert int(bins.starts[-1]) == n and pieces >= 4
    d_k, i_k = visibility_v2.vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x)
    d_p, i_p = visibility_v2.vis_folded_plain(bins.starts, bins.pair_data, bins.tiles_x)
    torch.cuda.synchronize()
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-6)
    if name == "cross_piece_ties":
        assert int((i_k >= 0).sum()) > 0 and bool((i_k < 2 * piece_rows).all())


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda):
    _, bins = _bins(50, 2, 64, 64, cuda)
    with pytest.raises(TypeError):
        visibility_v2.vis_folded_tiles(bins.starts.long(), bins.pair_data, bins.tiles_x)
    with pytest.raises(ValueError):
        visibility_v2.vis_folded_tiles(bins.starts, bins.pair_data.cpu(), bins.tiles_x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,w,h,cap,chunk", [
    (600, 11, 128, 96, 4096, 128), (300, 1, 256, 160, 512, 128),
    (3000, 5, 640, 352, 4096, 128), (300, 1, 256, 160, 64, 16),   # overflowing
])
def test_rowblock_kernel_matches_plain(cuda, n, seed, w, h, cap, chunk):
    s = setup.setup_triangles(torch.from_numpy(_random_tris(n, seed)).to(cuda), w, h,
                              cull="none")
    bins = binning.bin_triangles(s, w, h, 32, 64 * n, chunk, fmt="wide16", tile_w=128)
    before = visibility.vis_rowblock_tiles.launches
    d_k, i_k = visibility.vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x,
                                             cap, chunk)
    assert visibility.vis_rowblock_tiles.launches == before + 1
    d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x,
                                             cap, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-6)
    if cap >= int(bins.max_segment):
        # no capacity cut: the same ids as the whole-screen brute force
        d_b, i_b = xla_raster.rasterize_vis(s, w, h)
        i_u = visibility.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
        torch.testing.assert_close(i_u, i_b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deep_stack", "cross_piece_ties", "capacity_cut"])
def test_rowblock_kernel_split_matches_plain(cuda, name):
    """K2's work list on one 32x128 tile: a stack of 4P triangles (4
    pieces), a set whose exact ties fall 2P rows apart, in different pieces
    (the earlier pair must win), and the same stack cut by a tile_capacity
    of 2P + 64 inside the third piece.  Ids and depths exactly equal."""
    piece_rows = visibility._library().vis_rowblock_piece_rows()
    cap = 4096 * 8
    if name == "cross_piece_ties":
        clip = _tie_set(2 * piece_rows, 4)
    else:
        clip = _stack_tris(4 * piece_rows, 3)
        if name == "capacity_cut":
            cap = 2 * piece_rows + 64
    n = clip.shape[0]
    s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), 128, 32, cull="none")
    bins = binning.bin_triangles(s, 128, 32, 32, 2 * n, 16, fmt="wide16", tile_w=128)
    assert int(bins.starts[-1]) == n
    d_k, i_k = visibility.vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x, cap, 16)
    d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x, cap, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=0)
    if name == "cross_piece_ties":
        assert bool((i_k >= 0).all()) and bool((i_k < 2 * piece_rows).all())


def _stack_tris(n, seed):
    """Screen-covering triangles at random depths: deep segments that the
    hiz walk leaves early."""
    rng = np.random.default_rng(seed)
    verts = np.array([(-3.0, -3.0), (5.0, -3.0), (-3.0, 5.0)]) + rng.uniform(-0.2, 0.2, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,w,h", [("random600", 128, 96), ("dup200x3", 128, 96),
                                      ("stack600", 64, 64), ("random3000", 640, 352)])
def test_hiz_kernel_matches_plain(cuda, name, w, h):
    if name == "dup200x3":
        clip = np.concatenate([_random_tris(200, 7)] * 3)
        clip = clip[np.random.default_rng(8).permutation(clip.shape[0])]
    elif name == "stack600":
        clip = _stack_tris(600, 5)
    else:
        clip = _random_tris(int(name[6:]), 11)
    n = clip.shape[0]
    s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), w, h, cull="none")
    bins = binning.bin_triangles(s, w, h, 32, pair_capacity=64 * n, z_order=True)
    before = visibility_v2.vis_folded_hiz_tiles.launches
    d_k, i_k = visibility_v2.vis_folded_hiz_tiles(bins.starts, bins.pair_data, bins.chunk_minz,
                                                  bins.tiles_x)
    assert visibility_v2.vis_folded_hiz_tiles.launches == before + 1
    d_p, i_p = visibility_v2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                                  bins.tiles_x)
    torch.cuda.synchronize()
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-6)


def _tri(xy, z):
    xy = np.asarray(xy, np.float32)
    return np.concatenate([xy, np.asarray(z, np.float32)[:, None],
                           np.ones((3, 1), np.float32)], -1)


def _slot_tie_tris(apart):
    """tests/test_torch_hiz.py::_slot_tie_tris with the two exactly tied rows
    `apart` rows apart (a multiple of 128: one slot), the later row holding
    the smaller id."""
    def plane(xy):
        return 0.5 + 0.125 * np.asarray(xy, np.float32)[:, 0]

    a_xy = [(-1.25, -1.25), (3.0, -1.25), (-1.25, 3.0)]
    b_xy = [(-0.5, -0.5), (0.75, -0.5), (-0.5, 0.75)]
    fill = []
    for k in range(apart - 1):
        x0, y0 = 0.75 + 0.0625 * (k % 4), 0.75 + 0.0625 * (k // 4 % 4)
        fill.append(_tri([(x0, y0), (x0 + 0.0625, y0), (x0, y0 + 0.0625)],
                         np.full(3, 0.36 + 0.064 * k / apart)))
    return np.stack([_tri(b_xy, plane(b_xy))] + fill + [_tri(a_xy, plane(a_xy))])


def _hiz_sets(name):
    if name.startswith("slot_ties"):
        return _slot_tie_tris(int(name.split("_")[-1])), 32, 32
    if name == "dup200x3":
        clip = np.concatenate([_random_tris(200, 7)] * 3)
        return clip[np.random.default_rng(8).permutation(clip.shape[0])], 128, 96
    if name == "deep_stack":
        return _stack_tris(602, 9), 32, 32
    return _stack_tris(600, 5), 64, 64      # stack600


@pytest.mark.cuda
@pytest.mark.parametrize("piece_major", [True, False], ids=["piece_major", "tile_major"])
@pytest.mark.parametrize("name", ["slot_ties_128", "slot_ties_256", "slot_ties_384",
                                  "dup200x3", "stack600", "deep_stack"])
def test_hiz_kernel_pieces_match_plain(cuda, name, piece_major):
    """The hiz kernel's piece merge on the card, in both work-list orders:
    same-slot ties 128, 256 and 384 rows apart (the earlier row, with the
    larger id, keeps the tie; the tied pixels take the re-resolve),
    duplicated triangles, and deep stacks.  Ids and depths exactly equal to
    the plain version; the work list the kernel built equals
    aligned_work_list (inside a piece-major group in any order)."""
    clip, w, h = _hiz_sets(name)
    s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), w, h, cull="none")
    bins = binning.bin_triangles(s, w, h, 32, 8 * clip.shape[0], 128, z_order=True)
    lib = visibility_v2._hiz_library()
    piece_rows = lib.vis_folded_hiz_piece_rows()
    d_k, i_k, stats, items = visibility_v2.run_vis_folded_hiz(
        lib, bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x, piece_major)
    d_p, i_p = visibility_v2.vis_folded_hiz_plain(bins.starts, bins.pair_data, bins.chunk_minz,
                                                  bins.tiles_x)
    torch.cuda.synchronize()
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=0)
    want = visibility_v2.aligned_work_list(bins.starts, piece_rows, items.shape[0], piece_major)
    if piece_major:
        st = bins.starts.to(torch.int64)
        t = items[:, 0].to(torch.int64).clamp(min=0)
        level = torch.where(items[:, 0] >= 0,
                            items[:, 1].to(torch.int64) // piece_rows - st[t] // piece_rows,
                            1 << 40)
        assert bool((level[1:] >= level[:-1]).all())
        items = items[torch.argsort(level * (st.shape[0] + 1) + items[:, 0], stable=True)]
    torch.testing.assert_close(items, want, rtol=0, atol=0)
    walked, marked = (int(x) for x in stats)
    assert 0 < walked <= int(bins.starts[-1])
    if name.startswith("slot_ties"):
        apart = int(name.split("_")[-1])
        _, i_b = xla_raster.rasterize_vis(s, w, h)
        tied = (i_b == 0) & (i_k.reshape(32, 32) == apart)
        assert int(tied.sum()) > 100 and marked >= int(tied.sum())


@pytest.mark.cuda
def test_hiz_kernel_one_block_exits_early(cuda):
    """One block walks the work list serially, every tile front to back: on
    a one-tile stack of 602 triangles the first block covers the tile and
    the others are skipped, with the same result."""
    clip, w, h = _hiz_sets("deep_stack")
    s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), w, h, cull="none")
    bins = binning.bin_triangles(s, w, h, 32, 2 * clip.shape[0], 128, z_order=True)
    assert int(bins.starts[-1]) == 602
    d_k, i_k, stats, _ = visibility_v2.run_vis_folded_hiz(
        visibility_v2._hiz_library(), bins.starts, bins.pair_data, bins.chunk_minz,
        bins.tiles_x, max_blocks=1)
    d_p, i_p, walked = visibility_v2.vis_folded_hiz_plain(
        bins.starts, bins.pair_data, bins.chunk_minz, bins.tiles_x, rows_walked=True)
    torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=0)
    assert int(walked.sum()) <= int(stats[0]) < 602


@pytest.mark.cuda
def test_hiz_kernel_wrapper_rejects_bad_inputs(cuda):
    clip, w, h = _hiz_sets("stack600")
    s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), w, h, cull="none")
    bins = binning.bin_triangles(s, w, h, 32, 4 * clip.shape[0], 128, z_order=True)
    with pytest.raises(TypeError):
        visibility_v2.vis_folded_hiz_tiles(bins.starts.long(), bins.pair_data, bins.chunk_minz,
                                           bins.tiles_x)
    with pytest.raises(ValueError):
        visibility_v2.vis_folded_hiz_tiles(bins.starts, bins.pair_data, bins.chunk_minz[:-1],
                                           bins.tiles_x)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["folded", "hiz", "rowblock"])
@pytest.mark.parametrize("y0,rows", [(0, 96), (96, 64), (48, 112)])
def test_kernel_band_matches_full_pass(cuda, kernel, y0, rows):
    """Each kernel on a band of rows [y0, y0 + rows) (its y_origin, as the
    row-sharded frame calls it): depth and ids equal to the same rows of the
    whole-screen pass through the kernel, and to its plain version's band,
    bit for bit; one launch per band."""
    w, h = 256, 160
    s = setup.setup_triangles(torch.from_numpy(_random_tris(3000, 5)).to(cuda), w, h,
                              cull="none")
    cap = 64 * 3000

    def band(y_origin, n_rows):
        if kernel == "rowblock":
            return visibility.rasterize_vis_tiled(s, w, n_rows, tile_capacity=4096, chunk=128,
                                                  pair_capacity=cap, y_origin=y_origin)
        d, i, _ = visibility_v2.rasterize_vis_folded(s, w, n_rows, pair_capacity=cap,
                                                     hiz=kernel == "hiz", y_origin=y_origin)
        return d, i

    counter = {"folded": visibility_v2.vis_folded_tiles,
               "hiz": visibility_v2.vis_folded_hiz_tiles,
               "rowblock": visibility.vis_rowblock_tiles}[kernel]
    before = counter.launches
    d_b, i_b = band(y0, rows)
    assert counter.launches == before + 1
    d_f, i_f = band(0, h)
    torch.testing.assert_close(i_b, i_f[y0:y0 + rows], rtol=0, atol=0)
    torch.testing.assert_close(d_b, d_f[y0:y0 + rows], rtol=0, atol=0)
    s_cpu = setup.TriSetup(*(t.cpu() for t in s))
    if kernel == "rowblock":
        d_p, i_p = visibility.rasterize_vis_tiled(s_cpu, w, rows, tile_capacity=4096,
                                                  chunk=128, pair_capacity=cap, y_origin=y0)
    else:
        d_p, i_p, _ = visibility_v2.rasterize_vis_folded(s_cpu, w, rows, pair_capacity=cap,
                                                         hiz=kernel == "hiz", y_origin=y0)
    torch.testing.assert_close(i_b.cpu(), i_p, rtol=0, atol=0)
    torch.testing.assert_close(d_b.cpu(), d_p, rtol=0, atol=1e-6)


# (name, specular ray, RenderConfig changes): every value of the fast path's
# options that the kernel takes
GI_RAY_VARIANTS = [
    ("diffuse", False, {}),
    ("specular", True, {}),
    ("nearest_march", False, dict(gi_fast_fog_trilinear=False)),
    ("nearest_march_specular", True, dict(gi_fast_fog_trilinear=False)),
    ("no_screen", False, dict(gi_fast_screen_probe=False)),
    ("no_screen_nearest", True, dict(gi_fast_screen_probe=False, gi_fast_fog_trilinear=False)),
    ("taps2", True, dict(gi_trace_solid_taps=2)),
    ("taps3", False, dict(gi_trace_solid_taps=3)),
    ("trace_16_3_4", True, dict(gi_trace_steps=16, gi_trace_rounds=3, gi_trace_steps2=4)),
    ("trace_8_1", False, dict(gi_trace_steps=8, gi_trace_rounds=1)),
]


def _ray_kernel_vs_plain(args, screen):
    before = gi.fast_ray_resolve.launches
    rgb_k, st_k = gi.fast_ray_resolve(*args)
    assert gi.fast_ray_resolve.launches == before + 1
    rgb_p, st_p = gi.fast_ray_resolve_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(st_k, st_p, rtol=0, atol=0)
    torch.testing.assert_close(rgb_k, rgb_p, rtol=0, atol=1e-5)
    want = {1, 2, 3} if screen else {2}
    assert set(torch.unique(st_k).tolist()) == want


@pytest.mark.cuda
@pytest.mark.parametrize("name,spec,changes", GI_RAY_VARIANTS, ids=[v[0] for v in GI_RAY_VARIANTS])
def test_gi_ray_kernel_matches_plain(cuda, name, spec, changes):
    arrays, scalars = random_rays(21)
    args = ray_call_args(arrays, scalars, cuda, spec=spec, **changes)
    _ray_kernel_vs_plain(args, changes.get("gi_fast_screen_probe", True))


@pytest.mark.cuda
def test_gi_ray_kernel_lane_shapes(cuda):
    """An odd lane count in a [7, 143] grid of lanes, a full-resolution
    trace table (the row-sharded frame's divisor-1 band) and a 24^3 grid."""
    arrays, scalars = random_rays(22, n=1001, d=24, th=96, tw=128)
    args = list(ray_call_args(arrays, scalars, cuda, spec=True))
    for i in (8, 9, 10):
        args[i] = args[i].reshape(7, 143, 3)
    args[11] = args[11].reshape(7, 143)
    args[12] = args[12].reshape(7, 143)
    _ray_kernel_vs_plain(args, True)


@pytest.mark.cuda
def test_gi_ray_wrapper_rejects_bad_inputs(cuda):
    arrays, scalars = random_rays(23, n=256)
    args = ray_call_args(arrays, scalars, cuda)
    bad = {0: args[0].float(),                      # table not u8
           2: args[2].double(),                     # trace table not f32
           3: args[3].float(),                      # pyramid not bf16
           7: args[7].cpu(),                        # camera position on the CPU
           8: args[8][:, [2, 1, 0]].t().contiguous().t(),   # pw not contiguous
           9: args[9][:128],                        # rd of another shape
           11: args[11].half(),                     # noise not f32
           13: args[13]._replace(prev_levels=17)}   # more pyramid levels than the kernel keeps
    for i, value in bad.items():
        call = list(args)
        call[i] = value
        before = gi.fast_ray_resolve.launches
        with pytest.raises(ValueError):
            gi.fast_ray_resolve(*call)
        assert gi.fast_ray_resolve.launches == before


def _ray_args_shaped(seed, shape, d=16):
    """Seed-made lanes of the specular ray in a lane grid of `shape`."""
    n = int(np.prod(shape))
    arrays, scalars = random_rays(seed, n=n, d=d)
    args = list(ray_call_args(arrays, scalars, "cuda", spec=True))
    for i in (8, 9, 10):
        args[i] = args[i].reshape(tuple(shape) + (3,))
    for i in (11, 12):
        args[i] = args[i].reshape(tuple(shape))
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 143), (1, 1), (3, 1000), (1,), (0,), (2, 5, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gi_ray_kernel_ragged_lane_grids(cuda, shape):
    """Lane grids whose rows and widths are not multiples of the warp tile,
    one lane, no lane and stacked rows: every lane written once, as the
    plain version computes it."""
    args = _ray_args_shaped(24, shape)
    before = gi.fast_ray_resolve.launches
    rgb_k, st_k = gi.fast_ray_resolve(*args)
    rgb_p, st_p = gi.fast_ray_resolve_plain(*args)
    torch.cuda.synchronize()
    assert gi.fast_ray_resolve.launches == before + 1
    assert st_k.shape == tuple(shape) and rgb_k.shape == tuple(shape) + (3,)
    torch.testing.assert_close(st_k, st_p, rtol=0, atol=0)
    torch.testing.assert_close(rgb_k, rgb_p, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# binning (csrc/binning.cu) against bin_triangles_plain, every field bit for bit

BIN_FIELDS = ("starts", "pair_data", "total_pairs", "max_segment", "chunk_minz")


def _bins_bit_equal(got, want):
    assert (got.tiles_x, got.tiles_y) == (want.tiles_x, want.tiles_y)
    for name in BIN_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


def _small_setup(n, seed, w, h, dev, size=0.4, spread=1.0, valid=True, flat_z=False):
    """tests/test_torch_binning.py's triangles: depth varying over each, or
    with flat_z every vertex at depth 0.5 (every triangle's zq equal)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-spread, spread, (n, 1, 2))
    verts = center + rng.uniform(-size, size, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.05, 0.05, (n, 3, 1))
    if flat_z:
        z = np.full_like(z, 0.5)
    clip = np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)
    s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
    return s if valid else s._replace(valid=torch.zeros_like(s.valid))


def _cut_inside_run(s, w, h, tile_w, cap, chunk=128):
    """Whether the buffer's end (cap rounded up to chunk) falls inside a
    triangle's run of pair rows, not at a run's end."""
    bb = s.bbox.long()
    tx = (torch.clamp((bb[:, 2] - 1) // tile_w, max=-(-w // tile_w) - 1)
          - torch.clamp(bb[:, 0] // tile_w, min=0) + 1)
    ty = (torch.clamp((bb[:, 3] - 1) // 32, max=-(-h // 32) - 1)
          - torch.clamp(bb[:, 1] // 32, min=0) + 1)
    live = s.valid & (bb[:, 3] > 0) & (bb[:, 1] < h)
    ends = torch.cumsum(torch.where(live, tx * ty, 0), 0)
    rows = -(-cap // chunk) * chunk
    return bool(ends[-1] > rows) and not bool((ends == rows).any())


# (name, setup args, bin_triangles args): test_torch_binning.py's edge cases
BIN_CASES = [
    ("z_order_overflow", (300, 1, 256, 160), dict(w=256, h=160, pair_capacity=300,
                                                   z_order=True)),
    ("z_order_overflow_quarter", (300, 1, 256, 160), dict(w=256, h=160, pair_capacity=75,
                                                           z_order=True)),
    ("z_order_dead_tail", (12, 7, 128, 96, 0.4, 0.5), dict(w=128, h=96, pair_capacity=768,
                                                            chunk=16, z_order=True)),
    ("no_valid", (50, 3, 128, 96, 0.4, 1.0, False), dict(w=128, h=96, pair_capacity=400,
                                                          chunk=16)),
    ("no_valid_z_order", (50, 3, 128, 96, 0.4, 1.0, False),
     dict(w=128, h=96, pair_capacity=400, chunk=16, z_order=True)),
    ("empty_band_slim13", (40, 5, 128, 96, 0.4, 0.3), dict(w=128, h=32, pair_capacity=320,
                                                            z_order=True, y_origin=96)),
    ("empty_band_wide16", (40, 5, 128, 96, 0.4, 0.3),
     dict(w=128, h=32, pair_capacity=320, fmt="wide16", tile_w=128, y_origin=96)),
    ("wide16_2048_sparse", (30, 9, 2048, 2048, 0.05, 0.9),
     dict(w=2048, h=2048, pair_capacity=240, fmt="wide16", tile_w=128)),
    ("band_y48", (600, 11, 128, 96), dict(w=128, h=48, pair_capacity=4800, y_origin=48)),
    ("wide16_chunk16", (600, 11, 128, 96), dict(w=128, h=96, pair_capacity=4800, chunk=16,
                                                 fmt="wide16", tile_w=128)),
    # a run longer than binning.RADIX_KEYS: tiny triangles over one tile
    ("long_segment_slim13", (30000, 13, 32, 32, 0.02, 0.9),
     dict(w=32, h=32, pair_capacity=60000)),
    ("long_segment_z_order", (30000, 13, 32, 32, 0.02, 0.9),
     dict(w=32, h=32, pair_capacity=60000, z_order=True)),
    ("long_segment_wide16", (30000, 14, 128, 32, 0.02, 0.9),
     dict(w=128, h=32, pair_capacity=60000, fmt="wide16", tile_w=128)),
    # the buffer's end cuts a triangle's run part way (checked below)
    ("overflow_cut_slim13", (300, 1, 256, 160), dict(w=256, h=160, pair_capacity=300)),
    ("overflow_cut_wide16", (300, 1, 256, 160), dict(w=256, h=160, pair_capacity=300,
                                                      fmt="wide16", tile_w=128)),
    # every zq equal: the order within a tile falls to the triangle id
    ("equal_zq", (600, 11, 128, 96, 0.4, 1.0, True, True),
     dict(w=128, h=96, pair_capacity=4800, z_order=True)),
    ("equal_zq_overflow", (600, 11, 128, 96, 0.4, 1.0, True, True),
     dict(w=128, h=96, pair_capacity=1000, z_order=True)),
    # tri_bits 20, zq_max 1023: the widest z_order key of the SunTemple scene
    ("z_order_tri_bits20", ((1 << 19) + 1, 15, 1024, 1024, 0.01, 1.0),
     dict(w=1024, h=1024, pair_capacity=(1 << 21), z_order=True)),
    # more than 4,096 tiles: the scan's block walks the histogram in steps
    ("tiles_5184", (3000, 16, 2304, 2304, 0.03, 0.95), dict(w=2304, h=2304, pair_capacity=16000)),
    ("tiles_5184_z_order", (3000, 16, 2304, 2304, 0.03, 0.95),
     dict(w=2304, h=2304, pair_capacity=8000, z_order=True)),
    # contention: thousands of triangles with their pairs in the same few tiles
    ("contention", (4000, 17, 256, 160, 0.01, 0.05), dict(w=256, h=160, pair_capacity=8000)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,sargs,kw", BIN_CASES, ids=[c[0] for c in BIN_CASES])
def test_binning_kernel_matches_plain(cuda, name, sargs, kw):
    s = _small_setup(*sargs[:4], cuda, *sargs[4:])
    kw = dict(kw)
    w, h = kw.pop("w"), kw.pop("h")
    before = binning.bin_triangles.launches
    got = binning.bin_triangles(s, w, h, 32, **kw)
    assert binning.bin_triangles.launches == before + 1
    _bins_bit_equal(got, binning.bin_triangles_plain(s, w, h, 32, **kw))
    if name.startswith("long_segment"):   # the long sort, and its merge
        assert binning.long_path_tiles(got, binning.RADIX_KEYS) == 1
    if name.startswith("overflow_cut"):
        assert _cut_inside_run(s, w, h, kw.get("tile_w", 32), kw["pair_capacity"])
    if name.startswith("equal_zq"):
        assert int(got.total_pairs) > 0 and (got.chunk_minz == got.chunk_minz[0]).all()
    if name.startswith("tiles_5184"):
        assert got.starts.shape[0] == 72 * 72 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("radix_keys", [binning.RADIX_KEYS, 40], ids=["radix", "merge"])
@pytest.mark.parametrize("name", ["band_y48", "wide16_chunk16", "overflow_cut_wide16", "equal_zq",
                                  "equal_zq_overflow", "contention", "long_segment_z_order"])
def test_binning_long_path_forced(cuda, name, radix_keys):
    """The sort's long paths forced by small thresholds: runs of more than
    32 keys radix-sorted by the long sort, and with radix_keys 40 pieces of
    40 keys merged in global memory; the same bits."""
    sargs, kw = next((c[1], dict(c[2])) for c in BIN_CASES if c[0] == name)
    s = _small_setup(*sargs[:4], cuda, *sargs[4:])
    w, h = kw.pop("w"), kw.pop("h")
    plan = binning._plan(s, w, h, 32, sort_keys=32, radix_keys=radix_keys, **kw)
    binning._launch(plan)
    assert binning.long_path_tiles(plan.bins, 32 if radix_keys == binning.RADIX_KEYS
                                   else radix_keys) > 0
    _bins_bit_equal(plan.bins, binning.bin_triangles_plain(s, w, h, 32, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["slim13", "slim13_z_order", "wide16"])
def test_binning_kernel_real_passes(cuda, fmt):
    """The camera and sun passes of a 640x384 SunTemple frame (detail 1.0,
    the preview's scene), bins bit for bit in each format."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import (frame_inputs, init_frame_state,
                                                            make_camera)
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=640, height=384, shadow_map_size=1024)
    scene = build_scene(suntemple.build_parts(1.0), suntemple.materials(), texture_size=16,
                        device=cuda)
    cam = make_camera(*suntemple.camera_path(0.0), cfg, device=cuda)
    fi = frame_inputs(init_frame_state(cfg, cuda), cam, (50.0, 30.0), cfg)
    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    kw = dict(pair_capacity=3 * scene.num_tris, chunk=128, z_order=fmt == "slim13_z_order")
    if fmt == "wide16":
        kw.update(fmt="wide16", tile_w=128)
    for mat, size, cull, jitter in ((cam.clip_from_world, (640, 384), "back", fi.jitter),
                                    (fi.sun_from_world, (1024, 1024), "none", None)):
        s = setup.setup_triangles(setup.transform_to_clip(tri_pos, mat, jitter), *size, cull=cull)
        got = binning.bin_triangles(s, *size, 32, **kw)
        assert int(got.total_pairs) > 0
        _bins_bit_equal(got, binning.bin_triangles_plain(s, *size, 32, **kw))


@pytest.mark.cuda
def test_binning_wrapper_rejects_bad_inputs(cuda):
    """Inputs the kernels do not take raise; nothing falls back to the plain
    version (no launch counted, no bins returned)."""
    s = _small_setup(50, 2, 64, 64, cuda)
    before = binning.bin_triangles.launches
    with pytest.raises(TypeError, match="bbox"):
        binning.bin_triangles(s._replace(bbox=s.bbox.long()), 64, 64, 32)
    with pytest.raises(TypeError, match="valid"):
        binning.bin_triangles(s._replace(valid=s.valid.cpu()), 64, 64, 32)
    with pytest.raises(TypeError, match="z_vert"):
        binning.bin_triangles(s._replace(z_vert=s.z_vert[:10]), 64, 64, 32)
    with pytest.raises(ValueError, match="unknown binning fmt"):
        binning.bin_triangles(s, 64, 64, 32, fmt="wide13")
    with pytest.raises(ValueError, match="sort_keys"):
        binning._plan(s, 64, 64, 32, sort_keys=48)
    with pytest.raises(ValueError, match="radix_keys"):
        binning._plan(s, 64, 64, 32, radix_keys=binning.RADIX_KEYS + 1)
    assert binning.bin_triangles.launches == before


# ---------------------------------------------------------------------------
# the post kernels (csrc/post.cu)

TAA_MODES = {"ycocg": dict(catmull_history=True), "full_rgb": dict(full_rgb_catmull=True),
             "bilinear": dict(catmull_history=False)}


def _taa_ins(h, w, dev, seed=21, sigma=0.02, offscreen=False):
    """lighting, depth, velocity (sigma uv), velocity_prev, history; offscreen:
    the left third's velocity x at 1.5 uv, reprojected past the frame."""
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0, 4, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32),
            rng.normal(0, sigma, (h, w, 2)).astype(np.float32),
            rng.normal(0, sigma, (h, w, 2)).astype(np.float32),
            rng.uniform(0, 4, (h, w, 3)).astype(np.float32)]
    if offscreen:
        arrs[2][:, : w // 3, 0] = 1.5
    return [torch.from_numpy(a).to(dev) for a in arrs]


def _same(got, want, atol=0.0):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


TAA_VELOCITIES = {"still": (0.0, False), "sigma0.02": (0.02, False), "sigma0.2": (0.2, False),
                  "offscreen": (0.02, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("velocity", list(TAA_VELOCITIES))
@pytest.mark.parametrize("mode", list(TAA_MODES))
@pytest.mark.parametrize("h,w", [(96, 160), (272, 480), (7, 143)])
def test_post_taa_kernel_matches_plain(cuda, mode, h, w, velocity):
    """TAA bit for bit against taa_resolve_plain: whole, over row windows
    (from odd rows among them, and at the frame's edges) and as the halo
    band; velocities of sigma 0, 0.02 and 0.2 uv (the last reprojects
    taps tens of texels away) and a third of the frame reprojected off
    screen."""
    sigma, offscreen = TAA_VELOCITIES[velocity]
    ins = _taa_ins(h, w, cuda, sigma=sigma, offscreen=offscreen)
    kw = TAA_MODES[mode]
    before = taa.taa_resolve.launches
    _same(taa.taa_resolve(*ins, **kw), taa.taa_resolve_plain(*ins, **kw))
    n = min(8, h)
    windows = {(0, n), (1, min(7, h - 1)), (h // 3 | 1, max(1, h // 2 - (h // 3 | 1))),
               (h - n, n), (h - 1, 1), (0, h)}
    for y0, rows in sorted(windows):
        got = taa.taa_resolve(*ins, row_begin=y0, row_count=rows, **kw)
        slabs = [sampling.edge_rows(t, y0, rows, 1, 1) for t in ins[:3]]
        _same(got, taa.taa_resolve_plain(*slabs, *ins[3:], halo=1, row_offset=y0,
                                         full_height=h, **kw))
        hk = dict(kw, halo=1, row_offset=y0, full_height=h)
        _same(taa.taa_resolve(*slabs, *ins[3:], **hk),
              taa.taa_resolve_plain(*slabs, *ins[3:], **hk))
    assert taa.taa_resolve.launches == before + 1 + 2 * len(windows)


def _plain_chain(hdr, passes):
    sizes = bloom.chain_sizes(hdr.shape[0], hdr.shape[1], passes)
    downs, cur = [], hdr
    for i in range(1, passes + 1):
        cur = bloom.bloom_down_level_plain(cur, *sizes[i], i == 1).contiguous()
        downs.append(cur)
    return downs


@pytest.mark.cuda
@pytest.mark.parametrize("shape,passes", [((1088, 1920), 6), ((64, 64), 6), ((2, 4), 3),
                                          ((1080, 1920), 6), ((135, 240), 4), ((54, 96), 3),
                                          ((9, 17), 4)])
def test_post_bloom_chain_matches_plain(cuda, shape, passes):
    """Each level on the plain version's input; the atlas; the fused final
    level.  Bits at 2:1, 1e-5 at odd sizes."""
    rng = np.random.default_rng(22)
    hdr = torch.from_numpy(rng.uniform(0, 3, shape + (3,)).astype(np.float32)).to(cuda)
    h, w = shape
    sizes = bloom.chain_sizes(h, w, passes)
    plain = _plain_chain(hdr, passes)
    atlas, offs = bloom.new_atlas(h, w, passes, cuda)
    before = (bloom.bloom_down_level.launches, bloom.bloom_up_level.launches)
    for i in range(1, passes + 1):
        src = hdr if i == 1 else plain[i - 2]
        exact = tuple(src.shape[:2]) == (2 * sizes[i][0], 2 * sizes[i][1])
        _same(bloom.bloom_down_level(src, *sizes[i], i == 1, atlas=atlas,
                                     atlas_col=offs[i - 1]),
              plain[i - 1], 0.0 if exact else 1e-5)
    want_atlas = sampling.pack_mip_atlas(plain).to(torch.bfloat16).float()
    torch.testing.assert_close(atlas.float(), want_atlas, rtol=2.0 ** -7, atol=1e-5)
    cur = plain[-1]
    for i in range(passes - 1, -1, -1):
        kw = dict(base=hdr, exposure=1.1) if i == 0 else {}
        factor = 0.06 if i == 0 else 1.0
        exact = sizes[i] == (2 * cur.shape[0], 2 * cur.shape[1])
        _same(bloom.bloom_up_level(cur, *sizes[i], factor, **kw),
              bloom.bloom_up_level_plain(cur, *sizes[i], factor, **kw), 0.0 if exact else 1e-5)
        cur = bloom.bloom_up_level_plain(cur, *sizes[i], 1.0).contiguous()
    assert (bloom.bloom_down_level.launches, bloom.bloom_up_level.launches) == (
        before[0] + passes, before[1] + passes)


CHAIN_CASES = [((1088, 1920), 6), ((64, 96), 5), ((64, 64), 1), ((1080, 1920), 6),
               ((68, 120), 4), ((135, 240), 4), ((9, 17), 4), ((2, 4), 3), ((24, 40), 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_atlas", [True, False], ids=["atlas", "no_atlas"])
@pytest.mark.parametrize("shape,passes", CHAIN_CASES)
def test_post_bloom_down_chain_matches_plain(cuda, shape, passes, with_atlas):
    """The one-launch chain against the plain chain: bits while the chain is
    2:1, 1e-5 from its first odd level on; its atlas (zero rows included)
    equal where the chain is 2:1, within a bf16 step otherwise; and its
    levels and atlas equal to per-level bloom_down_level launches bit for
    bit everywhere (the same arithmetic on the same inputs)."""
    rng = np.random.default_rng(24)
    h, w = shape
    hdr = torch.from_numpy(rng.uniform(0, 3, shape + (3,)).astype(np.float32)).to(cuda)
    sizes = bloom.chain_sizes(h, w, passes)
    atlas, offs = bloom.new_atlas(h, w, passes, cuda) if with_atlas else (None, None)
    if with_atlas:
        atlas.fill_(7.0)     # every texel of the bands is written
    before = (bloom.bloom_down_chain.launches, bloom.bloom_down_level.launches)
    got = bloom.bloom_down_chain(hdr, passes, atlas, offs)
    assert (bloom.bloom_down_chain.launches, bloom.bloom_down_level.launches) == (
        before[0] + 1, before[1])
    plain = _plain_chain(hdr, passes)
    exact = True
    for i in range(1, passes + 1):
        exact = exact and sizes[i - 1] == (2 * sizes[i][0], 2 * sizes[i][1])
        assert got[i - 1].is_contiguous()
        _same(got[i - 1], plain[i - 1], 0.0 if exact else 1e-5)
    atlas_l = None
    if with_atlas:
        want = sampling.pack_mip_atlas(plain).to(torch.bfloat16)
        if exact:
            _same(atlas.view(torch.int16), want.view(torch.int16))
        torch.testing.assert_close(atlas.float(), want.float(), rtol=2.0 ** -7, atol=1e-5)
        atlas_l = torch.full_like(atlas, 7.0)
    cur = hdr
    for i in range(1, passes + 1):
        cur = bloom.bloom_down_level(cur, *sizes[i], i == 1, atlas=atlas_l,
                                     atlas_col=offs[i - 1] if with_atlas else 0)
        _same(got[i - 1], cur)
    if with_atlas:
        _same(atlas.view(torch.int16), atlas_l.view(torch.int16))


@pytest.mark.cuda
def test_post_bloom_down_chain_repeats(cuda):
    """Launches of two shapes in turn, each the same bits every time (each
    launch marks its units' flags with a new epoch), on a side stream too."""
    rng = np.random.default_rng(25)
    ins = [(torch.from_numpy(rng.uniform(0, 3, (h, w, 3)).astype(np.float32)).to(cuda), p)
           for (h, w), p in (((1088, 1920), 6), ((68, 120), 4))]
    first = [bloom.bloom_down_chain(x, p) for x, p in ins]
    side = torch.cuda.Stream()
    for rep in range(3):
        for (x, p), want in zip(ins, first):
            if rep == 2:
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    got = bloom.bloom_down_chain(x, p)
                torch.cuda.current_stream().wait_stream(side)
            else:
                got = bloom.bloom_down_chain(x, p)
            for g, wnt in zip(got, want):
                _same(g, wnt)


@pytest.mark.cuda
def test_post_bloom_down_chain_rejects_bad_inputs(cuda):
    hdr = torch.rand((64, 96, 3), device=cuda)
    atlas, offs = bloom.new_atlas(64, 96, 3, cuda)
    before = bloom.bloom_down_chain.launches
    with pytest.raises(ValueError, match="float32"):
        bloom.bloom_down_chain(hdr.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        bloom.bloom_down_chain(hdr.transpose(0, 1).contiguous().transpose(0, 1), 3)
    with pytest.raises(ValueError, match="bfloat16"):
        bloom.bloom_down_chain(hdr, 3, atlas.float(), offs)
    with pytest.raises(ValueError, match="does not fit"):
        bloom.bloom_down_chain(hdr, 3, atlas[:, :50].contiguous(), offs)
    with pytest.raises(ValueError, match="offsets"):
        bloom.bloom_down_chain(hdr, 3, atlas)
    with pytest.raises(ValueError, match="passes"):
        bloom.bloom_down_chain(hdr, bloom.MAX_CHAIN_LEVELS + 1)
    assert bloom.bloom_down_chain(hdr, 0) == []
    assert bloom.bloom_down_chain.launches == before


@pytest.mark.cuda
def test_post_bloom_windows_and_source_band(cuda):
    rng = np.random.default_rng(23)
    hdr = torch.from_numpy(rng.uniform(0, 3, (128, 192, 3)).astype(np.float32)).to(cuda)
    d1 = bloom.bloom_down_level_plain(hdr, 64, 96, True)
    for win in ((0, 16), (16, 32), (48, 16)):
        _same(bloom.bloom_down_level(hdr, 64, 96, True, rows=win),
              bloom.bloom_down_level_plain(hdr, 64, 96, True, rows=win))
    for win in ((0, 32), (32, 64), (96, 32)):
        kw = dict(base=hdr[win[0]:win[0] + win[1]], exposure=1.0, rows=win)
        _same(bloom.bloom_up_level(d1, 128, 192, 0.06, **kw),
              bloom.bloom_up_level_plain(d1, 128, 192, 0.06, **kw))
    atlas, offs = bloom.new_atlas(128, 192, 2, cuda)
    want = atlas.clone()
    bloom.bloom_down_level(d1, 32, 48, atlas=atlas, atlas_col=offs[1], src_atlas_col=offs[0])
    bloom.bloom_down_level_plain(d1, 32, 48, atlas=want, atlas_col=offs[1],
                                 src_atlas_col=offs[0])
    _same(atlas.view(torch.int16), want.view(torch.int16))


UP_CHAIN_CASES = [((1088, 1920), 6), ((64, 96), 5), ((64, 64), 6), ((64, 64), 1),
                  ((1080, 1920), 6), ((135, 240), 4), ((54, 96), 3), ((96, 160), 3),
                  ((9, 17), 4), ((2, 4), 3), ((24, 40), 6)]


def _up_levels(deepest, h, w, passes, strength, base, exposure, rows):
    """The up chain as per-level bloom_up_level launches."""
    sizes = bloom.chain_sizes(h, w, passes)
    cur = deepest
    for i in range(passes - 1, 0, -1):
        cur = bloom.bloom_up_level(cur, *sizes[i], 1.0)
    return bloom.bloom_up_level(cur, h, w, strength, base=base, exposure=exposure, rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("exposure", [1.2, None], ids=["tonemap", "no_tonemap"])
@pytest.mark.parametrize("window", ["whole", "half", "odd"])
@pytest.mark.parametrize("shape,passes", UP_CHAIN_CASES)
def test_post_bloom_up_chain_matches_plain(cuda, shape, passes, window, exposure):
    """The one-launch up chain against the plain chain: bits where every
    level is exactly 2x, 1e-5 where one takes the linear resize (the plain
    version's einsum sums in its own order); and bit for bit against the
    per-level launches everywhere (the same arithmetic on the same inputs);
    whole, over the last level's top half, and over a window that starts on
    an odd row."""
    rng = np.random.default_rng(26)
    h, w = shape
    sizes = bloom.chain_sizes(h, w, passes)
    rows = {"whole": None, "half": (0, max(1, h // 2)),
            "odd": (min(h // 3 | 1, h - 1), max(1, h // 3))}[window]
    rb, rc = rows if rows is not None else (0, h)
    deepest = torch.from_numpy(rng.uniform(0, 3, sizes[passes] + (3,)).astype(np.float32)).to(cuda)
    base = torch.from_numpy(rng.uniform(0, 3, (rc, w, 3)).astype(np.float32)).to(cuda)
    before = (bloom.bloom_up_chain.launches, bloom.bloom_up_level.launches)
    got = bloom.bloom_up_chain(deepest, h, w, passes, 0.06, base, exposure, rows)
    assert (bloom.bloom_up_chain.launches, bloom.bloom_up_level.launches) == (
        before[0] + 1, before[1])
    exact = all(sizes[i] == (2 * sizes[i + 1][0], 2 * sizes[i + 1][1]) for i in range(passes))
    _same(got, bloom.bloom_up_chain_plain(deepest, h, w, passes, 0.06, base, exposure, rows),
          0.0 if exact else 1e-5)
    _same(got, _up_levels(deepest, h, w, passes, 0.06, base, exposure, rows))


@pytest.mark.cuda
def test_post_bloom_up_chain_repeats(cuda):
    """Launches of two shapes and windows in turn, each the same bits every
    time (each launch marks its units' flags with a new epoch), on a side
    stream too."""
    rng = np.random.default_rng(27)
    cases = []
    for (h, w), p, rows in (((1088, 1920), 6, None), ((68, 120), 4, (9, 40))):
        deepest = torch.from_numpy(rng.uniform(
            0, 3, bloom.chain_sizes(h, w, p)[p] + (3,)).astype(np.float32)).to(cuda)
        rc = rows[1] if rows else h
        base = torch.from_numpy(rng.uniform(0, 3, (rc, w, 3)).astype(np.float32)).to(cuda)
        cases.append((deepest, h, w, p, 0.06, base, 1.1, rows))
    first = [bloom.bloom_up_chain(*c) for c in cases]
    side = torch.cuda.Stream()
    for rep in range(3):
        for c, want in zip(cases, first):
            if rep == 2:
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    got = bloom.bloom_up_chain(*c)
                torch.cuda.current_stream().wait_stream(side)
            else:
                got = bloom.bloom_up_chain(*c)
            _same(got, want)


@pytest.mark.cuda
def test_post_bloom_up_chain_rejects_bad_inputs(cuda):
    deepest = torch.rand((8, 12, 3), device=cuda)
    base = torch.rand((64, 96, 3), device=cuda)
    before = bloom.bloom_up_chain.launches
    with pytest.raises(ValueError, match="float32"):
        bloom.bloom_up_chain(deepest.half(), 64, 96, 3, 0.06, base)
    with pytest.raises(ValueError, match="contiguous"):
        bloom.bloom_up_chain(deepest.transpose(0, 1).contiguous().transpose(0, 1), 64, 96, 3,
                             0.06, base)
    with pytest.raises(ValueError, match="shape"):
        bloom.bloom_up_chain(deepest, 64, 96, 2, 0.06, base)
    with pytest.raises(ValueError, match="base"):
        bloom.bloom_up_chain(deepest, 64, 96, 3, 0.06, base[:32])
    with pytest.raises(ValueError, match="rows"):
        bloom.bloom_up_chain(deepest, 64, 96, 3, 0.06, base, rows=(60, 8))
    with pytest.raises(ValueError, match="passes"):
        bloom.bloom_up_chain(deepest, 64, 96, 0, 0.06, base)
    assert bloom.bloom_up_chain.launches == before


@pytest.mark.cuda
def test_post_bloom_up_chain_occupancy(cuda):
    """At most 64 registers, no local memory, at least 4 blocks of 256
    threads resident per SM."""
    occ = bloom.up_chain_occupancy()
    assert occ["threads"] == 256 and occ["local_bytes"] == 0, occ
    assert occ["registers"] <= 64 and occ["blocks_per_sm"] >= 4, occ


def _post_plain(hdr, depth, vel, state, cfg):
    """post_stack composed of the plain versions on the same device."""
    if cfg.enable_taa:
        history = hdr if state.frame_idx == 0 else state.taa_history
        taa_out = taa.taa_resolve_plain(hdr, depth, vel, state.velocity_prev, history,
                                        cfg.taa_blend, cfg.taa_velocity_rejection,
                                        catmull_history=cfg.taa_catmull_history,
                                        full_rgb_catmull=cfg.taa_full_rgb_catmull)
    else:
        taa_out = hdr
    if not cfg.enable_bloom:
        return (bloom.bloom_up_level_plain(None, cfg.height, cfg.width, base=taa_out,
                                           exposure=cfg.exposure), taa_out, state.prev_pyramid)
    passes = cfg.bloom_pass_count
    downs = _plain_chain(taa_out, passes)
    sizes = bloom.chain_sizes(cfg.height, cfg.width, passes)
    cur = downs[-1]
    for i in range(passes - 1, 0, -1):
        cur = bloom.bloom_up_level_plain(cur, *sizes[i], 1.0)
    final = bloom.bloom_up_level_plain(cur, cfg.height, cfg.width, cfg.bloom_strength,
                                       base=taa_out, exposure=cfg.exposure)
    return final, taa_out, sampling.pack_mip_atlas(downs).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("enable_bloom", [True, False], ids=["bloom", "no_bloom"])
@pytest.mark.parametrize("enable_taa", [True, False], ids=["taa", "no_taa"])
def test_post_stack_runs_kernels_only(cuda, enable_taa, enable_bloom):
    """post_stack on the card: exactly 1 TAA, 1 down-chain and 1 up-chain
    launch (no per-level launch; bloom off: 1 tonemap launch of the per-level
    up kernel), equal to the plain stack."""
    cfg = RenderConfig(width=192, height=128, bloom_pass_count=4, enable_taa=enable_taa,
                       enable_bloom=enable_bloom)
    state = trender.init_frame_state(cfg, cuda)
    counters = (taa.taa_resolve, bloom.bloom_down_chain, bloom.bloom_down_level,
                bloom.bloom_up_chain, bloom.bloom_up_level)
    for frame in range(2):
        hdr, depth, vel, _, _ = _taa_ins(128, 192, cuda, seed=30 + frame)
        counts = [f.launches for f in counters]
        got = trender.post_stack(hdr, depth, vel, state, cfg)
        assert [f.launches - c for f, c in zip(counters, counts)] == [
            int(enable_taa), int(enable_bloom), 0, int(enable_bloom), int(not enable_bloom)]
        want = _post_plain(hdr, depth, vel, state, cfg)
        for g, wnt in zip(got, want):
            _same(g.float(), wnt.float())
        state.taa_history, state.velocity_prev, state.prev_pyramid = got[1], vel, got[2]
        state.frame_idx += 1


@pytest.mark.cuda
def test_post_wrappers_reject_bad_inputs(cuda):
    ins = _taa_ins(32, 48, cuda)
    hdr = ins[0]
    counts = (taa.taa_resolve.launches, bloom.bloom_down_level.launches,
              bloom.bloom_up_level.launches)
    with pytest.raises(ValueError, match="float32"):
        taa.taa_resolve(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="float32"):
        taa.taa_resolve(*ins[:4], ins[4].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        taa.taa_resolve(ins[0].transpose(0, 1).contiguous().transpose(0, 1), *ins[1:])
    with pytest.raises(ValueError, match="float32"):
        bloom.bloom_down_level(hdr.half(), 16, 24)
    with pytest.raises(ValueError, match="contiguous"):
        bloom.bloom_down_level(hdr.transpose(0, 1).contiguous().transpose(0, 1), 16, 24)
    atlas, offs = bloom.new_atlas(32, 48, 2, "cpu")
    with pytest.raises(ValueError, match="atlas"):
        bloom.bloom_down_level(hdr, 16, 24, atlas=atlas, atlas_col=offs[0])
    with pytest.raises(ValueError, match="base"):
        bloom.bloom_up_level(hdr[:16, :24].contiguous(), 32, 48, base=hdr.cpu(), exposure=1.0)
    with pytest.raises(ValueError, match="float32"):
        bloom.bloom_up_level(hdr[:16, :24].contiguous().double(), 32, 48)
    assert (taa.taa_resolve.launches, bloom.bloom_down_level.launches,
            bloom.bloom_up_level.launches) == counts


# ---------------------------------------------------------------------------
# the G-buffer and lighting kernels (csrc/gbuffer.cu, csrc/lighting.cu)
# against their plain versions on the card, on the seed-made frames of
# tests/test_torch_shade_inputs.py: every material filter, ragged frames
# (1x1, 7x143) and odd row bands; the GI lane inputs in both interleave
# patterns and parities and a separate diffuse grid; the polar shafts at
# divisors 1 and 4; the shade with GI on and off, IBL off, shadows off, the
# half- and full-resolution sky.  Every output bit for bit: the kernels
# mirror PyTorch's arithmetic on the card (csrc/shade_common.cuh: the
# reduction order over 3, the fused product of torch.linalg.cross, a
# division by a Python number as a product with its f32 reciprocal,
# fmod-based remainder; measured on the H100).

SHADE_ATOL = 0.0


def _shade_inputs():
    import test_torch_shade_inputs

    return test_torch_shade_inputs


def _fields_close(got, want, what, atol=SHADE_ATOL):
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None and b is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if a.dtype == torch.bool or name in ("depth",):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{what} {name}")
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f"{what} {name}")


GB_CASES = [("48x64", 48, 64, None), ("1x1", 1, 1, None), ("7x143", 7, 143, None),
            ("band_13_21", 48, 64, (13, 21))]


@pytest.mark.cuda
@pytest.mark.parametrize("material_filter", ["stochastic", "trilinear", "nearest"])
@pytest.mark.parametrize("name,h,w,band", GB_CASES, ids=[c[0] for c in GB_CASES])
def test_gbuffer_kernel_matches_plain(cuda, material_filter, name, h, w, band):
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    static = gb.gbuffer_static(scene)
    kw, _, _ = si.gbuffer_inputs(scene, h, w, band=band, device=cuda)
    before = gb.gbuffer_pass.launches
    got = gb.gbuffer_pass(scene, kw["setup"], kw["depth"], kw["tri_id"], kw["clip_from_world"],
                          kw["old_clip_from_world"], 0.3, world_from_clip=kw["world_from_clip"],
                          jitter=kw["jitter"], material_filter=material_filter,
                          frame_idx_mod_59=kw["frame_idx_mod_59"],
                          row_offset=kw["row_offset"], full_size=kw["full_size"], static=static)
    assert gb.gbuffer_pass.launches == before + 1
    want = gb.gbuffer_pass_plain(scene, static, kw["setup"], kw["depth"], kw["tri_id"],
                                 kw["clip_from_world"], kw["old_clip_from_world"], 0.3,
                                 kw["world_from_clip"], kw["jitter"], material_filter,
                                 kw["frame_idx_mod_59"], kw["row_offset"], kw["full_size"])
    torch.cuda.synchronize()
    _fields_close(got, want, f"gbuffer {name} {material_filter}")


GB_TILE_CASES = [("37x50", 37, 50, None), ("33x70", 33, 70, None), ("9x17", 9, 17, None),
                 ("band_11_17", 40, 70, (11, 17)), ("band_5_3", 24, 36, (5, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("material_filter", ["stochastic", "trilinear", "nearest"])
@pytest.mark.parametrize("name,h,w,band", GB_TILE_CASES, ids=[c[0] for c in GB_TILE_CASES])
def test_gbuffer_tiles_match_plain(cuda, material_filter, name, h, w, band):
    """The tiled G-buffer bit for bit on frames that are not tile multiples,
    whose rows do not start on 16-byte lines (widths not a multiple of 16),
    and in bands at odd row offsets."""
    test_gbuffer_kernel_matches_plain(cuda, material_filter, name, h, w, band)


@pytest.mark.cuda
def test_gbuffer_rejects_misaligned_atlas(cuda):
    """An atlas that does not start on a 16-byte line raises (the kernel
    reads its texels as 16-byte loads)."""
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    kw, _, _ = si.gbuffer_inputs(scene, 16, 16, device=cuda)
    atlas = scene.tex_packed
    moved = torch.empty(atlas.numel() + 16, dtype=torch.uint8, device=cuda)[4:4 + atlas.numel()]
    moved = moved.view(atlas.shape)
    moved.copy_(atlas)
    before = gb.gbuffer_pass.launches
    with pytest.raises(ValueError, match="16-byte"):
        gb.gbuffer_pass(scene._replace(tex_packed=moved), kw["setup"], kw["depth"],
                        kw["tri_id"], kw["clip_from_world"], kw["old_clip_from_world"])
    assert gb.gbuffer_pass.launches == before


@pytest.mark.cuda
def test_gbuffer_occupancy(cuda):
    """A 256-pixel tile, at most 64 registers, no local memory, at least 4
    blocks resident per SM."""
    occ = gb.gbuffer_occupancy()
    assert occ["tile_w"] * occ["tile_h"] == 256 and occ["local_bytes"] == 0, occ
    assert occ["registers"] <= 64 and occ["blocks_per_sm"] >= 4, occ


LANE_CASES = [("columns_0", 2, "columns", 0, True), ("columns_1", 2, "columns", 1, True),
              ("checker_0", 2, "checker", 0, True), ("checker_1", 2, "checker", 1, True),
              ("every_lane_k1", 1, None, 0, True), ("diffuse_k4", 4, None, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,pattern,parity,specular", LANE_CASES,
                         ids=[c[0] for c in LANE_CASES])
def test_gi_inputs_kernel_matches_plain(cuda, name, k, pattern, parity, specular):
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    for h, w, band in ((48, 64, None), (48, 64, (12, 24)), (7, 143, None)):
        rows = band[1] if band is not None else h
        if pattern is not None and ((-(-w // k)) % 2 or (-(-rows // k)) % 2):
            continue
        g, glob, _, kw = si.lighting_inputs(scene, h, w, band=band, device=cuda)
        args = (g.normal, g.orm, g.depth, glob.world_from_clip, glob.view_from_clip,
                glob.camera_pos, k, 7.0, kw["row_offset"], h, pattern, parity, specular)
        before = gi_modes.gi_lane_inputs.launches
        got = gi_modes.gi_lane_inputs(*args)
        assert gi_modes.gi_lane_inputs.launches == before + 1
        want = gi_modes.gi_lane_inputs_plain(*args)
        torch.cuda.synchronize()
        _fields_close(got, want, f"gi lanes {name} {h}x{w} band {band}")


@pytest.mark.cuda
@pytest.mark.parametrize("n_r", [12, 48])
@pytest.mark.parametrize("k", [1, 4])
def test_shafts_kernel_matches_plain(cuda, k, n_r):
    """The one-launch shafts bit for bit against shafts_polar_plain: one
    launch a call; two shapes called in turns, twice each (a plan per
    shape, a new epoch every launch), then a band; n_r 12 (scalar row
    reads) and 48 (16-byte lines)."""
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    frames = {}
    for h, w, band in ((48, 64, None), (7, 143, None), (48, 64, None), (7, 143, None),
                       (48, 64, (13, 21))):
        if (h, w, band) not in frames:
            frames[h, w, band] = si.lighting_inputs(scene, h, w, band=band, device=cuda)
        g, glob, tables, kw = frames[h, w, band]
        em = lighting.sun_emission(si.frame_config(h, w))
        args = (tables["sun_depth"], glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
                glob.world_from_clip, glob.view_from_clip, k, 3.0)
        kwargs = dict(intensity=0.001, normal_offset=0.1, max_steps=n_r, n_theta=4096, n_r=n_r,
                      row_offset=kw["row_offset"], full_height=h)
        before = shadow.shafts_polar.launches
        got = shadow.shafts_polar(*args, em, **kwargs)
        assert shadow.shafts_polar.launches == before + 1
        want = shadow.shafts_polar_plain(*args, torch.as_tensor(em, device=cuda), **kwargs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=SHADE_ATOL,
                                   msg=f"shafts k={k} n_r={n_r} {h}x{w} band {band}")


SHADE_CASES = [("gi", {}, True), ("gi_no_shadows", dict(enable_shadows=False), True),
               ("ibl", dict(enable_gi=False), False),
               ("no_ibl", dict(enable_gi=False, enable_ibl=False), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,changes,gi_on", SHADE_CASES, ids=[c[0] for c in SHADE_CASES])
@pytest.mark.parametrize("h,w,band", [(48, 64, None), (48, 64, (13, 21)), (7, 143, None),
                                      (1, 1, None)], ids=["48x64", "band", "7x143", "1x1"])
def test_shade_kernel_matches_plain(cuda, name, changes, gi_on, h, w, band):
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    g, glob, tables, kw = si.lighting_inputs(scene, h, w, band=band, device=cuda)
    cfg = si.frame_config(h, w, **changes)
    args = (g, glob, cfg, tables["sun_u16"] if cfg.enable_shadows else None, tables["lut16"],
            tables["env"], tables["shafts"] if cfg.enable_shadows else None,
            tables["ambient"] if gi_on else None, tables["spec"] if gi_on else None,
            kw["row_offset"], h)
    before = lighting.shade.launches
    got = lighting.shade(*args)
    assert lighting.shade.launches == before + 1
    want = lighting.shade_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=SHADE_ATOL, msg=f"shade {name}")


TILE_STEP_CASES = [(1, 1), (2, 4), (4, 2), (8, 8), (2, 8), (8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kg,ks", TILE_STEP_CASES, ids=[f"g{g}s{s}" for g, s in TILE_STEP_CASES])
@pytest.mark.parametrize("h,w,band", [(64, 96, None), (44, 72, None), (64, 96, (8, 40)),
                                      (64, 96, (21, 27))],
                         ids=["64x96", "44x72", "band8", "band21"])
def test_shade_tiles_match_plain(cuda, kg, ks, h, w, band):
    """The tiled shade bit for bit against shade_plain on frames that are not
    tile multiples, in bands (with a row offset; the sky at full
    resolution) and with the grids 0-3 exact 2x steps below the pixels (or
    upsampled before the launch where they do not reach the frame so), GI
    on, GI on without shadows, the static IBL and neither (no LUT).  Part of
    every frame is sky."""
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    g, glob, tables, kw = si.lighting_inputs(scene, h, w, band=band, device=cuda, kg=kg, ks=ks)
    assert bool((~g.coverage).any()) and bool(g.coverage.any())
    for name, changes, gi_on in SHADE_CASES:
        cfg = si.frame_config(h, w, **changes)
        args = (g, glob, cfg, tables["sun_u16"] if cfg.enable_shadows else None,
                tables["lut16"], tables["env"], tables["shafts"] if cfg.enable_shadows else None,
                tables["ambient"] if gi_on else None, tables["spec"] if gi_on else None,
                kw["row_offset"], h)
        got = lighting.shade(*args)
        want = lighting.shade_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=SHADE_ATOL,
                                   msg=f"shade {name} kg={kg} ks={ks}")


@pytest.mark.cuda
def test_shade_occupancy(cuda):
    """At least 3 blocks of 256 threads resident per SM."""
    occ = lighting.shade_occupancy()
    assert occ["tile_w"] * occ["tile_h"] == 256
    assert occ["blocks_per_sm"] >= 3, occ


@pytest.mark.cuda
def test_render_frame_runs_slice_kernels(cuda):
    """A 160x96 fast-GI frame on the card: one G-buffer launch, one GI lane
    launch, one shaft launch, one shade launch and one sweep launch a
    frame, and one voxelize_lightgrid launch a sun pass (no launch of the
    sharded frame's voxelize_scene and decode_voxel_grid)."""
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    cfg = si.frame_config(96, 160)
    r = trender.Renderer(cfg, scene, device=cuda, raster_backend="pallas")
    cam = trender.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg, device=cuda)
    counters = (gb.gbuffer_pass, gi_modes.gi_lane_inputs, shadow.shafts_polar, lighting.shade,
                gi.sweep_lightgrid_u8, gi.voxelize_lightgrid, gi.voxelize_scene,
                gi.decode_voxel_grid)
    for frame in range(2):
        before = [f.launches for f in counters]
        img = r.render(cam, si.SUN)
        # the voxelize pass on frame 0 (the sun's first pass): one launch
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1, 1,
                                                                      int(frame == 0), 0, 0]
        assert bool(torch.isfinite(img).all())


@pytest.mark.cuda
def test_lighting_wrappers_reject_bad_inputs(cuda):
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    g, glob, tables, kw = si.lighting_inputs(scene, 48, 64, device=cuda)
    cfg = si.frame_config(48, 64)
    counts = [f.launches for f in (gb.gbuffer_pass, gi_modes.gi_lane_inputs,
                                   shadow.shafts_polar, lighting.shade)]
    with pytest.raises(ValueError, match="int32"):
        gb.gbuffer_pass(scene, kw["setup"], kw["depth"], kw["tri_id"].long(),
                        kw["clip_from_world"], kw["old_clip_from_world"])
    with pytest.raises(ValueError, match="material_filter"):
        gb.gbuffer_pass(scene, kw["setup"], kw["depth"], kw["tri_id"], kw["clip_from_world"],
                        kw["old_clip_from_world"], material_filter="box")
    with pytest.raises(ValueError, match="even lane grid"):
        gi_modes.gi_lane_inputs(g.normal[:, :62].contiguous(), g.orm[:, :62].contiguous(),
                                g.depth[:, :62].contiguous(), glob.world_from_clip,
                                glob.view_from_clip, glob.camera_pos, 2, 3.0,
                                pattern="columns")
    with pytest.raises(ValueError, match="float32"):
        shadow.shafts_polar(tables["sun_depth"].half(), glob.sun_from_world, glob.camera_pos,
                            g.normal, g.depth, glob.world_from_clip, glob.view_from_clip, 4,
                            3.0, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="int16"):
        lighting.shade(g, glob, cfg, tables["sun_u16"].int(), tables["lut16"], tables["env"])
    with pytest.raises(ValueError, match="together"):
        lighting.shade(g, glob, cfg, tables["sun_u16"], tables["lut16"], tables["env"],
                       ambient=tables["ambient"])
    with pytest.raises(ValueError, match="contiguous"):
        lighting.shade(g._replace(normal=g.normal.transpose(0, 1).contiguous().transpose(0, 1)),
                       glob, cfg, tables["sun_u16"], tables["lut16"], tables["env"])
    assert [f.launches for f in (gb.gbuffer_pass, gi_modes.gi_lane_inputs, shadow.shafts_polar,
                                 lighting.shade)] == counts


@pytest.mark.cuda
def test_gi_inputs_plan_fresh_outputs(cuda):
    """Two calls of one shape: one plan, one launch each, outputs that share
    no storage and the same bits; matrices that are not contiguous miss the
    plan's comparison and take the full checks, with the same result."""
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    g, glob, _, kw = si.lighting_inputs(scene, 48, 64, device=cuda)
    args = (g.normal, g.orm, g.depth, glob.world_from_clip, glob.view_from_clip,
            glob.camera_pos, 2, 7.0, 0, 48, "checker", 1, True)
    before = gi_modes.gi_lane_inputs.launches
    first = gi_modes.gi_lane_inputs(*args)
    again = gi_modes.gi_lane_inputs(*args)
    strided = gi_modes.gi_lane_inputs(g.normal, g.orm, g.depth,
                                      glob.world_from_clip.t().contiguous().t(),
                                      *args[4:])
    assert gi_modes.gi_lane_inputs.launches == before + 3
    assert first.pw.untyped_storage().data_ptr() != again.pw.untyped_storage().data_ptr()
    torch.cuda.synchronize()
    _fields_close(again, first, "gi lanes again")
    _fields_close(strided, first, "gi lanes, strided matrix")
    _fields_close(first, gi_modes.gi_lane_inputs_plain(*args), "gi lanes plan")


def _sweep_grid(shape, occupied, seed, dev):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 3, tuple(shape) + (4,)).astype(np.float32)
    g[..., 3] = rng.random(tuple(shape)) < occupied
    return torch.from_numpy(g).to(dev)


def _sweep_same(grid, axis):
    before = gi.sweep_lightgrid_u8.launches
    out, table = gi.sweep_lightgrid_u8(grid, axis)
    assert gi.sweep_lightgrid_u8.launches == before + 1
    want = gi.sweep_lightgrid(grid, axis)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32)), (
        float((out - want).abs().max()))
    assert torch.equal(table, gi.quantize_grid_u8(want))


SWEEP_CASES = [("jax32", (32, 4, 4)), ("cube16", (16, 16, 16)), ("odd7x9x5", (7, 9, 5)),
               ("cube128", (128, 128, 128)), ("ragged64", (64, 3, 5)), ("line256", (256, 4, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("occupied", [0.0, 0.3, 1.0], ids=["empty", "30pct", "full"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("name,shape", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_sweep_kernel_matches_plain(cuda, name, shape, axis, occupied):
    """The swept grid and its u8 table bit for bit against the plain chain:
    the JAX tests' grid (32 along the axis), 16^3, odd lengths (word
    stores of the table), 128^3 (the ring kernel on each axis), 64-voxel
    lines whose 15 lines leave a group short, 256-voxel lines (8 voxels a
    lane)."""
    if name == "jax32":
        shape = tuple(np.roll(shape, axis))
    _sweep_same(_sweep_grid(shape, occupied, axis, cuda), axis)


@pytest.mark.cuda
def test_sweep_kernel_long_line_and_refusals(cuda):
    """A 520-voxel line (dynamic shared memory past 48 KB) bit for bit; a
    line too long for a block's shared memory, a float64 grid, a grid that
    is not [D,H,W,4], a strided grid, one off its 16-byte line and an axis
    out of range raise ValueError and launch nothing."""
    _sweep_same(_sweep_grid((520, 3, 8), 0.3, 5, cuda), 0)
    _sweep_same(_sweep_grid((8, 3, 520), 0.3, 6, cuda), 2)
    grid = _sweep_grid((8, 8, 8), 0.3, 7, cuda)
    before = gi.sweep_lightgrid_u8.launches
    for bad, axis, match in ((torch.zeros((1000, 2, 8, 4), device=cuda), 0, "shared memory"),
                             (grid.double(), 0, "float32"), (grid[..., :3].contiguous(), 0, "4]"),
                             (grid.transpose(0, 1), 0, "contiguous"),
                             (torch.zeros(8 * 8 * 8 * 4 + 1, device=cuda)[1:].view(8, 8, 8, 4),
                              0, "16-byte"), (grid, 3, "axis")):
        with pytest.raises(ValueError, match=match):
            gi.sweep_lightgrid_u8(bad, axis)
    assert gi.sweep_lightgrid_u8.launches == before


@pytest.mark.cuda
def test_sweep_occupancy(cuda):
    """The ring kernel at exactly the 16-256-voxel lines (16 lanes a line,
    K = n / 16 voxels a lane, as csrc/sweep.cu reports): 8 lines a group of
    128 threads, no local memory (the lines' registers indexed statically),
    at least 6 blocks resident per SM at 128 (its 32 KB ring allows 6); the
    replay kernel elsewhere, 8 lines of 256 threads, at least 4 blocks per
    SM at 7."""
    ring = {n: gi.sweep_occupancy(n) for n in range(1, 300)}
    assert [n for n, occ in ring.items() if occ["kernel"] == "ring"] == [16, 32, 64, 128, 256]
    for n in (16, 32, 64, 128, 256):
        occ = ring[n]
        assert (occ["lines_per_block"], occ["threads"], occ["lane_voxels"]) == (8, 128, n // 16)
        assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 1, occ
    assert ring[128]["blocks_per_sm"] >= 6, ring[128]
    occ = ring[7]
    assert (occ["kernel"], occ["threads"], occ["lane_voxels"]) == ("replay", 256, 0), occ
    assert occ["local_bytes"] == 0 and occ["blocks_per_sm"] >= 4, occ


@pytest.mark.cuda
def test_fast_gi_needs_the_table_on_the_card(cuda):
    """On the card the GI reads the table the sweep wrote; without one it
    raises, and runs no quantize of its own."""
    grid = _sweep_grid((8, 8, 8), 0.3, 8, cuda)
    res = lighting.LightingResources(sun_depth=None, prefiltered_env=None, brdf_lut=None,
                                     lightgrid=grid)
    with pytest.raises(ValueError, match="lightgrid_u8"):
        gi_modes.grid_table(res)
    _, table = gi.sweep_lightgrid_u8(grid, 1)
    assert gi_modes.grid_table(res._replace(lightgrid_u8=table)) is table


# ---------------------------------------------------------------------------
# the reference GI's ray (csrc/gi_reference_ray.cu) against
# gi.reference_ray_resolve_plain: statuses equal, rgb atol 1e-5


def _ref_kernel_vs_plain(args):
    before = gi.reference_ray_resolve.launches
    rgb_k, st_k = gi.reference_ray_resolve(*args)
    assert gi.reference_ray_resolve.launches == before + 1
    rgb_p, st_p = gi.reference_ray_resolve_plain(*args)
    torch.cuda.synchronize()
    assert st_k.shape == st_p.shape and rgb_k.shape == rgb_p.shape
    torch.testing.assert_close(st_k, st_p, rtol=0, atol=0)
    torch.testing.assert_close(rgb_k, rgb_p, rtol=0, atol=1e-5)
    return rgb_k, st_k


@pytest.mark.cuda
@pytest.mark.parametrize("name", [s[0] for s in REF_SETS])
def test_reference_ray_kernel_matches_plain(cuda, name):
    """The seeded sets of tests/test_torch_reference_ray_inputs.py: every
    status, translucent crossings, lanes that open no voxel, scalar and
    per-lane foggyness, a short trace budget, a denser grid."""
    _, st = _ref_kernel_vs_plain(set_call_args(name, cuda))
    assert set(torch.unique(st).tolist()) == {1, 2, 3}


@pytest.mark.cuda
@pytest.mark.parametrize("changes", [dict(gi_screen_trace_steps=0), dict(gi_screen_trace_steps=1),
                                     dict(gi_diffuse_steps=0), dict(bloom_pass_count=1)],
                         ids=["no_trace", "one_step", "no_march", "one_level"])
def test_reference_ray_kernel_budgets(cuda, changes):
    """Budgets at their edges: no trace step (every lane on to the march),
    one, no march fetch (the open sample alone), a one-level pyramid."""
    arrays, scalars = reference_rays(64, n=1024)
    if changes.get("bloom_pass_count") == 1:
        scalars = dict(scalars, levels=1)
        changes = {}
    _ref_kernel_vs_plain(reference_call_args(arrays, scalars, cuda, **changes))


@pytest.mark.cuda
def test_reference_ray_kernel_other_tables(cuda):
    """A 24^3 grid, a full-resolution trace table and an odd lane count."""
    arrays, scalars = reference_rays(65, n=1001, d=24, th=96, tw=128)
    _ref_kernel_vs_plain(reference_call_args(arrays, scalars, cuda, spec=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 143), (1, 1), (3, 1000), (1,), (0,), (2, 5, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_reference_ray_kernel_ragged_lane_grids(cuda, shape):
    """Lane grids whose rows and widths are not multiples of the warp tile,
    one lane, no lane and stacked rows: every lane written once."""
    n = int(np.prod(shape))
    arrays, scalars = reference_rays(66, n=n)
    args = list(reference_call_args(arrays, scalars, cuda, spec=True))
    for i in (7, 8, 9, 10):
        args[i] = args[i].reshape(tuple(shape) + (3,))
    for i in (11, 12):
        args[i] = args[i].reshape(tuple(shape))
    rgb, st = _ref_kernel_vs_plain(args)
    assert st.shape == tuple(shape) and rgb.shape == tuple(shape) + (3,)


@pytest.mark.cuda
def test_reference_ray_plan_fresh_outputs(cuda):
    """Two calls of one shape through the cached plan: one launch each, the
    outputs in fresh storage, the second call's scalar foggyness its own."""
    args = list(set_call_args("diffuse", cuda))
    rgb_a, st_a = gi.reference_ray_resolve(*args)
    args[12] = 0.25
    before = gi.reference_ray_resolve.launches
    rgb_b, st_b = gi.reference_ray_resolve(*args)
    assert gi.reference_ray_resolve.launches == before + 1
    rgb_p, st_p = gi.reference_ray_resolve_plain(*args)
    torch.cuda.synchronize()
    assert rgb_a.data_ptr() != rgb_b.data_ptr() and st_a.data_ptr() != st_b.data_ptr()
    torch.testing.assert_close(st_b, st_p, rtol=0, atol=0)
    torch.testing.assert_close(rgb_b, rgb_p, rtol=0, atol=1e-5)
    assert not torch.equal(rgb_a, rgb_b)


@pytest.mark.cuda
def test_reference_ray_wrapper_rejects_bad_inputs_on_card(cuda):
    """The checks on the card, on a plan's first call and on a call its plan
    does not accept: no launch for either."""
    args = set_call_args("specular", cuda)
    gi.reference_ray_resolve(*args)
    table = args[0]
    shifted = torch.empty(table.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(table.shape)
    shifted.copy_(table)
    bad = {0: shifted,                                          # table not on a 4-byte boundary
           1: args[1].t().contiguous().t(),                     # trace depth not contiguous
           3: args[3].cpu(),                                    # a matrix on the CPU
           9: args[9][:, [2, 1, 0]].t().contiguous().t(),       # pw not contiguous
           12: args[12].double(),                               # per-lane fog not f32
           13: args[13]._replace(prev_levels=17)}
    for i, value in bad.items():
        call = list(args)
        call[i] = value
        before = gi.reference_ray_resolve.launches
        with pytest.raises(ValueError):
            gi.reference_ray_resolve(*call)
        assert gi.reference_ray_resolve.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [False, True], ids=["every_lane", "interleave"])
def test_reference_gi_launches_the_kernel(cuda, monkeypatch, temporal):
    """gi_pass in reference mode on the card: one kernel launch a ray, and
    the same GI as with each ray through the plain version on the card."""
    si = _shade_inputs()
    h, w = 48, 64
    g, glob, _, _ = si.lighting_inputs(si.shade_scene(cuda), h, w, device=cuda)
    arrays, _ = reference_rays(67, n=8, d=16)
    grid = torch.from_numpy(arrays["grid"]).to(cuda)
    _, wa = sampling.mip_offsets(h // 2, w // 2, 3)
    prev = torch.rand((h // 2, wa, 3), generator=torch.Generator().manual_seed(3)).to(cuda)
    res = lighting.LightingResources(sun_depth=None, prefiltered_env=None, brdf_lut=None,
                                     lightgrid=grid, lightgrid_u8=gi.quantize_grid_u8(grid),
                                     prev_frame_atlas=prev.to(torch.bfloat16))
    cfg = si.frame_config(h, w, gi_mode="reference", gi_temporal_reference=temporal,
                          gi_reference_depth_div=2 if temporal else 1)
    kw = dict(gi_cache=torch.zeros((2, h // 2, w // 2, 3), device=cuda), frame_idx=3) \
        if temporal else {}
    before = gi.reference_ray_resolve.launches
    got = gi_modes.gi_pass(cfg, glob, res, g, g.depth, h, w, 3.0, **kw)
    assert gi.reference_ray_resolve.launches == before + 2
    monkeypatch.setattr(gi, "reference_ray_resolve", gi.reference_ray_resolve_plain)
    want = gi_modes.gi_pass(cfg, glob, res, g, g.depth, h, w, 3.0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_reference_ray_kernel_cube_table(cuda):
    """The lightgrid's own 128^3 table, which takes the kernel's fixed-size
    fetch (a tenth of the lanes far outside the grid, on its faces): bit for
    bit."""
    arrays, scalars = reference_rays(68, n=4096, d=128)
    for spec in (False, True):
        st = _ref_bits(reference_call_args(arrays, scalars, cuda, spec=spec))
        assert set(torch.unique(st).tolist()) == {1, 2, 3}


@pytest.mark.cuda
def test_reference_ray_occupancy(cuda):
    assert gi.reference_ray_occupancy(table_shape=(16, 16, 16))["threads"] == 128
    occ = gi.reference_ray_occupancy()   # the 128^3 instance: 56 registers, 9 blocks an SM
    assert occ["threads"] == 128 and occ["blocks_per_sm"] >= 8 and occ["local_bytes"] == 0, occ
    assert occ["threads"] // 32 == gi.REF_BLOCK_TILES and 0 < occ["shared_bytes"] <= 48 * 1024, occ


# the kernel's queues (a block of 4 warp tiles; on 1-D lanes a tile is 32
# neighbouring lanes, a block 128): lanes of the seeded sets picked by what
# the plain version does with them, so that blocks and warps meet the
# queues' edge cases


def _ref_lane_kinds(cuda):
    """(args, kinds) of the seeded sets' lanes taken together: each set's
    call arguments and, per lane, its set and what it does: "march" (status
    2 with an open voxel), "still" (status 2, no open voxel), "off" (1),
    "resolved" (3), and whether its trace runs past 8 steps."""
    sets, kinds = [], []
    for name in ("diffuse", "dense"):
        args = set_call_args(name, cuda)
        work = {}
        _, st = gi.reference_ray_resolve_plain(*args, work=work)
        march = (st == 2) & (work["seed"] > 0)
        kind = torch.where(march, 0, torch.where(st == 2, 1, torch.where(st == 1, 2, 3)))
        sets.append(args)
        kinds.append((kind.cpu().numpy(), (work["trace"] > 8).cpu().numpy()))
    return sets, kinds


def _ref_pick(args, idx):
    """args with each lane input taken at the lane indices idx (1-D)."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=args[9].device)
    out = list(args)
    for i in (7, 8, 9, 10, 11):
        out[i] = args[i].index_select(0, idx).contiguous()
    if torch.is_tensor(args[12]):
        out[12] = args[12].index_select(0, idx).contiguous()
    return out


_KIND = {"march": 0, "still": 1, "off": 2, "resolved": 3}


def _ref_bits(args):
    """The kernel against the plain version bit for bit: statuses and the
    rgb's int32 view equal."""
    rgb_k, st_k = gi.reference_ray_resolve(*args)
    rgb_p, st_p = gi.reference_ray_resolve_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(st_k, st_p)
    assert torch.equal(rgb_k.view(torch.int32), rgb_p.view(torch.int32))
    return st_k


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one_march_a_warp", "all_march", "none_march_off",
                                    "none_march_resolved", "ragged_queues"])
def test_reference_ray_kernel_queues(cuda, layout):
    """Bits against the plain version where the queues meet their edges:
    one marching lane in each warp tile; a block whose every lane marches;
    blocks where none does (all off screen, all resolved); and a block
    that queues more than a warp of marching lanes (40 of them tracing past
    8 steps), then a ragged tail."""
    rng = np.random.default_rng(23)
    sets, kinds = _ref_lane_kinds(cuda)
    for args, (kind, long_trace) in zip(sets, kinds):
        pool = {k: np.nonzero(kind == v)[0] for k, v in _KIND.items()}
        others = np.nonzero(kind != 0)[0]
        if layout == "one_march_a_warp":
            warps = []
            for w in range(12):
                lanes = rng.choice(others, 32, replace=False)
                lanes[rng.integers(32)] = rng.choice(pool["march"])
                warps.append(lanes)
            idx = np.concatenate(warps)
        elif layout == "all_march":
            idx = rng.choice(pool["march"], 256)
        elif layout in ("none_march_off", "none_march_resolved"):
            idx = rng.choice(pool[layout.split("_")[-1]], 256)
        else:
            long_march = np.nonzero((kind == 0) & long_trace)[0]
            assert len(long_march) > 0
            block = np.concatenate([rng.choice(long_march, 40), rng.choice(pool["march"], 30),
                                    rng.choice(others, 58)])
            idx = np.concatenate([rng.permutation(block), rng.choice(len(kind), 77)])
        st = _ref_bits(_ref_pick(args, idx))
        want = kind[idx]
        if layout.startswith("none"):
            assert (want != 0).all()
        if layout == "all_march":
            assert (st == 2).all()


@pytest.mark.cuda
def test_reference_ray_kernel_same_bits_on_two_streams(cuda):
    """Two launches on the current stream and one on another stream give
    the same bits (the queues' order may differ, a lane's result does not)."""
    args = set_call_args("dense", cuda)
    rgb_a, st_a = gi.reference_ray_resolve(*args)
    rgb_b, st_b = gi.reference_ray_resolve(*args)
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        rgb_c, st_c = gi.reference_ray_resolve(*args)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    for rgb, st in ((rgb_b, st_b), (rgb_c, st_c)):
        assert torch.equal(st, st_a)
        assert torch.equal(rgb.view(torch.int32), rgb_a.view(torch.int32))


# ---------------------------------------------------------------------------
# transform + setup (csrc/setup.cu) and the K1 / K2 work lists built on the card


def _plain_setup(tri_pos, mat, w, h, cull, jitter):
    return setup.setup_triangles(setup.transform_to_clip(tri_pos, mat, jitter), w, h, cull)


def _setup_bits_equal(got, want, what):
    """Every TriSetup field of the kernel equal to the plain composition's:
    floats as int32 views (signed zeros count), the rest exactly; each field
    contiguous, of the plain version's dtype and shape."""
    for name in setup.TriSetup._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous(), f"{what}: {name}"
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad = int((a != b).sum())
        assert bad == 0, f"{what}: {name} differs from the plain composition at {bad} values"


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "tri_attr_view"])
@pytest.mark.parametrize("jitter", [False, True], ids=["no_jitter", "jitter"])
@pytest.mark.parametrize("cull", ["back", "front", "none"])
def test_setup_kernel_matches_plain(cuda, cull, jitter, strided):
    """transform_and_setup's kernel against setup_triangles(transform_to_clip)
    on the card, bit for bit, on every seeded set of test_torch_setup_inputs
    (one launch a call; none for the empty set)."""
    from test_torch_setup_inputs import JITTER, SETS, tri_attr_view

    jit = torch.from_numpy(JITTER).to(cuda) if jitter else None
    for name, make in SETS.items():
        pos, mat, w, h = make()
        if strided:
            tri_pos = torch.from_numpy(tri_attr_view(pos)).to(cuda)[:, :9].reshape(-1, 3, 3)
        else:
            tri_pos = torch.from_numpy(pos).to(cuda)
        m = torch.from_numpy(mat).to(cuda)
        before = setup.transform_and_setup.launches
        got = setup.transform_and_setup(tri_pos, m, w, h, cull=cull, jitter=jit)
        assert setup.transform_and_setup.launches == before + (pos.shape[0] > 0)
        torch.cuda.synchronize()
        _setup_bits_equal(got, _plain_setup(tri_pos, m, w, h, cull, jit),
                          f"{name} cull={cull} jitter={jitter}")


@pytest.mark.cuda
def test_setup_kernel_suntemple_passes(cuda):
    """SunTemple's 638,700 triangles through the renderer's strided view at
    path A's frame-0 camera (back cull, jitter) and sun (cull none)
    matrices: every field bit for bit."""
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P as cfg

    scene = build_scene(suntemple.build_parts(4.5), suntemple.materials(), texture_size=16,
                        device=cuda)
    assert scene.num_tris == 638_700
    cam = trender.make_camera(*suntemple.camera_path(0.0), cfg, device=cuda)
    fi = trender.frame_inputs(trender.init_frame_state(cfg, cuda), cam, (50.0, 30.0), cfg)
    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    sm = cfg.shadow_map_size
    for what, mat, w, h, cull, jit in (
            ("camera", cam.clip_from_world, cfg.width, cfg.height, "back", fi.jitter),
            ("sun", fi.sun_from_world, sm, sm, "none", None)):
        got = setup.transform_and_setup(tri_pos, mat, w, h, cull=cull, jitter=jit)
        torch.cuda.synchronize()
        _setup_bits_equal(got, _plain_setup(tri_pos, mat, w, h, cull, jit), f"{what} pass")
        assert int(got.valid.sum()) > 100_000


@pytest.mark.cuda
def test_setup_wrapper_rejects_bad_inputs(cuda):
    """Bad dtype, shape, layout, device or cull mode raise ValueError and
    launch nothing."""
    from test_torch_setup_inputs import SETS

    pos, mat, w, h = SETS["perspective400_seed7"]()
    tri_pos, m = torch.from_numpy(pos).to(cuda), torch.from_numpy(mat).to(cuda)
    before = setup.transform_and_setup.launches
    for args, kw in (((tri_pos.double(), m), {}), ((tri_pos[:, :, :2], m), {}),
                     ((tri_pos.transpose(1, 2), m), {}), ((tri_pos, m.cpu()), {}),
                     ((tri_pos, m[:3]), {}), ((tri_pos, m), dict(jitter=torch.zeros(3, device=cuda))),
                     ((tri_pos, m), dict(jitter=torch.zeros(2))), ((tri_pos, m), dict(cull="up"))):
        with pytest.raises(ValueError):
            setup.transform_and_setup(*args, w, h, **kw)
    assert setup.transform_and_setup.launches == before


def _list_cases(cuda):
    """(name, bins in slim13, bins in wide16 on 32x128 tiles, chunk): a
    random set with empty tiles, a one-tile stack deeper than one piece,
    and both beside each other."""
    cases = []
    for name, clip, w, h in (("random300_empty_tiles", _random_tris(300, 1) * np.float32(
                                  [0.5, 0.5, 1.0, 1.0]), 256, 160),
                             ("deep_stack", _stack_tris(1100, 3), 128, 32),
                             ("random3000", _random_tris(3000, 5), 640, 352)):
        s = setup.setup_triangles(torch.from_numpy(clip).to(cuda), w, h, cull="none")
        n = clip.shape[0]
        cases.append((name, binning.bin_triangles(s, w, h, 32, 64 * n),
                      binning.bin_triangles(s, w, h, 32, 64 * n, 16, fmt="wide16", tile_w=128)))
    return cases


@pytest.mark.cuda
def test_folded_work_list_built_on_card(cuda):
    """K1's library builds folded_work_list itself: the list it launched
    from equals the plain list exactly, (-1, 0, 0, 0) tail included, on a
    set with empty tiles and a tile deeper than one piece."""
    lib = visibility_v2._library()
    piece_rows = lib.vis_folded_piece_rows()
    for name, bins, _ in _list_cases(cuda):
        seg = bins.starts[1:] - bins.starts[:-1]
        d_k, i_k, items = visibility_v2.run_vis_folded(lib, bins.starts, bins.pair_data,
                                                       bins.tiles_x)
        want = visibility_v2.folded_work_list(bins.starts, piece_rows, items.shape[0])
        torch.cuda.synchronize()
        assert torch.equal(items, want), name
        assert bool((want[:, 0] == -1).any()), name
        if name == "random300_empty_tiles":
            assert bool((seg == 0).any()), name
        if name == "deep_stack":
            assert int(seg.max()) > piece_rows, name
        d_p, i_p = visibility_v2.vis_folded_plain(bins.starts, bins.pair_data, bins.tiles_x)
        torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
        torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,chunk", [(4096, 16), (64, 16), (160, 32), (0, 16)])
def test_rowblock_work_list_built_on_card(cuda, cap, chunk):
    """K2's library builds rowblock_work_list itself, the capacity cut
    computed in the kernel: equal to the plain list exactly, at capacities
    that keep and that cut segments (inside a piece, at zero)."""
    lib = visibility._library()
    piece_rows = lib.vis_rowblock_piece_rows()
    cut = False
    for name, _, bins in _list_cases(cuda):
        lo, hi = visibility.capacity_ranges(bins.starts, cap, chunk)
        cut |= bool((hi < bins.starts[1:].long()).any())
        d_k, i_k, items = visibility.run_vis_rowblock(lib, bins.starts, bins.pair_data,
                                                      bins.tiles_x, cap, chunk)
        want = visibility.rowblock_work_list(bins.starts, cap, chunk, piece_rows,
                                             items.shape[0])
        torch.cuda.synchronize()
        assert torch.equal(items, want), f"{name} cap={cap} chunk={chunk}"
        d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x,
                                                 cap, chunk)
        torch.testing.assert_close(i_k, i_p, rtol=0, atol=0)
        torch.testing.assert_close(d_k, d_p, rtol=0, atol=0)
    assert cut or cap == 4096   # the smaller capacities cut some segment


# ---------------------------------------------------------------------------
# voxelize (csrc/voxelize.cu: voxelize_kernel, decode_voxel_kernel)


def _voxel_inputs():
    import test_torch_voxelize_inputs

    return test_torch_voxelize_inputs


def _voxel_case(name, dev):
    """A seeded set of test_torch_voxelize_inputs.py on dev: (scene, the
    arguments after it, keywords)."""
    import types

    vin = _voxel_inputs()
    s = vin.SETS[name]()
    packed, scale = vin.atlas()
    scene = types.SimpleNamespace(
        tri_attr=torch.from_numpy(s["tri_attr"]).to(dev),
        mat_id=torch.from_numpy(s["mat_id"]).to(dev),
        tex_packed=torch.from_numpy(packed).to(dev), tex_scale=torch.from_numpy(scale).to(dev))
    m, d = shadow.sun_matrices(*s["sun"])
    args = (vin.GRID, vin.SCALE, torch.from_numpy(vin.sun_depth()).to(dev), m.to(dev),
            d.to(dev), torch.from_numpy(vin.EMISSION).to(dev))
    return scene, args, dict(total_samples=vin.TOTAL, texture_lod=s["texture_lod"])


def _voxel_same(scene, args, kw, what):
    """The kernels' words and decoded grid against the plain version's, bit
    for bit, one launch each; returns the words."""
    before = (gi.voxelize_scene.launches, gi.decode_voxel_grid.launches)
    got = gi.voxelize_scene(scene, *args, **kw)
    grid = gi.decode_voxel_grid(got)
    assert (gi.voxelize_scene.launches, gi.decode_voxel_grid.launches) == (
        before[0] + 1, before[1] + 1), what
    want = gi.voxelize_scene_plain(scene, *args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == want.shape, what
    assert torch.equal(got, want), (what, int((got != want).sum()))
    assert torch.equal(grid.view(torch.int32),
                       gi.decode_voxel_grid_plain(want).view(torch.int32)), what
    return got


VOXEL_NAMES = ("planes", "one_sample", "zero_area", "outside", "emissive", "sun_edge", "cut",
               "lod")


@pytest.mark.cuda
@pytest.mark.parametrize("name", VOXEL_NAMES)
def test_voxelize_kernel_matches_plain(cuda, name):
    """The packed words and the decoded grid bit for bit against the plain
    version on every seeded set (test_torch_voxelize_inputs.py), again
    (another order of the atomics), and with the emission as 3 numbers."""
    scene, args, kw = _voxel_case(name, cuda)
    first = _voxel_same(scene, args, kw, name)
    assert int((first != 0).sum()) > 0
    assert torch.equal(gi.voxelize_scene(scene, *args, **kw), first)
    by_value = args[:5] + (tuple(_voxel_inputs().EMISSION.tolist()),)
    assert torch.equal(gi.voxelize_scene(scene, *by_value, **kw), first)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_voxelize_kernel_shards(cuda, shards):
    """Each shard's words equal the plain version's shard (slices that
    start inside a run: the carry-in), and their max the whole stream."""
    for name in ("planes", "cut", "outside"):
        scene, args, kw = _voxel_case(name, cuda)
        whole = gi.voxelize_scene(scene, *args, **kw)
        parts = [_voxel_same(scene, args, {**kw, "shard_idx": i, "shard_count": shards},
                             f"{name} shard {i} of {shards}") for i in range(shards)]
        assert torch.equal(torch.stack(parts).amax(0), whole), name


@pytest.mark.cuda
def test_voxelize_kernel_long_stream_and_refusals(cuda):
    """A stream far longer than the samples (blocks past the total launch
    nothing) and a 128^3 grid bit for bit; random words through the decode
    kernel; inputs the kernel does not take raise ValueError and launch
    nothing: an atlas off its 16-byte line, a strided sun map, material ids
    past the atlas's layers, a float word grid."""
    scene, args, kw = _voxel_case("planes", cuda)
    _voxel_same(scene, args, {**kw, "total_samples": 1 << 16}, "long stream")
    _voxel_same(scene, (128,) + args[1:], kw, "128^3")
    words = torch.from_numpy(np.random.default_rng(9).integers(
        0, 1 << 32, (5, 7, 9), dtype=np.int64)).to(cuda)
    words[0, 0, :3] = 0
    got = gi.decode_voxel_grid(words)
    assert torch.equal(got.view(torch.int32),
                       gi.decode_voxel_grid_plain(words).view(torch.int32))
    before = (gi.voxelize_scene.launches, gi.decode_voxel_grid.launches)
    raw = torch.empty(scene.tex_packed.numel() + 8, dtype=torch.uint8, device=cuda)
    off_line = raw[8:].view(scene.tex_packed.shape)
    import types
    for over, a, match in (
            (dict(tex_packed=off_line), args, "16-byte"),
            ({}, args[:2] + (args[2].t(),) + args[3:], "contiguous"),
            (dict(mat_id=scene.mat_id + 3), args, "layers")):
        with pytest.raises(ValueError, match=match):
            gi.voxelize_scene(types.SimpleNamespace(**{**vars(scene), **over}), *a, **kw)
    with pytest.raises(ValueError, match="int64"):
        gi.decode_voxel_grid(words.float())
    assert (gi.voxelize_scene.launches, gi.decode_voxel_grid.launches) == before


@pytest.mark.cuda
def test_render_frame_runs_voxelize_kernels(cuda):
    """A 160x96 GI frame on the card: one voxelize_lightgrid launch on frame
    0 and where the sun moved, none on a steady frame, and no launch of the
    sharded frame's voxelize_scene or decode_voxel_grid; the state's plan
    made once."""
    si = _shade_inputs()
    scene = si.shade_scene(cuda)
    cfg = si.frame_config(96, 160)
    r = trender.Renderer(cfg, scene, device=cuda, raster_backend="pallas")
    cam = trender.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), cfg, device=cuda)
    moved = (si.SUN[0] + 5.0, si.SUN[1])
    counters = (gi.voxelize_lightgrid, gi.voxelize_scene, gi.decode_voxel_grid)
    plans = set()
    for sun, want in ((si.SUN, 1), (si.SUN, 0), (moved, 1)):
        before = [f.launches for f in counters]
        img = r.render(cam, sun)
        assert [f.launches - b for f, b in zip(counters, before)] == [want, 0, 0]
        assert bool(torch.isfinite(img).all())
        plans.add(id(r.state.voxel_plan))
    assert len(plans) == 1


def _pass_same(scene, args, kw, what, plan=None):
    """The one-launch pass's decoded grid against the plain chain's, bit for
    bit, one launch and no other voxelize launch; returns the grid."""
    counters = (gi.voxelize_lightgrid, gi.voxelize_scene, gi.decode_voxel_grid)
    before = [f.launches for f in counters]
    got = gi.voxelize_lightgrid(scene, *args, **kw, plan=plan)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, 0], what
    want = gi.decode_voxel_grid_plain(gi.voxelize_scene_plain(scene, *args, **kw))
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape, what
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        what, int((got != want).any(-1).sum()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", VOXEL_NAMES)
def test_voxelize_pass_matches_plain(cuda, name):
    """voxelize_lightgrid's one launch (u32 words zeroed, scatter-maxed and
    decoded in one cooperative grid) bit for bit against the plain chain on
    every seeded set (the one-sample set through the thread-a-triangle
    route), with its plan passed in, again (another order of the atomics),
    and with the emission as 3 numbers; the int64 route's decoded grid is
    the same."""
    scene, args, kw = _voxel_case(name, cuda)
    plan = gi._VoxelPlan(scene, *args[:2], 4.0, kw["total_samples"])
    assert plan.one_sample == (name == "one_sample")
    first = _pass_same(scene, args, kw, name, plan)
    assert float(first[..., 3].sum()) > 0
    assert torch.equal(_pass_same(scene, args, kw, f"{name} again", plan), first)
    by_value = args[:5] + (tuple(_voxel_inputs().EMISSION.tolist()),)
    assert torch.equal(_pass_same(scene, by_value, kw, f"{name} by value"), first)
    assert torch.equal(gi.decode_voxel_grid(gi.voxelize_scene(scene, *args, **kw, plan=plan)),
                       first)


@pytest.mark.cuda
def test_voxelize_multi_sample_stream_of_exactly_its_triangles(cuda):
    """The planes set (triangles of several samples) in a stream of exactly
    T samples: the plan's one-sample flag is off, and both routes, the pass
    and the int64 kernel with its decode, equal the plain chain bit for
    bit."""
    scene, args, kw = _voxel_case("planes", cuda)
    kw = {**kw, "total_samples": _voxel_inputs().TRIS}
    plan = gi._VoxelPlan(scene, *args[:2], 4.0, kw["total_samples"])
    assert not plan.one_sample and plan.n_total == kw["total_samples"]
    grid = _pass_same(scene, args, kw, "planes, T samples", plan)
    words = _voxel_same(scene, args, kw, "planes, T samples, int64")
    assert torch.equal(gi.decode_voxel_grid(words), grid)


@pytest.mark.cuda
def test_voxelize_pass_plan_serves_one_stream(cuda):
    """A plan's word grid serves the stream of its first pass: a pass on
    another stream raises ValueError and launches nothing; the first
    stream goes on passing bit for bit."""
    scene, args, kw = _voxel_case("planes", cuda)
    plan = gi._VoxelPlan(scene, *args[:2], 4.0, kw["total_samples"])
    first = _pass_same(scene, args, kw, "first stream", plan)
    before = gi.voxelize_lightgrid.launches
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side), pytest.raises(ValueError, match="stream"):
        gi.voxelize_lightgrid(scene, *args, **kw, plan=plan)
    assert gi.voxelize_lightgrid.launches == before
    assert torch.equal(_pass_same(scene, args, kw, "first stream again", plan), first)


@pytest.mark.cuda
def test_voxelize_pass_long_stream_grid_and_refusals(cuda):
    """The pass on a stream far longer than its samples, on a 128^3 grid
    (more voxels than the grid's threads) and on a one-sample stream cut
    below its triangles (the search route), bit for bit; a plan of another
    scene and a strided sun map raise ValueError and launch nothing."""
    scene, args, kw = _voxel_case("planes", cuda)
    _pass_same(scene, args, {**kw, "total_samples": 1 << 16}, "long stream")
    _pass_same(scene, (128,) + args[1:], kw, "128^3")
    one, one_args, one_kw = _voxel_case("one_sample", cuda)
    cut = {**one_kw, "total_samples": _voxel_inputs().TRIS - 7}
    assert not gi._VoxelPlan(one, *one_args[:2], 4.0, cut["total_samples"]).one_sample
    _pass_same(one, one_args, cut, "one-sample stream cut")
    plan = gi._VoxelPlan(scene, *args[:2], 4.0, kw["total_samples"])
    before = [f.launches for f in (gi.voxelize_lightgrid, gi.voxelize_scene)]
    import types
    fewer = types.SimpleNamespace(**{**vars(scene), "tri_attr": scene.tri_attr[:-1],
                                     "mat_id": scene.mat_id[:-1]})
    with pytest.raises(ValueError, match="plan was made"):
        gi.voxelize_lightgrid(fewer, *args, **kw, plan=plan)
    with pytest.raises(ValueError, match="contiguous"):
        gi.voxelize_lightgrid(scene, *args[:2], args[2].t(), *args[3:], **kw, plan=plan)
    assert [f.launches for f in (gi.voxelize_lightgrid, gi.voxelize_scene)] == before
