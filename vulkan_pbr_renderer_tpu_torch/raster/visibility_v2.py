"""Folded-tile visibility rasterizer (counterpart of
vulkan_pbr_renderer_tpu/raster/visibility_v2.py::rasterize_vis_folded).

Binning (binning.py) sorts triangle/tile pairs into per-tile segments
[starts[t], starts[t+1]) of 13-column rows; the visibility pass then walks
each 32x32 tile's own segment and keeps, per pixel, the nearest depth and the
smallest id among equal depths.  On a CUDA tensor that pass is the
hand-written kernel csrc/vis_folded.cu; on a CPU tensor it is the plain
PyTorch version `vis_folded_plain`, which does the same arithmetic.  The
kernel walks a work list (`folded_work_list`, over `segment_work_list`,
which K2 shares) that cuts each segment into pieces of at most the kernel's
piece length, one block each; the pieces of a tile merge on the (depth, id)
key, so the result is the same.

With hiz=True (the JAX kernel's hierarchical-z body, visibility_v2.py:128-185)
the segments are sorted front to back (binning z_order=True) and the walk
stops once every pixel of the tile is covered nearer than the next block's
chunk_minz bound: csrc/vis_folded_hiz.cu on a CUDA tensor,
`vis_folded_hiz_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ..gpu import cuda_build
from .binning import NCOL, bin_triangles
from .setup import TriSetup
from .xla_raster import INT64_MAX, depth_at, depth_id_key, key_to_depth_id

TILE = 32
PIX = TILE * TILE
HIZ_CHUNK = 128   # the hiz kernel's block: one early-exit bound per 128 rows


def _tile_pixel_centers(tiles, tiles_x, device):
    """px, py [k, PIX] pixel centers of the given tiles (row-major inside a
    tile: local index q = y*32 + x)."""
    q = torch.arange(PIX, device=device)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    px = (tx * TILE + q % TILE).to(torch.float32) + 0.5
    py = (ty * TILE + q // TILE).to(torch.float32) + 0.5
    return px, py


def vis_folded_plain(starts, pair_data, tiles_x, tiles=None, row_chunk=2048):
    """Plain PyTorch version of the kernel: each tile brute-forced over its
    own pair segment.  tiles: optional i64 [k] subset of tile indices
    (default all).  Returns (depth [k, 1024] f32 with +inf empty,
    ids [k, 1024] i32 with -1 empty)."""
    dev = starts.device
    rows_all = pair_data.reshape(-1, NCOL)
    if tiles is None:
        tiles = torch.arange(starts.shape[0] - 1, device=dev)
    tiles = tiles.to(torch.int64)
    st = starts.to(torch.int64)
    lo, lens = st[tiles], st[tiles + 1] - st[tiles]
    slot = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev), lens)
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    row_idx = torch.repeat_interleave(lo, lens) + (
        torch.arange(slot.shape[0], device=dev) - first)
    px_t, py_t = _tile_pixel_centers(tiles, tiles_x, dev)
    best = torch.full((tiles.shape[0], PIX), INT64_MAX, dtype=torch.int64,
                      device=dev)
    for s in range(0, row_idx.shape[0], row_chunk):
        r = row_idx[s:s + row_chunk]
        sl = slot[s:s + row_chunk]
        rows = rows_all[r]
        z = depth_at(rows, px_t[sl], py_t[sl])
        ids = (rows[:, 12].abs() - 1.0).to(torch.int32)
        key = depth_id_key(z, ids[:, None])
        best.scatter_reduce_(0, sl[:, None].expand(-1, PIX), key, "amin")
    return key_to_depth_id(best)


def work_list_length(n_tiles, pair_data, piece_rows):
    """The static length of the work list: n_tiles + capacity // piece_rows
    entries hold every piece of any segments within the buffer's capacity
    (its rows of pair_data.shape[-1] columns)."""
    return n_tiles + (pair_data.numel() // pair_data.shape[-1]) // piece_rows


def segment_work_list(lo, hi, piece_rows, n_items):
    """A kernel's work list over per-tile pair ranges: int32 [n_items, 4]
    rows (tile, lo, hi, pieces).

    Tile t's range [lo[t], max(lo[t], hi[t])) is cut into
    max(1, ceil(len / piece_rows)) pieces of at most piece_rows rows (an
    empty tile keeps one empty piece, which writes its empty pixels);
    `pieces` is the tile's piece count.  Entries past the last piece are
    (-1, 0, 0, 0).  The ranges are disjoint parts of the pair buffer, so
    work_list_length, a bound from the buffer's capacity, holds every piece
    and the list is built on the device without a host sync."""
    dev = lo.device
    n_tiles = lo.shape[0]
    if n_tiles == 0:
        out = torch.zeros((n_items, 4), dtype=torch.int32, device=dev)
        out[:, 0] = -1
        return out
    lo = lo.to(torch.int64)
    lens = torch.clamp(hi.to(torch.int64) - lo, min=0)
    pieces = torch.clamp((lens + piece_rows - 1) // piece_rows, min=1)
    ends = torch.cumsum(pieces, 0)
    item = torch.arange(n_items, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(ends, item, right=True)
    live = tile < n_tiles
    tc = tile.clamp(max=n_tiles - 1)
    plo = lo[tc] + (item - (ends[tc] - pieces[tc])) * piece_rows
    phi = torch.minimum(plo + piece_rows, lo[tc] + lens[tc])
    out = torch.stack([tile, plo, phi, pieces[tc]], 1) * live[:, None]
    out[:, 0] -= (~live).to(torch.int64)
    return out.to(torch.int32)


def folded_work_list(starts, piece_rows, n_items):
    """K1's work list: segment_work_list over each tile's whole segment
    [starts[t], starts[t+1]).  n_items >= n_tiles + starts[-1] // piece_rows
    holds every piece; the wrapper passes work_list_length."""
    return segment_work_list(starts[:-1], starts[1:], piece_rows, n_items)


def vis_folded_tiles(starts, pair_data, tiles_x):
    """Visibility of every tile: (depth [T, 1024] f32, +inf empty;
    ids [T, 1024] i32, -1 empty).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  `vis_folded_tiles.launches` counts kernel launches, one
    per call."""
    if not starts.is_cuda:
        return vis_folded_plain(starts, pair_data, tiles_x)
    if starts.dtype != torch.int32 or pair_data.dtype != torch.float32:
        raise TypeError("vis_folded: starts must be int32 and pair_data float32")
    if pair_data.shape[-1] != NCOL or pair_data.device != starts.device:
        raise ValueError(f"vis_folded: pair_data must be [..., {NCOL}] on "
                         f"{starts.device}, got {tuple(pair_data.shape)} on "
                         f"{pair_data.device}")
    if not (starts.is_contiguous() and pair_data.is_contiguous()):
        raise ValueError("vis_folded: inputs must be contiguous")
    out = run_vis_folded(_library(), starts, pair_data, tiles_x)
    vis_folded_tiles.launches += 1
    return out


vis_folded_tiles.launches = 0


def run_vis_folded(lib, starts, pair_data, tiles_x):
    """Launch a built vis_folded library on checked CUDA inputs: the work
    list for its piece length, the scratch and the kernel, all on the
    current stream with no host sync."""
    n_tiles = starts.shape[0] - 1
    dev = starts.device
    piece_rows = lib.vis_folded_piece_rows()
    n_items = work_list_length(n_tiles, pair_data, piece_rows)
    items = folded_work_list(starts, piece_rows, n_items)
    depth = torch.empty((n_tiles, PIX), dtype=torch.float32, device=dev)
    ids = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    # per-pixel merge keys, per-tile arrival counters and the work counter, all ones
    scratch = torch.full((n_tiles * PIX + n_tiles + 1,), -1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vis_folded_launch(
            items.data_ptr(), n_items, pair_data.data_ptr(), tiles_x, n_tiles,
            depth.data_ptr(), ids.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vis_folded kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return depth, ids


def vis_folded_hiz_plain(starts, pair_data, chunk_minz, tiles_x, tiles=None, group=16,
                         rows_walked=False):
    """Plain PyTorch version of the hiz kernel, the JAX arithmetic literally:
    per tile a [chunk, 1024] accumulator (slot = row % chunk), the segment
    walked in global chunk-aligned blocks from starts[t] // chunk with rows
    outside [starts[t], starts[t+1]) masked, a strict `z < best` per slot,
    and after each block the skip test chunk_minz[min(blk + 1, nb - 1)] >
    max over pixels of the tile's nearest depth.  Resolve: the nearest
    depth over the slots, then the smallest id among the slots holding it.
    tiles: optional i64 [k] subset (default all), `group` tiles at a time.
    Returns (depth [k, 1024] f32, +inf empty; ids [k, 1024] i32, -1 empty)
    and, with rows_walked, the i64 [k] count of segment rows each tile
    evaluates before its exit (the kernel stops at the same block)."""
    dev = starts.device
    nb, chunk = pair_data.shape[0], pair_data.shape[1]
    if tiles is None:
        tiles = torch.arange(starts.shape[0] - 1, device=dev)
    tiles = tiles.to(torch.int64)
    st = starts.to(torch.int64)
    inf = float("inf")
    depth_out, id_out, walked_out = [], [], []
    for g0 in range(0, tiles.shape[0], group):
        tg = tiles[g0:g0 + group]
        k = tg.shape[0]
        start, end = st[tg], st[tg + 1]
        blk0 = start // chunk
        nchunks = torch.where(end > start, (end - 1) // chunk - blk0 + 1, 0)
        px, py = _tile_pixel_centers(tg, tiles_x, dev)
        px = px.repeat_interleave(chunk, 0)                 # [k*chunk, PIX]
        py = py.repeat_interleave(chunk, 0)
        acc_z = torch.full((k, chunk, PIX), inf, device=dev)
        acc_id = torch.zeros((k, chunk, PIX), dtype=torch.int32, device=dev)
        done = torch.zeros(k, dtype=torch.bool, device=dev)
        walked = torch.zeros(k, dtype=torch.int64, device=dev)
        row = torch.arange(chunk, device=dev)
        for i in range(int(nchunks.max()) if k else 0):
            blk = torch.clamp(blk0 + i, max=nb - 1)
            row_glob = (blk0 + i)[:, None] * chunk + row
            live = (~done & (i < nchunks))[:, None]
            rowok = live & (row_glob >= start[:, None]) & (row_glob < end[:, None])
            walked += rowok.sum(1)
            rows = pair_data[blk].reshape(k * chunk, NCOL)
            z = depth_at(rows, px, py).reshape(k, chunk, PIX)
            zm = torch.where(rowok[..., None], z, inf)
            take = zm < acc_z
            acc_z = torch.where(take, zm, acc_z)
            ids = (rows[:, 12].abs() - 1.0).to(torch.int32).reshape(k, chunk, 1)
            acc_id = torch.where(take, ids, acc_id)
            zmax = acc_z.amin(1).amax(1)                    # +inf if a hole
            bound = chunk_minz[torch.clamp(blk0 + i + 1, max=nb - 1)]
            done = done | (live[:, 0] & (bound > zmax))
        zmin = acc_z.amin(1)
        big = torch.iinfo(torch.int32).max
        idw = torch.where(acc_z == zmin[:, None], acc_id, big).amin(1)
        hole = torch.isinf(zmin)
        depth_out.append(zmin)
        id_out.append(torch.where(hole, -1, idw))
        walked_out.append(walked)
    if not depth_out:
        out = (torch.empty((0, PIX), device=dev),
               torch.empty((0, PIX), dtype=torch.int32, device=dev),
               torch.empty((0,), dtype=torch.int64, device=dev))
    else:
        out = torch.cat(depth_out), torch.cat(id_out), torch.cat(walked_out)
    return out if rows_walked else out[:2]


def vis_folded_hiz_tiles(starts, pair_data, chunk_minz, tiles_x):
    """Hierarchical-z visibility of every tile over z-sorted segments:
    (depth [T, 1024] f32, +inf empty; ids [T, 1024] i32, -1 empty).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  `vis_folded_hiz_tiles.launches` counts kernel launches."""
    if not starts.is_cuda:
        return vis_folded_hiz_plain(starts, pair_data, chunk_minz, tiles_x)
    n_tiles = starts.shape[0] - 1
    if (starts.dtype != torch.int32 or pair_data.dtype != torch.float32
            or chunk_minz.dtype != torch.float32):
        raise TypeError("vis_folded_hiz: starts must be int32, pair_data and "
                        "chunk_minz float32")
    nb = pair_data.shape[0]
    if (pair_data.shape[1:] != (HIZ_CHUNK, NCOL) or tuple(chunk_minz.shape) != (nb,)
            or pair_data.device != starts.device or chunk_minz.device != starts.device):
        raise ValueError(f"vis_folded_hiz: pair_data must be [nb, {HIZ_CHUNK}, {NCOL}] "
                         f"and chunk_minz [nb] on {starts.device}, got "
                         f"{tuple(pair_data.shape)} on {pair_data.device} and "
                         f"{tuple(chunk_minz.shape)} on {chunk_minz.device}")
    if not (starts.is_contiguous() and pair_data.is_contiguous()
            and chunk_minz.is_contiguous()):
        raise ValueError("vis_folded_hiz: inputs must be contiguous")
    depth = torch.empty((n_tiles, PIX), dtype=torch.float32, device=starts.device)
    ids = torch.empty((n_tiles, PIX), dtype=torch.int32, device=starts.device)
    lib = _hiz_library()
    with torch.cuda.device(starts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vis_folded_hiz_launch(
            starts.data_ptr(), pair_data.data_ptr(), chunk_minz.data_ptr(), n_tiles,
            tiles_x, nb, depth.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vis_folded_hiz kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    vis_folded_hiz_tiles.launches += 1
    return depth, ids


vis_folded_hiz_tiles.launches = 0


def _library(defines=()):
    """The built vis_folded library; `defines` (e.g. ("K1_PIECE_ROWS=512",))
    builds a variant of the kernel's compile-time constants, for sweeps."""
    lib = cuda_build.load_library("vis_folded", defines)
    lib.vis_folded_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vis_folded_launch.restype = ctypes.c_int
    lib.vis_folded_piece_rows.restype = ctypes.c_int
    return lib


def _hiz_library():
    lib = cuda_build.load_library("vis_folded_hiz")
    lib.vis_folded_hiz_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vis_folded_hiz_launch.restype = ctypes.c_int
    return lib


def unfold_tiles(a, tiles_y, tiles_x, height, width):
    """[T, 1024] tile-major -> [height, width]."""
    return (a.reshape(tiles_y, tiles_x, TILE, TILE).permute(0, 2, 1, 3)
            .reshape(tiles_y * TILE, tiles_x * TILE)[:height, :width])


def rasterize_vis_folded(setup: TriSetup, width, height, chunk=128,
                         pair_capacity=None, hiz=False):
    """Folded-tile rasterization of the [height, width] screen; hiz walks
    z-sorted segments with the early exit (exact: the same ids).

    Returns (depth [H,W] f32, +inf empty; tri_id [H,W] i32, -1 empty;
    overflow i32[2] = [0, total_pairs]).  overflow[0] is always 0 (segments
    of any depth are walked in full); total_pairs > pair_capacity means the
    binning dropped pairs."""
    bins = bin_triangles(setup, width, height, TILE, pair_capacity, chunk, z_order=hiz)
    if hiz:
        depth_t, id_t = vis_folded_hiz_tiles(bins.starts, bins.pair_data, bins.chunk_minz,
                                             bins.tiles_x)
    else:
        depth_t, id_t = vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x)
    depth = unfold_tiles(depth_t, bins.tiles_y, bins.tiles_x, height, width)
    tri = unfold_tiles(id_t, bins.tiles_y, bins.tiles_x, height, width)
    ovf = torch.stack([torch.zeros_like(bins.total_pairs), bins.total_pairs])
    return depth, tri, ovf
