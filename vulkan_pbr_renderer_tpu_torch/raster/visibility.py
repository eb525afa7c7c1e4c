"""Rowblock visibility rasterizer (counterpart of
vulkan_pbr_renderer_tpu/raster/visibility.py::rasterize_vis_tiled,
`raster_kernel="rowblock"`).

Binning (binning.py, fmt "wide16") sorts triangle/tile pairs into per-tile
segments of 16-column rows over 32x128 tiles.  The visibility pass walks at
most tile_capacity // chunk chunk-sized pair blocks of each segment (counted
from the block holding the segment's start), evaluates each pair only on the
8-row blocks its bbox rows touch, and keeps per pixel the nearest depth,
the first-processed pair winning ties.  On a CUDA tensor that pass is the
hand-written kernel csrc/vis_rowblock.cu; on a CPU tensor it is the plain
PyTorch version `vis_rowblock_plain`, which does the same arithmetic.  The
kernel walks a work list that cuts each tile's capacity-cut range into
pieces of at most the kernel's piece length, one block each; the pieces of
a tile merge on the (depth, pair index) key, the plain version's, so the
result is the same.  The kernel's library builds that list itself, the cut
included, in one block just before the raster kernel (csrc/work_list.cuh);
`rowblock_work_list` is the same list in PyTorch ops, which the tests and
chip_smoke.py hold the card's list to.

Every function here takes `y_origin`, the first pixel row of the band it
rasterizes (the row-sharded frame of parallel/sharding.py): the band's rows
are binned, and a tile's first row is the f32 sum (ty * 32) + y_origin, as
at visibility.py:66 of the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ..gpu import cuda_build
from .binning import NCOL_WIDE, bin_triangles
from .setup import TriSetup
from .visibility_v2 import segment_work_list, work_list_length
from .xla_raster import INT64_MAX, depth_at, depth_id_key

TILE_H, TILE_W, BLOCK_H = 32, 128, 8
PIX = TILE_H * TILE_W


def capacity_ranges(starts, tile_capacity, chunk, tiles=None):
    """(lo, hi) i64 of the pairs each tile processes: the segment
    [starts[t], starts[t+1]) cut at the tile's capacity (visibility.py:58-61
    with n_chunks = tile_capacity // chunk); hi < lo only when the capacity
    is 0 (an empty range).  tiles: optional i64 subset (default all)."""
    st = starts.to(torch.int64)
    if tiles is None:
        tiles = torch.arange(st.shape[0] - 1, device=st.device)
    lo = st[tiles]
    cap_end = (lo // chunk + tile_capacity // chunk) * chunk
    return lo, torch.minimum(st[tiles + 1], cap_end)


def _segments(starts, tiles, tile_capacity, chunk):
    """(slot, pair index) of every pair the given tiles process, in segment
    order (capacity_ranges)."""
    dev = starts.device
    lo, hi = capacity_ranges(starts, tile_capacity, chunk, tiles)
    lens = torch.clamp(hi - lo, min=0)
    slot = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev), lens)
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    pair = torch.repeat_interleave(lo, lens) + (
        torch.arange(slot.shape[0], device=dev) - first)
    return slot, pair


def vis_rowblock_plain(starts, pair_data, tiles_x, tile_capacity, chunk, tiles=None,
                       row_chunk=256, y_origin=0):
    """Plain PyTorch version of the kernel.  tiles: optional i64 [k] subset
    of tile indices (default all).  Returns tile-major (depth [k, 4096] f32,
    +inf empty; ids [k, 4096] i32, -1 empty), pixel q = y*128 + x.

    The first processed pair wins ties: pairs are processed in segment
    order, so each pixel keeps the (depth, pair index) minimum."""
    dev = starts.device
    rows_all = pair_data.reshape(-1, NCOL_WIDE)
    if tiles is None:
        tiles = torch.arange(starts.shape[0] - 1, device=dev)
    tiles = tiles.to(torch.int64)
    slot, pair = _segments(starts, tiles, tile_capacity, chunk)
    q = torch.arange(PIX, device=dev)
    qx, qy = q % TILE_W, q // TILE_W
    px_t = ((tiles % tiles_x)[:, None] * TILE_W + qx).to(torch.float32) + 0.5
    y0f = ((tiles // tiles_x) * TILE_H).to(torch.float32) + y_origin
    py_t = y0f[:, None] + (qy.to(torch.float32) + 0.5)
    best = torch.full((tiles.shape[0], PIX), INT64_MAX, dtype=torch.int64, device=dev)
    blk = (qy // BLOCK_H)[None, :]
    for s in range(0, pair.shape[0], row_chunk):
        p = pair[s:s + row_chunk]
        sl = slot[s:s + row_chunk]
        rows = rows_all[p]
        y0 = y0f[sl]
        rb0 = torch.clamp(torch.floor((rows[:, 13] - y0) / BLOCK_H), min=0)
        rb1 = torch.clamp(torch.floor((rows[:, 14] - 1.0 - y0) / BLOCK_H),
                          max=TILE_H // BLOCK_H - 1)
        z = depth_at(rows, px_t[sl], py_t[sl], vert=rows[:, 15:16] > 0.5)
        culled = (blk < rb0[:, None]) | (blk > rb1[:, None])
        z = torch.where(culled, torch.full_like(z, float("inf")), z)
        key = depth_id_key(z, p[:, None])
        best.scatter_reduce_(0, sl[:, None].expand(-1, PIX), key, "amin")
    empty = best == INT64_MAX
    depth = (best >> 32).to(torch.int32).view(torch.float32)
    depth = torch.where(empty, torch.full_like(depth, float("inf")), depth)
    win = torch.where(empty, 0, best & 0xFFFFFFFF)
    ids = rows_all[win, 12].to(torch.int32)
    ids = torch.where(empty, torch.full_like(ids, -1), ids)
    return depth, ids


def rowblock_work_list(starts, tile_capacity, chunk, piece_rows, n_items):
    """The kernel's work list (visibility_v2.segment_work_list) over each
    tile's capacity-cut range: int32 [n_items, 4] rows (tile, lo, hi,
    pieces), surplus entries (-1, 0, 0, 0)."""
    lo, hi = capacity_ranges(starts, tile_capacity, chunk)
    return segment_work_list(lo, hi, piece_rows, n_items)


def vis_rowblock_tiles(starts, pair_data, tiles_x, tile_capacity, chunk, y_origin=0):
    """Visibility of every 32x128 tile: tile-major (depth [T, 4096] f32, +inf
    empty; ids [T, 4096] i32, -1 empty).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  `vis_rowblock_tiles.launches` counts kernel launches, one
    per call."""
    if not starts.is_cuda:
        return vis_rowblock_plain(starts, pair_data, tiles_x, tile_capacity, chunk,
                                  y_origin=y_origin)
    if starts.dtype != torch.int32 or pair_data.dtype != torch.float32:
        raise TypeError("vis_rowblock: starts must be int32 and pair_data float32")
    if pair_data.shape[-1] != NCOL_WIDE or pair_data.device != starts.device:
        raise ValueError(f"vis_rowblock: pair_data must be [..., {NCOL_WIDE}] on "
                         f"{starts.device}, got {tuple(pair_data.shape)} on "
                         f"{pair_data.device}")
    if not (starts.is_contiguous() and pair_data.is_contiguous()):
        raise ValueError("vis_rowblock: inputs must be contiguous")
    if pair_data.data_ptr() % 16:
        raise ValueError("vis_rowblock: pair_data must be 16-byte aligned")
    if chunk <= 0 or tile_capacity % chunk:
        raise ValueError(f"vis_rowblock: tile_capacity {tile_capacity} must be a "
                         f"multiple of chunk {chunk}")
    depth, ids, _ = run_vis_rowblock(_library(), starts, pair_data, tiles_x, tile_capacity,
                                     chunk, y_origin)
    vis_rowblock_tiles.launches += 1
    return depth, ids


vis_rowblock_tiles.launches = 0


def run_vis_rowblock(lib, starts, pair_data, tiles_x, tile_capacity, chunk, y_origin=0):
    """Launch a built vis_rowblock library on checked CUDA inputs: its
    work-list kernel (the list of `rowblock_work_list` for its piece length,
    the capacity cut computed there) and its raster kernel, on the current
    stream with no host sync.  Returns (depth, ids, items): items is the
    work list the kernel built."""
    n_tiles = starts.shape[0] - 1
    dev = starts.device
    n_items = work_list_length(n_tiles, pair_data, lib.vis_rowblock_piece_rows())
    items = torch.empty((n_items, 4), dtype=torch.int32, device=dev)
    depth = torch.empty((n_tiles, PIX), dtype=torch.float32, device=dev)
    ids = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    # all ones: per-pixel merge keys, per-(tile, row block) arrival counters
    # and the work counter; then the list build's per-tile words
    scratch = torch.full((n_tiles * PIX + n_tiles * (TILE_H // BLOCK_H) + 1
                          + (n_tiles + 1) // 2,), -1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vis_rowblock_launch(
            starts.data_ptr(), n_tiles, chunk, tile_capacity // chunk, items.data_ptr(),
            n_items, pair_data.data_ptr(), tiles_x, int(y_origin), depth.data_ptr(),
            ids.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vis_rowblock kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return depth, ids, items


def _library(defines=()):
    """The built vis_rowblock library; `defines` (e.g. ("K2_PIECE_ROWS=512",))
    builds a variant of the kernel's compile-time constants, for sweeps."""
    lib = cuda_build.load_library("vis_rowblock", defines)
    lib.vis_rowblock_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vis_rowblock_launch.restype = ctypes.c_int
    lib.vis_rowblock_piece_rows.restype = ctypes.c_int
    return lib


def unfold_tiles(a, tiles_y, tiles_x, height, width):
    """[T, 32*128] tile-major -> [height, width]."""
    return (a.reshape(tiles_y, tiles_x, TILE_H, TILE_W).permute(0, 2, 1, 3)
            .reshape(tiles_y * TILE_H, tiles_x * TILE_W)[:height, :width])


def rasterize_vis_tiled(setup: TriSetup, width, height, tile_h=32, tile_w=128,
                        tile_capacity=4096, chunk=128, block_h=8, pair_capacity=None,
                        return_overflow=False, y_origin=0):
    """Rowblock rasterization of the rows [y_origin, y_origin + height) of a
    `width`-wide screen.

    Returns (depth [H,W] f32, +inf empty; tri_id [H,W] i32, -1 empty), and
    with return_overflow=True also i32[2] = [max_tile_segment, total_pairs]:
    max_tile_segment > tile_capacity or total_pairs > pair_capacity means
    triangles were dropped."""
    if (tile_h, tile_w, block_h) != (TILE_H, TILE_W, BLOCK_H):
        raise ValueError(f"rowblock tile {tile_h}x{tile_w}, block {block_h}: the "
                         "kernel is built for 32x128 tiles of 8-row blocks")
    bins = bin_triangles(setup, width, height, tile_h, pair_capacity, chunk,
                         fmt="wide16", tile_w=tile_w, y_origin=y_origin)
    depth_t, id_t = vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x,
                                       tile_capacity, chunk, y_origin)
    depth = unfold_tiles(depth_t, bins.tiles_y, bins.tiles_x, height, width)
    tri = unfold_tiles(id_t, bins.tiles_y, bins.tiles_x, height, width)
    if return_overflow:
        return depth, tri, torch.stack([bins.max_segment.to(torch.int32),
                                        bins.total_pairs])
    return depth, tri
