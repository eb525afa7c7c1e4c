"""Folded-tile visibility rasterizer (counterpart of
vulkan_pbr_renderer_tpu/raster/visibility_v2.py::rasterize_vis_folded).

Binning (binning.py) sorts triangle/tile pairs into per-tile segments
[starts[t], starts[t+1]) of 13-column rows; the visibility pass then walks
each 32x32 tile's own segment and keeps, per pixel, the nearest depth and the
smallest id among equal depths.  On a CUDA tensor that pass is the
hand-written kernel csrc/vis_folded.cu; on a CPU tensor it is the plain
PyTorch version `vis_folded_plain`, which does the same arithmetic.  The
kernel walks a work list that cuts each segment into pieces of at most the
kernel's piece length, one block each; the pieces of a tile merge on the
(depth, id) key, so the result is the same.  The kernel's library builds
that list itself, in one block just before the raster kernel
(csrc/work_list.cuh); `folded_work_list` (over `segment_work_list`, which
K2 shares) is the same list in PyTorch ops, which the tests and
chip_smoke.py hold the card's list to.

With hiz=True (the JAX kernel's hierarchical-z body, visibility_v2.py:128-185)
the segments are sorted front to back (binning z_order=True) and the walk
stops once every pixel of the tile is covered nearer than the next block's
chunk_minz bound: csrc/vis_folded_hiz.cu on a CUDA tensor,
`vis_folded_hiz_plain` on a CPU tensor.  The hiz kernel walks a work list
whose pieces are whole global 128-row blocks clipped to the segment (the
bound and the tie rule's slot, row % 128, are per global block); it builds
the list itself in a one-block kernel.  `aligned_work_list` is that list in
PyTorch ops, which the kernel's own is held against, and
`vis_folded_hiz_pieces` the CPU model of the kernel's piece merge, skip test
and tie re-resolve, held against the plain version by the tests.

Every function here takes `y_origin`, the first pixel row of the band it
rasterizes (visibility_v2.py:76, the row-sharded frame of
parallel/sharding.py): the band's rows [y_origin, y_origin + height) are
binned and a pixel's row is ty * 32 + its row in the tile + y_origin, added
as integers before the f32 convert, as the JAX kernel does.
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
HIZ_MARK_WORDS = PIX // 64    # its per-tile mark bits, one per pixel, in 64-bit words


def _tile_pixel_centers(tiles, tiles_x, device, y_origin=0):
    """px, py [k, PIX] pixel centers of the given tiles (row-major inside a
    tile: local index q = y*32 + x) of a band starting at row y_origin."""
    q = torch.arange(PIX, device=device)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    px = (tx * TILE + q % TILE).to(torch.float32) + 0.5
    py = (ty * TILE + q // TILE + y_origin).to(torch.float32) + 0.5
    return px, py


def vis_folded_plain(starts, pair_data, tiles_x, tiles=None, row_chunk=2048, y_origin=0):
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
    px_t, py_t = _tile_pixel_centers(tiles, tiles_x, dev, y_origin)
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


def aligned_work_list_length(n_tiles, pair_data, piece_rows):
    """The static length of the aligned work list: the tiles touch at most
    ceil(capacity / piece_rows) global blocks, each tile after the first in
    a block adds one entry, and an empty tile keeps one."""
    cap = pair_data.numel() // pair_data.shape[-1]
    return n_tiles + -(-cap // piece_rows)


def aligned_work_list(starts, piece_rows, n_items, piece_major=True):
    """The hiz kernel's work list: int32 [n_items, 4] rows (tile, lo, hi,
    pieces), tile t's segment [starts[t], starts[t+1]) cut at the multiples
    of piece_rows of the GLOBAL row index, so that every piece is a run of
    whole chunk-aligned blocks clipped to the segment (piece_rows is a
    multiple of HIZ_CHUNK).  An empty tile keeps one empty piece; entries
    past the last piece are (-1, 0, 0, 0); n_items >=
    aligned_work_list_length holds every piece.  csrc/vis_folded_hiz.cu
    builds the same list in one kernel (these twenty-odd launches cost more
    host time than its raster kernel takes on the card); this version
    serves the CPU model and checks the kernel's list.

    piece_major orders the live entries by (piece index in its tile, tile):
    a grid that takes entries in order runs every tile front to back, so a
    tile's far pieces start after its near ones have merged and the skip
    test against the merged depths bites; otherwise the order is (tile,
    piece)."""
    dev = starts.device
    n_tiles = starts.shape[0] - 1
    if n_tiles == 0:
        out = torch.zeros((n_items, 4), dtype=torch.int32, device=dev)
        out[:, 0] = -1
        return out
    st = starts.to(torch.int64)
    lo, hi = st[:-1], torch.maximum(st[1:], st[:-1])
    blk0 = lo // piece_rows
    pieces = torch.where(hi > lo, (hi - 1) // piece_rows - blk0 + 1, 1)
    ends = torch.cumsum(pieces, 0)
    item = torch.arange(n_items, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(ends, item, right=True)
    live = tile < n_tiles
    tc = tile.clamp(max=n_tiles - 1)
    j = item - (ends[tc] - pieces[tc])
    plo = torch.maximum(lo[tc], (blk0[tc] + j) * piece_rows)
    phi = torch.minimum(hi[tc], (blk0[tc] + j + 1) * piece_rows)
    out = torch.stack([tile, plo, phi, pieces[tc]], 1) * live[:, None]
    out[:, 0] -= (~live).to(torch.int64)
    if piece_major:
        key = torch.where(live, j * n_tiles + tile, n_items * (n_tiles + 1))
        out = out[torch.argsort(key, stable=True)]
    return out.to(torch.int32)


def vis_folded_tiles(starts, pair_data, tiles_x, y_origin=0):
    """Visibility of every tile: (depth [T, 1024] f32, +inf empty;
    ids [T, 1024] i32, -1 empty).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  `vis_folded_tiles.launches` counts kernel launches, one
    per call."""
    if not starts.is_cuda:
        return vis_folded_plain(starts, pair_data, tiles_x, y_origin=y_origin)
    if starts.dtype != torch.int32 or pair_data.dtype != torch.float32:
        raise TypeError("vis_folded: starts must be int32 and pair_data float32")
    if pair_data.shape[-1] != NCOL or pair_data.device != starts.device:
        raise ValueError(f"vis_folded: pair_data must be [..., {NCOL}] on "
                         f"{starts.device}, got {tuple(pair_data.shape)} on "
                         f"{pair_data.device}")
    if not (starts.is_contiguous() and pair_data.is_contiguous()):
        raise ValueError("vis_folded: inputs must be contiguous")
    depth, ids, _ = run_vis_folded(_library(), starts, pair_data, tiles_x, y_origin)
    vis_folded_tiles.launches += 1
    return depth, ids


vis_folded_tiles.launches = 0


def run_vis_folded(lib, starts, pair_data, tiles_x, y_origin=0):
    """Launch a built vis_folded library on checked CUDA inputs: its
    work-list kernel (the list of `folded_work_list` for its piece length)
    and its raster kernel, on the current stream with no host sync.
    Returns (depth, ids, items): items is the work list the kernel built."""
    n_tiles = starts.shape[0] - 1
    dev = starts.device
    n_items = work_list_length(n_tiles, pair_data, lib.vis_folded_piece_rows())
    items = torch.empty((n_items, 4), dtype=torch.int32, device=dev)
    depth = torch.empty((n_tiles, PIX), dtype=torch.float32, device=dev)
    ids = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    # all ones: per-pixel merge keys, per-tile arrival counters and the work
    # counter; then the list build's per-tile words
    scratch = torch.full((n_tiles * PIX + n_tiles + 1 + (n_tiles + 1) // 2,), -1,
                         dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vis_folded_launch(
            starts.data_ptr(), n_tiles, items.data_ptr(), n_items, pair_data.data_ptr(),
            tiles_x, int(y_origin), depth.data_ptr(), ids.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vis_folded kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return depth, ids, items


def vis_folded_hiz_plain(starts, pair_data, chunk_minz, tiles_x, tiles=None, group=16,
                         rows_walked=False, y_origin=0):
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
        px, py = _tile_pixel_centers(tg, tiles_x, dev, y_origin)
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


def _first_tied_ids(rows, row0, zf, px, py):
    """The tie rule over a whole segment for pixels whose final depth zf [M]
    is known: per slot (global row % HIZ_CHUNK, rows [R, 13] starting at
    global row row0) the first row at exactly zf, then the smallest id over
    the slots.  px, py [M]."""
    z = depth_at(rows, px[None, :], py[None, :])                       # [R, M]
    tied = z == zf[None, :]
    r = torch.arange(rows.shape[0], device=rows.device)
    slot = (row0 + r) % HIZ_CHUNK
    big = torch.iinfo(torch.int64).max
    first = torch.full((HIZ_CHUNK, zf.shape[0]), big, dtype=torch.int64, device=rows.device)
    first.scatter_reduce_(0, slot[:, None].expand(-1, zf.shape[0]),
                          torch.where(tied, r[:, None], big), "amin")
    ids = (rows[:, 12].abs() - 1.0).to(torch.int64)
    held = torch.where(first < big, ids[first.clamp(max=rows.shape[0] - 1)], big)
    return held.amin(0).to(torch.int32)


def vis_folded_hiz_pieces(starts, pair_data, chunk_minz, tiles_x, piece_rows=HIZ_CHUNK,
                          reverse=False, skip=True, piece_major=True, y_origin=0):
    """CPU model of the hiz kernel (csrc/vis_folded_hiz.cu), piece by piece
    in work-list order (reversed with `reverse`), for the tests.

    A piece walks its global blocks.  With `skip`, a block b is left out
    when chunk_minz[b] > the largest of the tile's merged depths so far
    (+inf while a pixel is empty; read once per piece, as the kernel reads
    it).  Inside a block every row has its own slot, so the nearer row wins
    and equal depths keep the smaller id; a tie between two blocks of one
    piece marks the pixel.  The piece merges into the tile by the minimum
    (depth bits, id) key; a merge that meets its own depth in the tile's
    key marks the pixel.  At the end the marked pixels are re-resolved by
    the strict rule over the whole segment (`_first_tied_ids`).

    Returns (depth [T, 1024] f32, ids [T, 1024] i32, stats dict with
    rows_walked and marked_pixels)."""
    dev = starts.device
    n_tiles = starts.shape[0] - 1
    items = aligned_work_list(
        starts, piece_rows, aligned_work_list_length(n_tiles, pair_data, piece_rows),
        piece_major=piece_major).tolist()
    items = [it for it in items if it[0] >= 0]
    rows_all = pair_data.reshape(-1, NCOL)
    inf = float("inf")
    best = torch.full((n_tiles, PIX), INT64_MAX, dtype=torch.int64, device=dev)
    marked = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=dev)
    zmax = torch.full((n_tiles,), inf, device=dev)
    walked = 0
    for t, lo, hi, pieces in (items[::-1] if reverse else items):
        if hi == lo:
            continue
        px, py = _tile_pixel_centers(torch.tensor([t], device=dev), tiles_x, dev, y_origin)
        bound = float(zmax[t]) if (skip and pieces > 1) else inf
        p_z = torch.full((PIX,), inf, device=dev)
        p_id = torch.full((PIX,), -1, dtype=torch.int32, device=dev)
        p_blk = torch.full((PIX,), -1, dtype=torch.int64, device=dev)
        p_mark = torch.zeros((PIX,), dtype=torch.bool, device=dev)
        for blk in range(lo // HIZ_CHUNK, (hi - 1) // HIZ_CHUNK + 1):
            if float(chunk_minz[blk]) > bound:
                continue
            r0, r1 = max(lo, blk * HIZ_CHUNK), min(hi, (blk + 1) * HIZ_CHUNK)
            walked += r1 - r0
            rows = rows_all[r0:r1]
            ids = (rows[:, 12].abs() - 1.0).to(torch.int32)
            key = depth_id_key(depth_at(rows, px, py), ids[:, None]).amin(0)
            b_z, b_id = key_to_depth_id(key)
            nearer = b_z < p_z
            tie = (b_z == p_z) & (b_id >= 0)
            p_mark = (p_mark & ~nearer) | (tie & (p_blk != blk))
            p_id = torch.where(nearer, b_id, torch.where(tie, torch.minimum(p_id, b_id), p_id))
            p_blk = torch.where(nearer, blk, p_blk)
            p_z = torch.where(nearer, b_z, p_z)
        key = depth_id_key(p_z, p_id)
        covered = p_id >= 0
        same_depth = covered & (best[t] != INT64_MAX) & ((best[t] >> 32) == (key >> 32))
        marked[t] |= same_depth | p_mark
        best[t] = torch.minimum(best[t], key)
        merged = key_to_depth_id(best[t])[0].amax()
        zmax[t] = torch.minimum(zmax[t], merged)
    depth, ids = key_to_depth_id(best)
    st = starts.to(torch.int64)
    for t in torch.nonzero(marked.any(1)).flatten().tolist():
        m = marked[t]
        px, py = _tile_pixel_centers(torch.tensor([t], device=dev), tiles_x, dev, y_origin)
        ids[t, m] = _first_tied_ids(rows_all[int(st[t]):int(st[t + 1])], int(st[t]),
                                    depth[t, m], px[0, m], py[0, m])
    return depth, ids, dict(rows_walked=walked, marked_pixels=int(marked.sum()))


def vis_folded_hiz_tiles(starts, pair_data, chunk_minz, tiles_x, y_origin=0):
    """Hierarchical-z visibility of every tile over z-sorted segments:
    (depth [T, 1024] f32, +inf empty; ids [T, 1024] i32, -1 empty).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.  `vis_folded_hiz_tiles.launches` counts kernel launches."""
    if not starts.is_cuda:
        return vis_folded_hiz_plain(starts, pair_data, chunk_minz, tiles_x, y_origin=y_origin)
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
    depth, ids, _, _ = run_vis_folded_hiz(_hiz_library(), starts, pair_data, chunk_minz,
                                          tiles_x, stats=False, y_origin=y_origin)
    vis_folded_hiz_tiles.launches += 1
    return depth, ids


vis_folded_hiz_tiles.launches = 0

def run_vis_folded_hiz(lib, starts, pair_data, chunk_minz, tiles_x, piece_major=True,
                       max_blocks=0, stats=True, y_origin=0):
    """Launch a built vis_folded_hiz library on checked CUDA inputs: the
    scratch, then its work-list kernel (the list of `aligned_work_list` for
    its piece length; with piece_major the order inside a group of equal
    piece index is the atomics') and its raster kernel, on the current
    stream with no host sync.  max_blocks > 0 caps the grid (1: one block
    walks the list serially, so every tile exits where the serial walk
    does).  Returns (depth, ids, stats, items): stats (None unless asked
    for: it costs a launch) is an int64 [2] device tensor, the segment rows
    the pieces walked (the others were skipped by the early exit; it depends
    on timing) and the pixels that took the tie re-resolve; items is the work
    list the kernel built."""
    n_tiles = starts.shape[0] - 1
    dev = starts.device
    n_items = aligned_work_list_length(n_tiles, pair_data, lib.vis_folded_hiz_piece_rows())
    items = torch.empty((n_items, 4), dtype=torch.int32, device=dev)
    work = torch.empty((3 * n_items,), dtype=torch.int32, device=dev)
    depth = torch.empty((n_tiles, PIX), dtype=torch.float32, device=dev)
    ids = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    # all ones: per-pixel merge keys, per-tile arrival counters, per-tile
    # merged-depth bounds, per-pixel mark bits (a cleared bit is a mark), and
    # the work, rows-walked and marked-pixel counters
    scratch = torch.full((n_tiles * (PIX + 2 + HIZ_MARK_WORDS) + 3,), -1, dtype=torch.int64,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vis_folded_hiz_launch(
            starts.data_ptr(), pair_data.data_ptr(), chunk_minz.data_ptr(), tiles_x,
            int(y_origin), n_tiles,
            items.data_ptr(), n_items, work.data_ptr(), int(piece_major), depth.data_ptr(),
            ids.data_ptr(), scratch.data_ptr(), max_blocks, stream)
    if err != 0:
        raise RuntimeError(f"vis_folded_hiz kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    return depth, ids, scratch[-2:] + 1 if stats else None, items


def _library(defines=()):
    """The built vis_folded library; `defines` (e.g. ("K1_PIECE_ROWS=512",))
    builds a variant of the kernel's compile-time constants, for sweeps."""
    lib = cuda_build.load_library("vis_folded", defines)
    lib.vis_folded_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.vis_folded_launch.restype = ctypes.c_int
    lib.vis_folded_piece_rows.restype = ctypes.c_int
    return lib


def _hiz_library(defines=()):
    """The built vis_folded_hiz library; `defines` (e.g.
    ("KHIZ_PIECE_ROWS=256",)) builds a variant, for sweeps."""
    lib = cuda_build.load_library("vis_folded_hiz", defines)
    lib.vis_folded_hiz_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.vis_folded_hiz_launch.restype = ctypes.c_int
    lib.vis_folded_hiz_piece_rows.restype = ctypes.c_int
    return lib


def unfold_tiles(a, tiles_y, tiles_x, height, width):
    """[T, 1024] tile-major -> [height, width]."""
    return (a.reshape(tiles_y, tiles_x, TILE, TILE).permute(0, 2, 1, 3)
            .reshape(tiles_y * TILE, tiles_x * TILE)[:height, :width])


def rasterize_vis_folded(setup: TriSetup, width, height, chunk=128,
                         pair_capacity=None, hiz=False, y_origin=0):
    """Folded-tile rasterization of the rows [y_origin, y_origin + height)
    of a `width`-wide screen; hiz walks z-sorted segments with the early
    exit (exact: the same ids).

    Returns (depth [H,W] f32, +inf empty; tri_id [H,W] i32, -1 empty;
    overflow i32[2] = [0, total_pairs]).  overflow[0] is always 0 (segments
    of any depth are walked in full); total_pairs > pair_capacity means the
    binning dropped pairs."""
    bins = bin_triangles(setup, width, height, TILE, pair_capacity, chunk, z_order=hiz,
                         y_origin=y_origin)
    if hiz:
        depth_t, id_t = vis_folded_hiz_tiles(bins.starts, bins.pair_data, bins.chunk_minz,
                                             bins.tiles_x, y_origin)
    else:
        depth_t, id_t = vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x, y_origin)
    depth = unfold_tiles(depth_t, bins.tiles_y, bins.tiles_x, height, width)
    tri = unfold_tiles(id_t, bins.tiles_y, bins.tiles_x, height, width)
    ovf = torch.stack([torch.zeros_like(bins.total_pairs), bins.total_pairs])
    return depth, tri, ovf
