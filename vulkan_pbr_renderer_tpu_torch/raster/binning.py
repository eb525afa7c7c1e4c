"""Tile binning: exact per-tile triangle lists (counterpart of
vulkan_pbr_renderer_tpu/raster/binning.py, in both row formats: "slim13" for
the folded kernel, "wide16" for the rowblock kernel).

`bin_triangles` launches csrc/binning.cu on a CUDA tensor (or raises) and
takes `bin_triangles_plain` on a CPU tensor.  The plain version is a
static-shape pipeline over a pair buffer of `pair_capacity` rows:
1. per-triangle tile-bbox spans -> pair counts, exclusive cumsum = offsets;
2. each triangle scatters its id at its run start, cummax forward-fills the
   run, so every pair row knows its triangle; its tile follows by arithmetic;
3. one sort of an int64 key: (tile << 32) | tri, so the per-tile order is
   ascending triangle id (the kernel's tie rule relies on it); or, with
   z_order=True, (tile << 31) | (zq << tri_bits) | tri, front to back by the
   triangle's quantized minimum vertex depth zq (gathered by each row's
   triangle, where the JAX package forward-fills it), and `chunk_minz`, the minimum zq/zq_max of every
   `chunk`-row block of the sorted buffer (dead tail rows included) — the
   hierarchical-z bound of the folded kernel's early exit;
4. `starts` by searchsorted, and one gather of the packed rows.
The JAX package packs int32 keys because the TPU lacks fast int64.
`starts`, `pair_data` and `chunk_minz` equal the JAX arrays.

The kernels give the same bits another way, touching only the live rows
(`_launch`, its stages in order on one stream, no host sync): the setup
kernel (a thread per triangle) and torch.cumsum of its counts; then one
call of `binning_sort_launch`: count (a thread per live row finds its
triangle by a binary search over the sums, its tile and its 32-bit in-tile
key, tri or (zq << tri_bits) | tri, and takes a slot in its tile's
histogram), scan (one block: `starts`, the longest segment, the total),
scatter (each key to its slot), sort (a block per tile sorts a short run in
shared memory; runs longer than `SORT_KEYS` go to 1024-thread blocks that
radix-sort them in shared memory, in pieces of `RADIX_KEYS` merged where a
run is longer still) and pack (a thread per buffer row packs its row
straight from the setup fields, or the dead constant, stored as whole
float4 lines, and lowers its chunk's `chunk_minz`).  Within a tile the keys
are distinct, so their ascending order is the int64 sort's.  No library
sort is called.
"""

from __future__ import annotations

from typing import NamedTuple

import ctypes
from types import SimpleNamespace

import torch

from ..gpu import cuda_build
from .setup import TriSetup

NCOL = 13
NCOL_WIDE = 16


class TileBins(NamedTuple):
    pair_data: torch.Tensor    # [Pc/chunk, chunk, 13|16] f32 pair-ordered rows
    starts: torch.Tensor       # [T+1] i32 segment start of each tile
    tiles_x: int
    tiles_y: int
    max_segment: torch.Tensor  # i32 scalar: longest per-tile pair run
    total_pairs: torch.Tensor  # i32 scalar: true pair count before clipping
    chunk_minz: torch.Tensor   # [Pc/chunk] f32 lower bound of each block's
                               # depth (z_order); zeros otherwise


def pack_tri_data_slim(setup: TriSetup):
    """[N,13] f32: cols 0-8 edge coefficients (edge j = cols 3j..3j+2), 9-11
    depth (vertex-interp (z0,dz1,dz2) or screen plane), 12 = ±(id+1) with the
    sign carrying z_mode (+ = vertex-interp).  Invalid triangles get the dead
    edge (0, 0, -1) so coverage always fails."""
    n = setup.adj.shape[0]
    e = setup.adj.transpose(1, 2).reshape(n, 9)
    dead = torch.tensor([0, 0, -1, 0, 0, 1, 0, 0, 1], dtype=torch.float32,
                        device=e.device)
    e = torch.where(setup.valid[:, None], e, dead)
    z = torch.where(setup.z_mode[:, None], setup.z_vert, setup.c_z)
    ids1 = torch.arange(1, n + 1, dtype=torch.float32, device=e.device)
    enc = torch.where(setup.z_mode, ids1, -ids1)[:, None]
    return torch.cat([e, z, enc], dim=1)


def pack_tri_data(setup: TriSetup):
    """[N,16] f32 "wide16" rows: cols 0-8 edges, 9-11 depth, 12 the id
    (bin_triangles writes the sorted id there), 13-14 the pixel bbox rows
    y0 / y1 for the rowblock kernel's row-block cull, 15 z_mode (1 =
    vertex-interp depth)."""
    n = setup.adj.shape[0]
    e = setup.adj.transpose(1, 2).reshape(n, 9)
    dead = torch.tensor([0, 0, -1, 0, 0, 1, 0, 0, 1], dtype=torch.float32,
                        device=e.device)
    e = torch.where(setup.valid[:, None], e, dead)
    z = torch.where(setup.z_mode[:, None], setup.z_vert, setup.c_z)
    return torch.cat([e, z, torch.zeros_like(z[:, :1]),
                      setup.bbox[:, 1:2].to(torch.float32),
                      setup.bbox[:, 3:4].to(torch.float32),
                      setup.z_mode[:, None].to(torch.float32)], dim=1)


def _min_vertex_depth_q(setup: TriSetup, zq_max):
    """Per-triangle floor-quantized minimum vertex depth in [0, zq_max]
    (binning.py:229-235): z0 + min(0, dz1, dz2, dz1+dz2) clipped to [0, 1]
    for vertex-interpolated rows, 0 for screen-plane rows."""
    zv = setup.z_vert
    minz = zv[:, 0] + torch.clamp(
        torch.minimum(zv[:, 1], torch.minimum(zv[:, 2], zv[:, 1] + zv[:, 2])), max=0.0)
    minz = torch.where(setup.z_mode, torch.clamp(minz, 0.0, 1.0), 0.0)
    return torch.clamp((minz * zq_max).to(torch.int64), max=zq_max)


def _z_bits(n):
    """(tri_bits, zq_max) of the z_order key for n triangles."""
    tri_bits = max(1, (n - 1).bit_length())
    return tri_bits, (1 << min(12, 30 - tri_bits)) - 1


def bin_triangles_plain(setup: TriSetup, width, height, tile=32, pair_capacity=None,
                        chunk=128, fmt="slim13", tile_w=None, z_order=False,
                        y_origin=0) -> TileBins:
    """Bin triangles into tile x tile_w pixel tiles (tile rows high; tile_w
    defaults to tile) over the rows [y_origin, y_origin + height) of the
    viewport (binning.py:134-135: a band of the row-sharded frame).  Pairs beyond `pair_capacity` (rounded up to `chunk`) are
    dropped; total_pairs keeps the true count so the caller can detect the
    overflow.  fmt "slim13" packs pack_tri_data_slim rows (dead rows decode
    to id -1), "wide16" pack_tri_data rows with col 12 the triangle id as
    f32 (-1 on dead rows).  z_order sorts each segment front to back and
    fills chunk_minz (module docstring, step 3)."""
    dev = setup.adj.device
    n = setup.adj.shape[0]
    tile_h = tile
    tile_w = tile if tile_w is None else tile_w
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    n_tiles = tiles_x * tiles_y
    if pair_capacity is None:
        pair_capacity = 4 * n
    cap = -(-pair_capacity // chunk) * chunk

    bbox = setup.bbox.to(torch.int64)
    by0, by1 = bbox[:, 1] - y_origin, bbox[:, 3] - y_origin
    valid = setup.valid & (by1 > 0) & (by0 < height)
    tx0 = torch.clamp(bbox[:, 0] // tile_w, 0, tiles_x - 1)
    ty0 = torch.clamp(by0 // tile_h, 0, tiles_y - 1)
    tx1 = torch.clamp((bbox[:, 2] - 1) // tile_w, 0, tiles_x - 1)
    ty1 = torch.clamp((by1 - 1) // tile_h, 0, tiles_y - 1)
    zero = torch.zeros_like(tx0)
    ntx = torch.where(valid, tx1 - tx0 + 1, zero)
    nty = torch.where(valid, ty1 - ty0 + 1, zero)
    counts = ntx * nty
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()

    # forward-fill the triangle id over each triangle's run of pair rows
    tri_ids = torch.arange(n, dtype=torch.int64, device=dev)
    scatter_idx = torch.where((counts > 0) & (offsets < cap), offsets,
                              torch.full_like(offsets, cap))
    fill = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    fill.scatter_reduce_(0, scatter_idx, tri_ids, "amax")
    run_tri = torch.cummax(fill[:cap], 0).values      # -1 only if no pair at all
    tri_of = run_tri.clamp(0, max(n - 1, 0))

    p = torch.arange(cap, dtype=torch.int64, device=dev)
    in_range = p < total
    m = p - offsets[tri_of]
    ntx_p = ntx[tri_of].clamp(min=1)
    tile_of = (ty0[tri_of] * tiles_x + tx0[tri_of]
               + (m // ntx_p) * tiles_x + m % ntx_p)
    tile_of = torch.where(in_range, tile_of, torch.full_like(tile_of, n_tiles))

    if z_order:
        tri_bits, zq_max = _z_bits(n)
        # the JAX package forward-fills (tri << zq_bits) | zq; the run's
        # triangle is known here, so one gather gives the same zq (dead tail
        # rows carry the last triangle's; a buffer with no pair, zq_max)
        zq = torch.where(run_tri >= 0, _min_vertex_depth_q(setup, zq_max)[tri_of], zq_max)
        skey = torch.sort((tile_of << 31) | (zq << tri_bits) | tri_of).values
        sort_tile = skey >> 31
        sort_tri = skey & ((1 << tri_bits) - 1)
        zq_sorted = ((skey >> tri_bits) & zq_max).to(torch.float32) * (1.0 / zq_max)
        chunk_minz = zq_sorted.reshape(cap // chunk, chunk).amin(1)
    else:
        skey = torch.sort((tile_of << 32) | tri_of).values
        sort_tile = skey >> 32
        sort_tri = skey & 0xFFFFFFFF
        chunk_minz = torch.zeros(cap // chunk, dtype=torch.float32, device=dev)

    tile_range = torch.arange(n_tiles + 1, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sort_tile, tile_range, side="left").to(torch.int32)

    if fmt == "slim13":
        ncol, data = NCOL, pack_tri_data_slim(setup)[sort_tri]     # [cap, 13]
    elif fmt == "wide16":
        ncol, data = NCOL_WIDE, pack_tri_data(setup)[sort_tri]     # [cap, 16]
    else:
        raise ValueError(f"unknown binning fmt {fmt!r}")
    dead = torch.zeros(ncol, dtype=torch.float32, device=dev)
    dead[2] = -1.0
    data = torch.where(in_range[:, None], data, dead)
    if fmt == "wide16":
        data[:, 12] = torch.where(in_range, sort_tri, -1).to(torch.float32)
    return TileBins(
        pair_data=data.reshape(cap // chunk, chunk, ncol),
        starts=starts,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        max_segment=(starts[1:] - starts[:-1]).max(),
        total_pairs=total.to(torch.int32),
        chunk_minz=chunk_minz,
    )


def bin_triangles(setup: TriSetup, width, height, tile=32, pair_capacity=None,
                  chunk=128, fmt="slim13", tile_w=None, z_order=False,
                  y_origin=0) -> TileBins:
    """bin_triangles_plain's bins (its docstring).  A CUDA tensor launches
    the kernels of csrc/binning.cu (or raises); a CPU tensor takes the plain
    version.  `bin_triangles.launches` counts calls that launch them."""
    if not setup.adj.is_cuda:
        return bin_triangles_plain(setup, width, height, tile, pair_capacity, chunk, fmt,
                                   tile_w, z_order, y_origin)
    if fmt not in ("slim13", "wide16"):
        raise ValueError(f"unknown binning fmt {fmt!r}")
    dev, n = setup.adj.device, setup.adj.shape[0]
    f32, i32, b = torch.float32, torch.int32, torch.bool
    want = dict(adj=(f32, (n, 3, 3)), z_vert=(f32, (n, 3)), c_z=(f32, (n, 3)),
                z_mode=(b, (n,)), bbox=(i32, (n, 4)), valid=(b, (n,)))
    for name, (dtype, shape) in want.items():
        t = getattr(setup, name)
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise TypeError(f"bin_triangles: setup.{name} must be {dtype} {shape} on {dev}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = _plan(setup, width, height, tile, pair_capacity, chunk, fmt, tile_w, z_order,
                 y_origin)
    _launch(plan)
    bin_triangles.launches += 1
    return plan.bins


bin_triangles.launches = 0

# The longest tile run that the short sort takes (a block per tile, bitonic
# in shared memory; a power of two, 32 to 4096), and the longest run that the
# long sort sorts in shared memory in one piece (a stable radix sort; 32 to
# 12288); longer runs are sorted in pieces of that length and merged
# (csrc/binning.cu, the sort stage).
SORT_KEYS = 1024
RADIX_KEYS = 12288
# The stages of _launch: setup (the setup kernel and torch.cumsum), then the
# bits of binning_sort_launch in csrc/binning.cu.
STAGES = dict(setup=64, count=1, scan=2, scatter=4, short_sort=8, long_sort=16, pack=32)
ALL_STAGES = sum(STAGES.values())


def _plan(setup, width, height, tile=32, pair_capacity=None, chunk=128, fmt="slim13",
          tile_w=None, z_order=False, y_origin=0, sort_keys=SORT_KEYS, radix_keys=RADIX_KEYS):
    """One call of the kernels, not yet launched: the bins' geometry, the
    contiguous setup fields, the scratch and the output tensors (`bins`,
    written by _launch).  sort_keys and radix_keys (SORT_KEYS, RADIX_KEYS)
    choose the sort's paths; smaller values force its longer paths."""
    if sort_keys < 32 or sort_keys > 4096 or sort_keys & (sort_keys - 1):
        raise ValueError(f"sort_keys must be a power of two from 32 to 4096, got {sort_keys}")
    if not 32 <= radix_keys <= RADIX_KEYS:
        raise ValueError(f"radix_keys must be from 32 to {RADIX_KEYS}, got {radix_keys}")
    dev = setup.adj.device
    n = setup.adj.shape[0]
    tile_w = tile if tile_w is None else tile_w
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile)
    n_tiles = tiles_x * tiles_y
    if pair_capacity is None:
        pair_capacity = 4 * n
    cap = -(-pair_capacity // chunk) * chunk
    tri_bits, zq_max = _z_bits(n)
    ncol = NCOL_WIDE if fmt == "wide16" else NCOL
    i32 = torch.int32
    totals = torch.empty((2,), dtype=i32, device=dev)   # max_segment, total_pairs
    # one scratch tensor: rows [cap, 4] and info [n, 4] (first, for their
    # 16-byte alignment), ends i64 [n], counts [n], keys [cap], hist
    # [n_tiles], long_tiles [n_tiles], n_long, dead_zq
    scratch = torch.empty((4 * cap + 7 * n + cap + 2 * n_tiles + 2,), dtype=i32, device=dev)
    info_at, ends_at, counts_at = 4 * cap, 4 * cap + 4 * n, 4 * cap + 6 * n
    bins = TileBins(
        pair_data=torch.empty((cap // chunk, chunk, ncol), dtype=torch.float32, device=dev),
        starts=torch.empty((n_tiles + 1,), dtype=i32, device=dev), tiles_x=tiles_x,
        tiles_y=tiles_y, max_segment=totals[0], total_pairs=totals[1],
        chunk_minz=torch.empty((cap // chunk,), dtype=torch.float32, device=dev))
    return SimpleNamespace(
        n=n, cap=cap, chunk=chunk, tile=tile, tile_w=tile_w, height=height,
        y_origin=int(y_origin), n_tiles=n_tiles, z_order=bool(z_order), wide=fmt == "wide16",
        tri_bits=tri_bits, zq_max=zq_max, sort_keys=sort_keys, radix_keys=radix_keys,
        key_bits=tri_bits + (zq_max.bit_length() if z_order else 0), bins=bins, totals=totals,
        scratch=scratch, fields={k: getattr(setup, k).contiguous() for k in (
            "adj", "z_vert", "c_z", "z_mode", "bbox", "valid")},
        info=scratch[info_at:ends_at], ends=scratch[ends_at:counts_at].view(torch.int64),
        counts=scratch[counts_at:counts_at + n], keys_at=counts_at + n)


def _launch(plan, stages=ALL_STAGES):
    """Launch the stages of csrc/binning.cu that `stages` selects (bits of
    STAGES) on the current stream, with no host sync.  A stage reads only
    what the stages before it wrote, so once they have run it may run again
    alone (the card's stage timings); the long sort's merge reuses the
    count's per-row scratch, so a scatter after it needs the count again."""
    lib = _library()
    f, b = plan.fields, plan.bins
    with torch.cuda.device(plan.bins.starts.device):
        stream = torch.cuda.current_stream().cuda_stream
        if stages & STAGES["setup"]:
            _check(lib, lib.binning_setup_launch(
                f["bbox"].data_ptr(), f["valid"].data_ptr(), f["z_vert"].data_ptr(),
                f["z_mode"].data_ptr(), plan.n, plan.tile_w, plan.tile,
                b.tiles_x, b.tiles_y, plan.height, plan.y_origin,
                plan.zq_max if plan.z_order else 0, plan.counts.data_ptr(),
                plan.info.data_ptr(), stream), "setup")
            torch.cumsum(plan.counts, 0, dtype=torch.int64, out=plan.ends)
        if stages & ~STAGES["setup"]:
            cap, n_tiles = plan.cap, plan.n_tiles
            rows = plan.scratch.data_ptr()
            keys = rows + 4 * plan.keys_at
            hist = keys + 4 * cap
            long_tiles = hist + 4 * n_tiles
            n_long = long_tiles + 4 * n_tiles
            _check(lib, lib.binning_sort_launch(
                plan.ends.data_ptr(), plan.info.data_ptr(), plan.n, cap, plan.chunk, b.tiles_x,
                n_tiles, int(plan.z_order), plan.tri_bits, plan.zq_max, int(plan.wide),
                plan.sort_keys, plan.radix_keys, plan.key_bits, f["adj"].data_ptr(),
                f["z_vert"].data_ptr(), f["c_z"].data_ptr(), f["z_mode"].data_ptr(),
                f["valid"].data_ptr(), f["bbox"].data_ptr(), rows, keys, hist, long_tiles,
                n_long, n_long + 4, b.pair_data.data_ptr(), b.starts.data_ptr(),
                b.chunk_minz.data_ptr(), plan.totals.data_ptr(), plan.totals.data_ptr() + 4,
                stages & ~STAGES["setup"], stream), "sort")


def long_path_tiles(bins: TileBins, sort_keys=SORT_KEYS):
    """How many tiles' runs are longer than sort_keys: the long sort's
    tiles (with radix_keys for sort_keys: the runs it merges in global
    memory)."""
    return int(((bins.starts[1:] - bins.starts[:-1]) > sort_keys).sum())


def _check(lib, err, step):
    if err != 0:
        raise RuntimeError(f"binning {step} kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")


def _library():
    """The built binning library."""
    lib = cuda_build.load_library("binning")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.binning_setup_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p, p, p]
    lib.binning_sort_launch.argtypes = [p, p, i, ll, i, i, i, i, i, i, i, i, i, i, p, p, p, p,
                                        p, p, p, p, p, p, p, p, p, p, p, p, p, i, p]
    for fn in (lib.binning_setup_launch, lib.binning_sort_launch):
        fn.restype = ctypes.c_int
    return lib
