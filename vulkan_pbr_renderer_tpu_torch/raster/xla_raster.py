"""Brute-force visibility rasterizer in plain PyTorch (counterpart of
vulkan_pbr_renderer_tpu/raster/xla_raster.py) — the semantic baseline of the
folded-tile kernel.

Per pixel the nearest covered depth wins; among exactly equal depths the
smallest triangle id; an empty pixel is (+inf, -1).  Depth is the rational
N/D with the range test 0 <= N <= D applied BEFORE the divide.  The edge and
depth arithmetic is written as explicit products and sums in the order of
the CUDA kernel (csrc/vis_folded.cu), never as a matmul/einsum, so the kernel
and this version agree bit for bit.
"""

from __future__ import annotations

import torch

from .binning import pack_tri_data_slim
from .setup import TriSetup

INT64_MAX = (1 << 63) - 1


def depth_at(rows, px, py, vert=None):
    """Rational depth of pair rows at pixel centers.

    rows [R,13] (binning.pack_tri_data_slim layout) or [R,16] (the "wide16"
    layout, which passes `vert`, its [R,1] z_mode mask); px, py broadcastable
    against [R, Q].  Returns z [R, Q] f32, +inf where the pixel is not
    covered."""
    def c(k):
        return rows[:, k:k + 1]

    e0 = c(0) * px + c(1) * py + c(2)
    e1 = c(3) * px + c(4) * py + c(5)
    e2 = c(6) * px + c(7) * py + c(8)
    esum = e0 + e1 + e2
    em = torch.minimum(torch.minimum(e0, e1), e2)
    zx, zy, zc = c(9), c(10), c(11)
    n_hp = zx * esum + (e1 * zy + e2 * zc)
    z_pl = zx * px + zy * py + zc
    if vert is None:
        vert = c(12) > 0.0
    n_sel = torch.where(vert, n_hp, z_pl)
    d_sel = torch.where(vert, esum, torch.ones_like(esum))
    cov = (em >= 0.0) & (esum > 0.0) & (n_sel >= 0.0) & (n_sel <= d_sel)
    z = n_sel / torch.where(d_sel == 0.0, torch.full_like(d_sel, 1e-20), d_sel)
    return torch.where(cov, z, torch.full_like(z, float("inf")))


def depth_id_key(z, ids):
    """int64 sort key (depth bits << 32 | id): its minimum is the nearest
    depth, then the smallest id.  z >= 0 wherever finite (the range test), so
    the f32 bit pattern orders like the value once -0.0 becomes +0.0."""
    zbits = (z + 0.0).view(torch.int32).to(torch.int64)
    key = (zbits << 32) | ids.to(torch.int64)
    return torch.where(torch.isinf(z), torch.full_like(key, INT64_MAX), key)


def key_to_depth_id(key):
    """Inverse of depth_id_key -> (depth f32 with +inf empty, id i32, -1 empty)."""
    empty = key == INT64_MAX
    depth = (key >> 32).to(torch.int32).view(torch.float32)
    ids = (key & 0xFFFFFFFF).to(torch.int32)
    depth = torch.where(empty, torch.full_like(depth, float("inf")), depth)
    ids = torch.where(empty, torch.full_like(ids, -1), ids)
    return depth, ids


def rasterize_vis(setup: TriSetup, width, height, tri_chunk=256, y_origin=0):
    """Brute-force depth-tested rasterization of all triangles over the
    rows [y_origin, y_origin + height) of the screen.  Returns (depth [H,W] f32, +inf where
    empty; tri_id [H,W] i32, -1 where empty)."""
    dev = setup.adj.device
    hw = height * width
    tri_chunk = max(8, min(tri_chunk, (1 << 26) // max(1, hw)))
    rows = pack_tri_data_slim(setup)
    ids = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)
    q = torch.arange(hw, device=dev)
    px = (q % width).to(torch.float32) + 0.5
    py = (q // width).to(torch.float32) + 0.5 + y_origin
    best = torch.full((hw,), INT64_MAX, dtype=torch.int64, device=dev)
    for s in range(0, rows.shape[0], tri_chunk):
        z = depth_at(rows[s:s + tri_chunk], px, py)
        key = depth_id_key(z, ids[s:s + tri_chunk, None])
        best = torch.minimum(best, key.amin(0))
    depth, tri = key_to_depth_id(best)
    return depth.reshape(height, width), tri.reshape(height, width)
