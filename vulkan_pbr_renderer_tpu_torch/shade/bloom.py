"""Physically-based bloom (counterpart of vulkan_pbr_renderer_tpu/shade/bloom.py;
bloom_downsample.glsl / bloom_upsample.glsl).

6 downsamples of the 13-tap Jimenez/CoD filter (firefly clamp at mip 1),
then 6 additive 9-tap tent upsamples, the last scaled by the bloom strength.
Each tap at uv + k*texel is a resize of an edge-clamped integer shift of the
source, exact at the 2:1 ratios of a power-of-two chain; a chain that meets
an odd size (1080 rows: 135 -> 67) takes jax.image.resize's linear filter,
`resize_linear`, as the reference package does.

A level is one call of `bloom_down_level` or `bloom_up_level`: on a CUDA
tensor one launch of csrc/post.cu's bloom_down_kernel or bloom_up_kernel
(the last up level also adds the tent to the HDR image and tonemaps it, and
each down level writes its bf16 band of the next frame's pyramid atlas); on
a CPU tensor their plain versions, `downsample_13tap` and `upsample_tent9`
below.  Either takes a row window of its output (the row-sharded frame).
A frame's whole down chain is one call of `bloom_down_chain`: on a CUDA
tensor one launch of csrc/post.cu's bloom_down_chain_kernel for every level
and its atlas band; on a CPU tensor the plain levels in turn.  Its whole up
chain and the tonemap are one call of `bloom_up_chain`: on a CUDA tensor one
launch of bloom_up_chain_kernel; on a CPU tensor the plain levels in turn.
`bloom_up_level` stays the bloom-off tonemap.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..gpu import cuda_build, sampling
from ..utils import color as colorlib


def _shift_edge(img, dy, dx):
    """img[y+dy, x+dx] with edge clamping, [H,W,C]."""
    h, w = img.shape[:2]
    iy = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, iy).index_select(1, ix)


def _box2(img):
    """Exact 2x2 box mean (even dims), its four terms summed as
    (a + b) + (c + d), then x0.25: the order csrc/post.cu follows (a mean
    over two dims leaves its order to the backend)."""
    a, b = img[0::2, 0::2], img[0::2, 1::2]
    c, d = img[1::2, 0::2], img[1::2, 1::2]
    return ((a + b) + (c + d)) * 0.25


def _up2(img):
    """Exact 2x bilinear upsample with half-pixel centers, edge clamped:
    per axis the two phases mix a texel with its neighbor at (0.75, 0.25)."""
    def axis_up(x):
        lo = torch.cat([x[:1], x[:-1]], 0)
        hi = torch.cat([x[1:], x[-1:]], 0)
        ph0 = 0.75 * x + 0.25 * lo
        ph1 = 0.75 * x + 0.25 * hi
        return torch.stack([ph0, ph1], 1).reshape((-1,) + x.shape[1:])

    return axis_up(axis_up(img).transpose(0, 1)).transpose(0, 1)


@functools.lru_cache(maxsize=64)
def _linear_weights(n_in, n_out, device):
    """jax.image.resize's "linear" weights [n_in, n_out] along one axis
    (jax/_src/image/scale.py compute_weight_mat, translation 0): a triangle
    kernel widened by the scale when downsampling (antialias), each column
    normalized, zero where the sample falls outside the input.  Cached per
    size pair: a bloom level reuses them for all 13 taps, every frame."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, **f32)[:, None]) / kernel_scale
    wts = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def resize_linear(img, h, w):
    """jax.image.resize(img, (h, w, C), "linear") for [H,W,C]: each axis whose
    size changes is contracted with its _linear_weights."""
    sh, sw = img.shape[:2]
    if sh != h:
        img = torch.einsum("hwc,hH->Hwc", img, _linear_weights(sh, h, img.device))
    if sw != w:
        img = torch.einsum("hwc,wW->hWc", img, _linear_weights(sw, w, img.device))
    return img


def _resize(img, h, w):
    """Bilinear resize: exact dense paths at the 2:1 ratios of the bloom
    chain, resize_linear otherwise."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    if sh == 2 * h and sw == 2 * w:
        return _box2(img)
    if h == 2 * sh and w == 2 * sw:
        return _up2(img)
    return resize_linear(img, h, w)


def _down_2to1(b00, sx_b00, sx_b11):
    """The 13 taps of an exact 2:1 level from the two box2 phase images:
    b00 the even-aligned one, sx_b00(dy, dx) / sx_b11(dy, dx) the two
    shifted (edge clamped) at half resolution."""
    out = 0.125 * b00
    for (dy, dx) in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        out = out + 0.03125 * sx_b00(dy, dx)
    for (dy, dx) in ((-1, 0), (0, -1), (1, 0), (0, 1)):
        out = out + 0.0625 * sx_b00(dy, dx)
    for (dy, dx) in ((-1, -1), (-1, 0), (0, -1), (0, 0)):
        out = out + 0.125 * sx_b11(dy, dx)
    return out


def downsample_13tap(src, dst_h, dst_w, firefly_clamp=False):
    """One bloom downsample level (bloom_downsample.glsl:38-99).  At exact
    2:1 every tap is a 2x2 source-block mean at an integer offset, so the
    filter decomposes into two box2 phase images plus half-res shifts."""
    sh, sw = src.shape[:2]
    if (sh, sw) == (2 * dst_h, 2 * dst_w):
        b00 = _box2(src)
        b11 = _box2(_shift_edge(src, 1, 1))
        out = _down_2to1(b00, lambda dy, dx: _shift_edge(b00, dy, dx),
                         lambda dy, dx: _shift_edge(b11, dy, dx))
    else:
        taps = [
            (0, 0, 0.125),
            (-2, -2, 0.03125), (2, -2, 0.03125), (-2, 2, 0.03125), (2, 2, 0.03125),
            (0, -2, 0.0625), (-2, 0, 0.0625), (2, 0, 0.0625), (0, 2, 0.0625),
            (-1, -1, 0.125), (1, -1, 0.125), (-1, 1, 0.125), (1, 1, 0.125),
        ]
        out = 0.0
        for (dx, dy, wgt) in taps:
            out = out + wgt * _resize(_shift_edge(src, dy, dx), dst_h, dst_w)
    if firefly_clamp:
        out = torch.clamp(out, max=1.0)
    return out


_TENT_TAPS = ((-3, 1.0), (0, 2.0), (3, 1.0))


def _tent9(up):
    """The 9 tent taps of an upsampled level, summed unscaled."""
    out = 0.0
    for dy, wy in _TENT_TAPS:
        for dx, wx in _TENT_TAPS:
            out = out + (wx * wy) * _shift_edge(up, dy, dx)
    return out


def upsample_tent9(src, dst_h, dst_w, factor=1.0):
    """One bloom upsample level (bloom_upsample.glsl:23-59): 9-tap tent of
    radius 1.5 src texels, scaled by `factor`."""
    return _tent9(_resize(src, dst_h, dst_w)) * (factor / 16.0)


# ---------------------------------------------------------------------------
# the levels: plain versions over a row window, and the kernels' dispatch


def chain_sizes(h, w, passes):
    """The sizes of a bloom chain of [h, w]: level i is max(1, h >> i) x
    max(1, w >> i), i = 0..passes."""
    return [(max(1, h >> i), max(1, w >> i)) for i in range(passes + 1)]


def new_atlas(h, w, passes, device):
    """(atlas, offsets): an unfilled bf16 pyramid atlas [h1, Wa, 3] for the
    chain of [h, w] (pack_mip_atlas's layout of levels 1..passes; their
    bands cover it, and bloom_down_level writes a band whole) and each
    level's column offset."""
    h1, w1 = chain_sizes(h, w, 1)[1]
    offs, wa = sampling.mip_offsets(h1, w1, passes)
    return torch.empty((h1, wa, 3), dtype=torch.bfloat16, device=device), offs


def _store_band(atlas, col, lv):
    """pack_mip_atlas(...).to(bfloat16)'s band of one level: its texels,
    then zeros below them."""
    lh, lw = lv.shape[:2]
    atlas[:lh, col:col + lw] = lv.to(torch.bfloat16)
    atlas[lh:, col:col + lw] = 0


def _down_rows_plain(src, dst_h, dst_w, firefly_clamp, rb, rc):
    """Rows [rb, rb + rc) of downsample_13tap.  At exact 2:1, from the two
    box2 phase images of an even-aligned source slab with one half-res halo
    row each side; the frame-boundary halo rows are fixed so that the
    half-res edge clamp matches the whole level's _shift_edge.  Otherwise,
    the whole level's rows."""
    h = src.shape[0]
    if tuple(src.shape[:2]) != (2 * dst_h, 2 * dst_w):
        return downsample_13tap(src, dst_h, dst_w, firefly_clamp)[rb:rb + rc]
    y0, rows = 2 * rb, 2 * rc
    slab = sampling.edge_rows(src, y0, rows, 2, 4)     # rows + 6, even-aligned
    b00 = _box2(slab)                                   # rc + 3 half rows
    b11 = _box2(_shift_edge(slab, 1, 1))
    if y0 == 0:
        b00[0] = b00[1]
        b11[0] = b11[1]
    if y0 + rows == h:
        b00[rc + 1] = b00[rc]

    def c(a, dy):   # the phase slab's centre rows, shifted dy in y
        return a[1 + dy:1 + dy + rc]

    out = _down_2to1(c(b00, 0), lambda dy, dx: _shift_edge(c(b00, dy), 0, dx),
                     lambda dy, dx: _shift_edge(c(b11, dy), 0, dx))
    if firefly_clamp:
        out = torch.clamp(out, max=1.0)
    return out


def bloom_down_level_plain(src, dst_h, dst_w, firefly_clamp=False, atlas=None, atlas_col=0,
                           rows=None, src_atlas_col=None):
    """bloom_down_level's function in PyTorch operations (its docstring)."""
    if rows is None:
        out = downsample_13tap(src, dst_h, dst_w, firefly_clamp)
    else:
        out = _down_rows_plain(src, dst_h, dst_w, firefly_clamp, *rows)
    if atlas is not None:
        _store_band(atlas, atlas_col, out)
        if src_atlas_col is not None:
            _store_band(atlas, src_atlas_col, src)
    return out


def _up_rows_plain(src, dst_h, dst_w, rb, rc):
    """Rows [rb, rb + rc) of upsample_tent9's unscaled tap sum.  At exactly
    2x with rb and rc even, from the 2x upsample of a half-res slab that
    covers rows [rb - 4, rb + rc + 4): its edge clamps equal the whole
    level's (up[0] == up1[0], up[-1] == up1[-1]).  Otherwise, the whole
    level's rows."""
    sh, sw = src.shape[:2]
    if (dst_h, dst_w) != (2 * sh, 2 * sw) or rb % 2 or rc % 2:
        return _tent9(_resize(src, dst_h, dst_w))[rb:rb + rc]
    up_slab = _up2(sampling.edge_rows(src, rb // 2, rc // 2, 2, 2))
    out = torch.zeros((rc, dst_w, src.shape[2]), dtype=src.dtype, device=src.device)
    for dy, wy in _TENT_TAPS:
        for dx, wx in _TENT_TAPS:
            out = out + (wx * wy) * _shift_edge(up_slab[4 + dy:4 + dy + rc], 0, dx)
    return out


def bloom_up_level_plain(src, dst_h, dst_w, factor=1.0, base=None, exposure=None, rows=None):
    """bloom_up_level's function in PyTorch operations (its docstring)."""
    if src is None:
        v = base
    else:
        if rows is None:
            v = _tent9(_resize(src, dst_h, dst_w))
        else:
            v = _up_rows_plain(src, dst_h, dst_w, *rows)
        v = v * (factor / 16.0)
        if base is not None:
            v = base + v
    if exposure is not None:
        v = colorlib.gamma_encode(colorlib.aces_approx(exposure * v))
    return v


def _check_rows(rows, n, fn):
    """(row_begin, row_count) of a window inside n rows; the whole n for None."""
    if rows is None:
        return 0, n
    rb, rc = (int(v) for v in rows)
    if rb < 0 or rc < 1 or rb + rc > n:
        raise ValueError(f"{fn}: rows ({rb}, {rc}) outside the level's {n} rows")
    return rb, rc


def _check_down(src, dst_h, dst_w, atlas, atlas_col, rows, src_atlas_col):
    fn = "bloom_down_level"
    if not torch.is_tensor(src) or src.dim() != 3 or src.shape[2] != 3:
        raise ValueError(f"{fn}: src must be an [H, W, 3] tensor")
    cuda_build.need(src, "src", fn, src.device)
    sh, sw = src.shape[:2]
    if not (1 <= dst_h <= sh and 1 <= dst_w <= sw):
        raise ValueError(f"{fn}: a level of {sh}x{sw} cannot go down to {dst_h}x{dst_w}")
    rb, rc = _check_rows(rows, dst_h, fn)
    if atlas is None:
        if src_atlas_col is not None:
            raise ValueError(f"{fn}: src_atlas_col needs an atlas")
        return rb, rc
    if rows is not None:
        raise ValueError(f"{fn}: the atlas band is written by a whole level only")
    if atlas.dim() != 3 or atlas.shape[2] != 3:
        raise ValueError(f"{fn}: atlas must be [h1, Wa, 3]")
    cuda_build.need(atlas, "atlas", fn, src.device, dtype=torch.bfloat16)
    bands = [(atlas_col, dst_h, dst_w)]
    if src_atlas_col is not None:
        bands.append((src_atlas_col, sh, sw))
    for col, lh, lw in bands:
        if col < 0 or col + lw > atlas.shape[1] or lh > atlas.shape[0]:
            raise ValueError(f"{fn}: a {lh}x{lw} band at column {col} does not fit the atlas "
                             f"{tuple(atlas.shape)}")
    return rb, rc


def bloom_down_level(src, dst_h, dst_w, firefly_clamp=False, atlas=None, atlas_col=0,
                     rows=None, src_atlas_col=None):
    """One bloom downsample level [dst_h, dst_w, 3] of src [H, W, 3]
    (downsample_13tap; firefly_clamp at level 1), or with rows = (row_begin,
    row_count) only those rows of it, from the whole src.  atlas: a bf16
    pyramid atlas (new_atlas) whose band at column atlas_col receives the
    level's texels and zeros below them (pack_mip_atlas(...).to(bfloat16)'s
    band; a whole level only); src_atlas_col: the source's band as well (the
    row-sharded frame's level 1, gathered).  The inputs are checked first
    (ValueError); then a CUDA tensor launches csrc/post.cu's
    bloom_down_kernel (or raises) and a CPU tensor takes
    bloom_down_level_plain.  `bloom_down_level.launches` counts launches."""
    rb, rc = _check_down(src, dst_h, dst_w, atlas, atlas_col, rows, src_atlas_col)
    if not src.is_cuda:
        return bloom_down_level_plain(src, dst_h, dst_w, firefly_clamp, atlas, atlas_col, rows,
                                      src_atlas_col)
    sh, sw = src.shape[:2]
    out = torch.empty((rc, dst_w, 3), dtype=torch.float32, device=src.device)
    exact2 = (sh, sw) == (2 * dst_h, 2 * dst_w)
    args = _DownArgs(
        src=src.data_ptr(), out=out.data_ptr(),
        rows_band=_band(sh, dst_h, src.device, not exact2),
        cols_band=_band(sw, dst_w, src.device, not exact2),
        atlas=atlas.data_ptr() if atlas is not None else None, sh=sh, sw=sw, dh=dst_h,
        dw=dst_w, row_begin=rb, row_count=rc, exact2=int(exact2), firefly=int(firefly_clamp),
        atlas_h=atlas.shape[0] if atlas is not None else 0,
        atlas_wa=atlas.shape[1] if atlas is not None else 0, atlas_col=atlas_col,
        src_atlas_col=-1 if src_atlas_col is None else src_atlas_col)
    _launch("bloom_down_launch", args, src.device)
    bloom_down_level.launches += 1
    return out


bloom_down_level.launches = 0


def bloom_up_level(src, dst_h, dst_w, factor=1.0, base=None, exposure=None, rows=None):
    """One bloom upsample level [dst_h, dst_w, 3] of src [h, w, 3]
    (upsample_tent9 with `factor`), or with rows = (row_begin, row_count)
    only those rows of it.  base [rows, dst_w, 3]: returns base + the level
    (the bloomed image); exposure: then the tonemap,
    gamma_encode(aces_approx(exposure * ...)), as post_stack's last step.
    src None: the tonemap of base alone (bloom off).  The inputs are checked
    first (ValueError); then a CUDA tensor launches csrc/post.cu's
    bloom_up_kernel (or raises) and a CPU tensor takes bloom_up_level_plain.
    `bloom_up_level.launches` counts launches."""
    fn = "bloom_up_level"
    lead = src if src is not None else base
    if not torch.is_tensor(lead):
        raise ValueError(f"{fn}: needs src or base")
    dev = lead.device
    rb, rc = _check_rows(rows, dst_h, fn)
    if src is not None:
        if src.dim() != 3 or src.shape[2] != 3:
            raise ValueError(f"{fn}: src must be an [h, w, 3] tensor")
        cuda_build.need(src, "src", fn, dev)
        if src.shape[0] > dst_h or src.shape[1] > dst_w:
            raise ValueError(f"{fn}: a level of {tuple(src.shape[:2])} cannot go up to "
                             f"{dst_h}x{dst_w}")
    if base is not None:
        cuda_build.need(base, "base", fn, dev, (rc, dst_w, 3))
    if dev.type != "cuda":
        return bloom_up_level_plain(src, dst_h, dst_w, factor, base, exposure, rows)
    out = torch.empty((rc, dst_w, 3), dtype=torch.float32, device=dev)
    sh, sw = src.shape[:2] if src is not None else (dst_h, dst_w)
    up2 = (dst_h, dst_w) == (2 * sh, 2 * sw)
    args = _UpArgs(
        src=src.data_ptr() if src is not None else None, out=out.data_ptr(),
        base=base.data_ptr() if base is not None else None,
        rows_band=_band(sh, dst_h, dev, not up2), cols_band=_band(sw, dst_w, dev, not up2),
        scale=factor / 16.0, exposure=exposure if exposure is not None else 1.0,
        gamma_exp=1.0 / 2.2, sh=sh, sw=sw, dh=dst_h, dw=dst_w, row_begin=rb, row_count=rc,
        up2=int(up2), tonemap=int(exposure is not None))
    _launch("bloom_up_launch", args, dev)
    bloom_up_level.launches += 1
    return out


bloom_up_level.launches = 0


def bloom_down_chain_plain(hdr, passes, atlas=None, offsets=None):
    """bloom_down_chain's function in PyTorch operations: bloom_down_level_plain
    level by level."""
    sizes = chain_sizes(hdr.shape[0], hdr.shape[1], passes)
    downs, cur = [], hdr
    for i in range(1, passes + 1):
        cur = bloom_down_level_plain(cur, *sizes[i], i == 1, atlas,
                                     offsets[i - 1] if atlas is not None else 0)
        downs.append(cur)
    return downs


def bloom_down_chain(hdr, passes, atlas=None, offsets=None):
    """[down1..downN]: the chain's downsample levels of hdr [H, W, 3] (level 1
    with the firefly clamp), each writing its band of `atlas` (new_atlas's
    atlas and offsets) when given.  The inputs are checked first
    (ValueError); then a CUDA tensor launches csrc/post.cu's
    bloom_down_chain_kernel once for the whole chain (or raises), the levels
    views of one buffer, and a CPU tensor takes bloom_down_chain_plain.
    `bloom_down_chain.launches` counts launches."""
    fn = "bloom_down_chain"
    if not torch.is_tensor(hdr) or hdr.dim() != 3 or hdr.shape[2] != 3:
        raise ValueError(f"{fn}: hdr must be an [H, W, 3] tensor")
    dev = hdr.device
    cuda_build.need(hdr, "hdr", fn, dev)
    bands = None
    if atlas is not None:
        cuda_build.need(atlas, "atlas", fn, dev, dtype=torch.bfloat16)
        if offsets is None:
            raise ValueError(f"{fn}: an atlas needs its offsets")
        bands = (tuple(atlas.shape), tuple(offsets))
    h, w = hdr.shape[:2]
    _check_chain(h, w, passes, bands)
    if not hdr.is_cuda:
        return bloom_down_chain_plain(hdr, passes, atlas, offsets)
    if passes == 0:
        return []
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = _chain_plan(h, w, passes, dev, bands, stream)
    buf = torch.empty(plan.floats, dtype=torch.float32, device=dev)
    with plan.lock:
        args = plan.args
        args.src, args.buf = hdr.data_ptr(), buf.data_ptr()
        args.atlas = atlas.data_ptr() if atlas is not None else None
        args.epoch = plan.next_epoch()
        err = _chain_launcher()(ctypes.byref(args), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"bloom_down_chain_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(_library(), err)})")
    bloom_down_chain.launches += 1
    return [buf.as_strided(*v) for v in plan.views]


bloom_down_chain.launches = 0


def chain_occupancy():
    """(registers a thread, resident blocks an SM, threads a block) of the
    built down-chain kernel on the current card."""
    return tuple(cuda_build.query_ints(_library(), "bloom_down_chain_occupancy", (
        "registers", "blocks_per_sm", "threads")).values())


def bloom_up_chain_plain(deepest, h, w, passes, strength, base, exposure=None, rows=None):
    """bloom_up_chain's function in PyTorch operations: bloom_up_level_plain
    level by level."""
    sizes = chain_sizes(h, w, passes)
    cur = deepest
    for i in range(passes - 1, 0, -1):
        cur = bloom_up_level_plain(cur, *sizes[i], 1.0)
    return bloom_up_level_plain(cur, h, w, strength, base, exposure, rows)


def bloom_up_chain(deepest, h, w, passes, strength, base, exposure=None, rows=None):
    """The up chain from deepest, the chain's level `passes` of [h, w], to
    [h, w]: upsample_tent9 level by level (factor 1), the last at
    `strength`, added to base [rows, w, 3] (the bloomed image); exposure:
    then the tonemap, gamma_encode(aces_approx(exposure * ...)); rows =
    (row_begin, row_count): only those rows of the last level (the
    row-sharded frame's).  The inputs are checked first (ValueError); then a
    CUDA tensor launches csrc/post.cu's bloom_up_chain_kernel once for the
    whole chain (or raises) and a CPU tensor takes bloom_up_chain_plain.
    `bloom_up_chain.launches` counts launches."""
    fn = "bloom_up_chain"
    if not torch.is_tensor(deepest) or deepest.dim() != 3 or deepest.shape[2] != 3:
        raise ValueError(f"{fn}: deepest must be an [h, w, 3] tensor")
    dev = deepest.device
    if not 1 <= passes <= MAX_CHAIN_LEVELS:
        raise ValueError(f"{fn}: passes must be in [1, {MAX_CHAIN_LEVELS}], got {passes}")
    cuda_build.need(deepest, "deepest", fn, dev, chain_sizes(h, w, passes)[passes] + (3,))
    rb, rc = _check_rows(rows, h, fn)
    cuda_build.need(base, "base", fn, dev, (rc, w, 3))
    if not deepest.is_cuda:
        return bloom_up_chain_plain(deepest, h, w, passes, strength, base, exposure, rows)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = _up_chain_plan(h, w, passes, dev, (rb, rc), stream)
    out = torch.empty((rc, w, 3), dtype=torch.float32, device=dev)
    buf = torch.empty(plan.floats, dtype=torch.float32, device=dev)
    with plan.lock:
        args = plan.args
        args.src, args.buf, args.out = deepest.data_ptr(), buf.data_ptr(), out.data_ptr()
        args.base = base.data_ptr()
        args.lv[passes - 1].scale = float(strength) / 16.0
        args.tonemap = int(exposure is not None)
        args.exposure = 1.0 if exposure is None else float(exposure)
        args.epoch = plan.next_epoch()
        err = _up_chain_launcher()(ctypes.byref(args), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"bloom_up_chain_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(_library(), err)})")
    bloom_up_chain.launches += 1
    return out


bloom_up_chain.launches = 0


class UpLevel(NamedTuple):
    """One level of bloom_up_chain's launch, in launch order (deepest
    first): its source and output sizes, whether it is exactly 2x (else
    resize_linear's weight bands), its offset in floats into the chain
    buffer (the last level writes the output instead) and the rows it
    computes."""
    src: tuple
    dst: tuple
    up2: bool
    out_off: int
    rows: tuple


def up_chain_levels(h, w, passes, rows=None):
    """([UpLevel] of the up chain of [h, w] in `passes` levels, the chain
    buffer's floats): every level but the last whole and on a 128-byte
    line of the buffer; the last the rows `rows` (all by default)."""
    sizes = chain_sizes(h, w, passes)
    rb, rc = _check_rows(rows, h, "bloom_up_chain")
    levels, off = [], 0
    for i in range(passes - 1, -1, -1):
        (sh, sw), (dh, dw) = sizes[i + 1], sizes[i]
        last = i == 0
        levels.append(UpLevel((sh, sw), (dh, dw), (dh, dw) == (2 * sh, 2 * sw),
                              0 if last else off, (rb, rc) if last else (0, dh)))
        if not last:
            off += -(-3 * dh * dw // 32) * 32
    return levels, off


def up_chain_occupancy():
    """The built up-chain kernel on the current card: {registers,
    local_bytes (a thread's local memory, where spills land), shared_bytes
    (a block's), blocks_per_sm (resident at once), threads, tile_w,
    tile_h}."""
    return cuda_build.query_ints(_library(), "bloom_up_chain_occupancy", (
        "registers", "local_bytes", "shared_bytes", "blocks_per_sm", "threads", "tile_w",
        "tile_h"))


def bloom_with_pyramid(hdr, passes=6, strength=0.06):
    """Bloom (render.cpp:1142-1178) + the downsample chain [down1..downN]:
    out = hdr + strength * tent(up chain); the up chain reads only the
    previous upsample.  The chain is next frame's prev-frame pyramid."""
    downs = bloom_down_chain(hdr, passes)
    return bloom_up_chain(downs[-1], hdr.shape[0], hdr.shape[1], passes, strength, hdr), downs


# ---------------------------------------------------------------------------
# csrc/post.cu's bloom launches


class _Band(ctypes.Structure):
    """struct Band of csrc/post.cu: one axis of resize_linear as weight
    bands, out[o] = sum_k wt[o, k] * in[first[o] + k]; first NULL: the axis
    keeps its size."""
    _fields_ = [("first", ctypes.c_void_p), ("wt", ctypes.c_void_p), ("k", ctypes.c_int)]


class _DownArgs(ctypes.Structure):
    """struct DownArgs of csrc/post.cu, field for field."""
    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_void_p), ("rows_band", _Band),
                ("cols_band", _Band), ("atlas", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("sh", "sw", "dh", "dw", "row_begin", "row_count", "exact2",
                                    "firefly", "atlas_h", "atlas_wa", "atlas_col",
                                    "src_atlas_col")]


class _UpArgs(ctypes.Structure):
    """struct UpArgs of csrc/post.cu, field for field."""
    _fields_ = [("src", ctypes.c_void_p), ("out", ctypes.c_void_p), ("base", ctypes.c_void_p),
                ("rows_band", _Band), ("cols_band", _Band)] + [
        (n, ctypes.c_float) for n in ("scale", "exposure", "gamma_exp")] + [
        (n, ctypes.c_int) for n in ("sh", "sw", "dh", "dw", "row_begin", "row_count", "up2",
                                    "tonemap")]


MAX_CHAIN_LEVELS = 16    # csrc/post.cu kMaxLevels


class _UpLevel(ctypes.Structure):
    """struct UpLevel of csrc/post.cu, field for field."""
    _fields_ = [("rows_band", _Band), ("cols_band", _Band)] + [
        (n, ctypes.c_int) for n in ("sh", "sw", "dh", "dw", "out_off", "up2", "row_begin",
                                    "row_count")] + [("scale", ctypes.c_float)]


class _UpChainArgs(ctypes.Structure):
    """struct UpChainArgs of csrc/post.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("src", "buf", "base", "out", "flags")] + [
        ("epoch", ctypes.c_uint), ("exposure", ctypes.c_float), ("gamma_exp", ctypes.c_float),
        ("passes", ctypes.c_int), ("tonemap", ctypes.c_int),
        ("lv", _UpLevel * MAX_CHAIN_LEVELS)]


class _ChainLevel(ctypes.Structure):
    """struct ChainLevel of csrc/post.cu, field for field."""
    _fields_ = [("rows_band", _Band), ("cols_band", _Band)] + [
        (n, ctypes.c_int) for n in ("sh", "sw", "dh", "dw", "out_off", "exact2", "firefly",
                                    "atlas_col")]


class _ChainArgs(ctypes.Structure):
    """struct ChainArgs of csrc/post.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("src", "buf", "atlas", "flags")] + [
        ("epoch", ctypes.c_uint)] + [
        (n, ctypes.c_int) for n in ("passes", "atlas_h", "atlas_wa")] + [
        ("lv", _ChainLevel * MAX_CHAIN_LEVELS)]


@functools.lru_cache(maxsize=64)
def _check_chain(h, w, passes, bands):
    """Raise ValueError unless a chain of `passes` levels of [h, w] fits
    csrc/post.cu and, bands = (atlas shape, offsets), its atlas; cached per
    shape."""
    fn = "bloom_down_chain"
    if not 0 <= passes <= MAX_CHAIN_LEVELS:
        raise ValueError(f"{fn}: passes must be in [0, {MAX_CHAIN_LEVELS}], got {passes}")
    if bands is None:
        return
    shape, offsets = bands
    if len(shape) != 3 or shape[2] != 3:
        raise ValueError(f"{fn}: atlas must be [h1, Wa, 3]")
    if len(offsets) < passes:
        raise ValueError(f"{fn}: {len(offsets)} offsets for {passes} levels")
    for (lh, lw), col in zip(chain_sizes(h, w, passes)[1:], offsets):
        if col < 0 or col + lw > shape[1] or lh > shape[0]:
            raise ValueError(f"{fn}: a {lh}x{lw} band at column {col} does not fit the atlas "
                             f"{shape}")


class _ChainPlan(cuda_build.Epochs):
    """What a chain launch of one shape keeps between frames: the launch's
    struct with every level filled in (the band tensors of odd levels and
    the units' flags, which it points into, held here), the chain buffer's
    size in floats, each level's view of it (shape, stride, offset) and the
    launches' epoch.  The struct's pointers to the input, the buffer and the
    atlas and its epoch are set per call, under the plan's lock; bands: as
    _check_chain's.  A plan serves one stream, which orders its launches:
    two launches in flight at once would share the flags."""

    def __init__(self, h, w, passes, device, bands):
        sizes = chain_sizes(h, w, passes)
        self.lock = threading.Lock()
        self.args = _ChainArgs(passes=passes)
        if bands is not None:
            self.args.atlas_h, self.args.atlas_wa = bands[0][:2]
        self.views, self.band_tensors, off = [], [], 0
        for i in range(1, passes + 1):
            (sh, sw), (dh, dw) = sizes[i - 1], sizes[i]
            exact2 = (sh, sw) == (2 * dh, 2 * dw)
            lv = self.args.lv[i - 1]
            lv.rows_band = _band(sh, dh, device, not exact2)
            lv.cols_band = _band(sw, dw, device, not exact2)
            self.band_tensors += [_band_tensors(n_in, n_out, device)
                                  for n_in, n_out in ((sh, dh), (sw, dw))
                                  if not exact2 and n_in != n_out]
            lv.sh, lv.sw, lv.dh, lv.dw, lv.out_off = sh, sw, dh, dw, off
            lv.exact2, lv.firefly = int(exact2), int(i == 1)
            lv.atlas_col = bands[1][i - 1] if bands is not None else 0
            self.views.append(((dh, dw, 3), (3 * dw, 3, 1), off))
            off += -(-3 * dh * dw // 32) * 32     # each level on a 128-byte line
        self.floats = off
        units = _library().bloom_down_chain_units(ctypes.byref(self.args))
        self.flags = torch.zeros(units, dtype=torch.int32, device=device)
        self.args.flags = self.flags.data_ptr()


@functools.lru_cache(maxsize=64)
def _band_tensors(n_in, n_out, device):
    """_linear_weights(n_in, n_out) on `device` as weight bands: (first
    [n_out] int32, wt [n_out, K] f32, K), each output's nonzero weights from
    its first input index, zero-padded to the widest band.  Built once per
    size pair (one host copy)."""
    wts = _linear_weights(n_in, n_out, device).cpu().numpy()     # [n_in, n_out]
    nz = wts != 0
    first = np.where(nz.any(0), nz.argmax(0), 0)
    last = np.where(nz.any(0), n_in - 1 - nz[::-1].argmax(0), 0)
    k = int(max(1, (last - first + 1).max()))
    band = np.zeros((n_out, k), np.float32)
    for o in range(n_out):
        n = last[o] - first[o] + 1
        band[o, :n] = wts[first[o]:first[o] + n, o]
    return (torch.from_numpy(first.astype(np.int32)).to(device),
            torch.from_numpy(band).to(device), k)


def _band(n_in, n_out, device, resize):
    """The _Band of one axis: none where the axis keeps its size or the
    kernel takes an exact path (resize False)."""
    if not resize or n_in == n_out:
        return _Band(None, None, 0)
    first, wt, k = _band_tensors(n_in, n_out, device)
    return _Band(first.data_ptr(), wt.data_ptr(), k)


@functools.lru_cache(maxsize=16)
def _chain_plan(h, w, passes, device, bands, stream):
    return _ChainPlan(h, w, passes, device, bands)


class _UpChainPlan(cuda_build.Epochs):
    """What an up-chain launch of one shape and row window keeps between
    frames: the launch's struct with every level filled in (the band
    tensors of resized levels and the units' flags, which it points into,
    held here), the chain buffer's size in floats and the launches' epoch.
    The struct's pointers to the input, the buffer, base and the output,
    the last level's scale (the strength), the tonemap's exposure and the
    epoch are set per call, under the plan's lock.  A plan serves one
    stream, as _ChainPlan's."""

    def __init__(self, h, w, passes, device, rows):
        levels, self.floats = up_chain_levels(h, w, passes, rows)
        self.lock = threading.Lock()
        self.args = _UpChainArgs(passes=passes, gamma_exp=1.0 / 2.2)
        self.band_tensors = []
        for k, lvl in enumerate(levels):
            (sh, sw), (dh, dw) = lvl.src, lvl.dst
            lv = self.args.lv[k]
            lv.rows_band = _band(sh, dh, device, not lvl.up2)
            lv.cols_band = _band(sw, dw, device, not lvl.up2)
            self.band_tensors += [_band_tensors(n_in, n_out, device)
                                  for n_in, n_out in ((sh, dh), (sw, dw))
                                  if not lvl.up2 and n_in != n_out]
            lv.sh, lv.sw, lv.dh, lv.dw, lv.out_off = sh, sw, dh, dw, lvl.out_off
            lv.up2 = int(lvl.up2)
            lv.row_begin, lv.row_count = lvl.rows
            lv.scale = 1.0 / 16.0
        units = _library().bloom_up_chain_units(ctypes.byref(self.args))
        self.flags = torch.zeros(units, dtype=torch.int32, device=device)
        self.args.flags = self.flags.data_ptr()


@functools.lru_cache(maxsize=16)
def _up_chain_plan(h, w, passes, device, rows, stream):
    return _UpChainPlan(h, w, passes, device, rows)


@functools.cache
def _chain_launcher():
    """csrc/post.cu's bloom_down_chain_launch(args, device, stream)."""
    fn = _library().bloom_down_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _up_chain_launcher():
    """csrc/post.cu's bloom_up_chain_launch(args, device, stream)."""
    fn = _library().bloom_up_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, args, device):
    lib = _library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")


def _library():
    """The built post library (csrc/post.cu)."""
    lib = cuda_build.load_library("post")
    for name in ("bloom_down_launch", "bloom_up_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("bloom_down_chain_units", "bloom_up_chain_units"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
