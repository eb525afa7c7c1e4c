"""Physically-based bloom (counterpart of vulkan_pbr_renderer_tpu/shade/bloom.py;
bloom_downsample.glsl / bloom_upsample.glsl).

6 downsamples of the 13-tap Jimenez/CoD filter (firefly clamp at mip 1),
then 6 additive 9-tap tent upsamples, the last scaled by the bloom strength.
Each tap at uv + k*texel is a resize of an edge-clamped integer shift of the
source, exact at the 2:1 ratios of a power-of-two chain; a chain that meets
an odd size (1080 rows: 135 -> 67) takes jax.image.resize's linear filter,
`resize_linear`, as the reference package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _shift_edge(img, dy, dx):
    """img[y+dy, x+dx] with edge clamping, [H,W,C]."""
    h, w = img.shape[:2]
    iy = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, iy).index_select(1, ix)


def _box2(img):
    """Exact 2x2 box mean (even dims)."""
    h, w, c = img.shape
    return img.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


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


def downsample_13tap(src, dst_h, dst_w, firefly_clamp=False):
    """One bloom downsample level (bloom_downsample.glsl:38-99).  At exact
    2:1 every tap is a 2x2 source-block mean at an integer offset, so the
    filter decomposes into two box2 phase images plus half-res shifts."""
    sh, sw = src.shape[:2]
    if (sh, sw) == (2 * dst_h, 2 * dst_w):
        b00 = _box2(src)
        b11 = _box2(_shift_edge(src, 1, 1))
        out = 0.125 * b00
        for (dy, dx) in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            out = out + 0.03125 * _shift_edge(b00, dy, dx)
        for (dy, dx) in ((-1, 0), (0, -1), (1, 0), (0, 1)):
            out = out + 0.0625 * _shift_edge(b00, dy, dx)
        for (dy, dx) in ((-1, -1), (-1, 0), (0, -1), (0, 0)):
            out = out + 0.125 * _shift_edge(b11, dy, dx)
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


def upsample_tent9(src, dst_h, dst_w, factor=1.0):
    """One bloom upsample level (bloom_upsample.glsl:23-59): 9-tap tent of
    radius 1.5 src texels, scaled by `factor`."""
    up = _resize(src, dst_h, dst_w)
    out = 0.0
    for dy, wy in ((-3, 1.0), (0, 2.0), (3, 1.0)):
        for dx, wx in ((-3, 1.0), (0, 2.0), (3, 1.0)):
            out = out + (wx * wy) * _shift_edge(up, dy, dx)
    return out * (factor / 16.0)


def bloom_with_pyramid(hdr, passes=6, strength=0.06):
    """Bloom (render.cpp:1142-1178) + the downsample chain [down1..downN]:
    out = hdr + strength * tent(up chain); the up chain reads only the
    previous upsample.  The chain is next frame's prev-frame pyramid."""
    h, w = hdr.shape[:2]
    sizes = [(max(1, h >> i), max(1, w >> i)) for i in range(passes + 1)]
    downs = []
    cur = hdr
    for i in range(1, passes + 1):
        cur = downsample_13tap(cur, *sizes[i], firefly_clamp=(i == 1))
        downs.append(cur)
    for i in range(passes - 1, 0, -1):
        cur = upsample_tent9(cur, *sizes[i], factor=1.0)
    tent = upsample_tent9(cur, *sizes[0], factor=strength)
    return hdr + tent, downs
