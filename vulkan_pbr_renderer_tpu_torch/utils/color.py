"""Tonemapping helpers (counterpart of utils/color.py,
final_post_process.glsl:1-36) and the GI tone compressor."""

from __future__ import annotations

import torch

from . import math3d as m3


def aces_approx(v):
    """ACES filmic approximation incl. the 0.6 pre-scale; clamps to [0,1]."""
    v = v * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v * (a * v + b)) / (v * (c * v + d) + e), 0.0, 1.0)


def gamma_encode(v):
    """pow(1/2.2) gamma encode (final_post_process.glsl:33)."""
    return torch.pow(torch.clamp(v, min=0.0), 1.0 / 2.2)



def luminance_rec601(v):
    """0.299/0.587/0.114 luma of the GI tone compressor (lighting_pass.glsl:268)."""
    return 0.299 * v[..., 0] + 0.587 * v[..., 1] + 0.114 * v[..., 2]


def tone_compress_sqrt(rgb_mean):
    """Luminance-sqrt compression of GI radiance (lighting_pass.glsl:267-270)."""
    lum = luminance_rec601(rgb_mean)[..., None]
    return rgb_mean * m3.sqrt(torch.clamp(lum, min=0.0)) / torch.clamp(lum, min=1e-4)
