"""TGA image loader (uncompressed + RLE, 24/32-bit and 8-bit gray).

Covers the MetalRoughSpheres_*.tga reference textures (resources/, loaded in
the reference through assimp/stb paths).

Numpy copy of vulkan_pbr_renderer_tpu/assets/tga.py, which cannot be imported
without importing jax.
"""

from __future__ import annotations

import struct

import numpy as np


def read_tga(path):
    """Returns float32 [H,W,C] in [0,1], top-left origin."""
    with open(path, "rb") as f:
        data = f.read()
    (
        id_len, cmap_type, img_type,
        _cm_first, _cm_len, _cm_size,
        _x0, _y0, w, h, bpp, desc,
    ) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    assert cmap_type == 0, "color-mapped TGA unsupported"
    pos = 18 + id_len
    nch = bpp // 8
    npx = w * h

    if img_type in (2, 3):  # uncompressed BGR(A) / gray
        raw = np.frombuffer(data, np.uint8, npx * nch, pos).reshape(npx, nch)
    elif img_type in (10, 11):  # RLE
        out = np.empty((npx, nch), np.uint8)
        i = 0
        buf = memoryview(data)
        while i < npx:
            hdr = buf[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:
                px = np.frombuffer(buf, np.uint8, nch, pos)
                pos += nch
                out[i : i + count] = px
            else:
                out[i : i + count] = np.frombuffer(
                    buf, np.uint8, count * nch, pos
                ).reshape(count, nch)
                pos += count * nch
            i += count
        raw = out
    else:
        raise ValueError(f"unsupported TGA type {img_type}")

    img = raw.reshape(h, w, nch).astype(np.float32) / 255.0
    if nch >= 3:
        img = img[..., [2, 1, 0] + ([3] if nch == 4 else [])]  # BGR(A)->RGB(A)
    if not (desc & 0x20):  # origin bottom-left -> flip to top-left
        img = img[::-1]
    return np.ascontiguousarray(img)
