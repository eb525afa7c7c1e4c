"""Radiance .hdr (RGBE) loader.

Replaces stb_image's float path used by MakeTextureFromHDRIFile
(asset_import.cpp:17-27): the reference expects a **vertically stacked
6-face cubemap** (asserts height == 6*width, asset_import.cpp:21).

Numpy copy of vulkan_pbr_renderer_tpu/assets/hdr.py, which cannot be imported
without importing jax.
"""

from __future__ import annotations

import numpy as np


def read_hdr(path):
    """Returns float32 [H,W,3] linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    pos = eol + 1
    assert dims[0] == b"-Y" and dims[2] == b"+X", "unsupported HDR orientation"
    h, w = int(dims[1]), int(dims[3])

    img = np.zeros((h, w, 4), np.uint8)
    buf = memoryview(data)
    for y in range(h):
        if w >= 8 and buf[pos] == 2 and buf[pos + 1] == 2:
            # adaptive RLE scanline
            pos += 4
            row = np.zeros((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    n = buf[pos]
                    pos += 1
                    if n > 128:
                        row[c, x : x + n - 128] = buf[pos]
                        pos += 1
                        x += n - 128
                    else:
                        row[c, x : x + n] = np.frombuffer(buf, np.uint8, n, pos)
                        pos += n
                        x += n
            img[y] = row.T
        else:  # flat RGBE
            img[y] = np.frombuffer(buf, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    rgbe = img.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return rgbe[..., :3] * scale[..., None]


def read_hdr_cubemap(path):
    """Vertically-stacked 6-face cube (y == 6x) -> [6,S,S,3] in Vulkan face
    order, mirroring MakeTextureFromHDRIFile (asset_import.cpp:17-27)."""
    img = read_hdr(path)
    h, w = img.shape[:2]
    assert h == 6 * w, "expected vertically stacked 6-face cubemap"
    return img.reshape(6, w, w, 3)
