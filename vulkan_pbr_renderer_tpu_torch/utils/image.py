"""Image metrics + PNG IO (numpy copy of
vulkan_pbr_renderer_tpu/utils/image.py, which cannot be imported without
importing jax): SSIM/PSNR to score frames, a stdlib PNG writer/reader and a
JPEG encoder for the preview stream.  Runs on the host, not in the frame
loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def psnr(a, b, data_range=1.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    k /= k.sum()
    return k


def _filter2d_sep(img, k):
    """Separable 2D convolution with reflect padding over the first two axes."""
    pad = len(k) // 2
    img = np.pad(img, [(pad, pad), (pad, pad)] + [(0, 0)] * (img.ndim - 2), mode="reflect")
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 0, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, img)
    return img


def ssim(a, b, data_range=1.0):
    """Mean SSIM (Wang et al. 2004), gaussian 11x11 sigma 1.5, averaged over channels."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d_sep(a, k)
    mu_b = _filter2d_sep(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = _filter2d_sep(a * a, k) - mu_aa
    s_bb = _filter2d_sep(b * b, k) - mu_bb
    s_ab = _filter2d_sep(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


# ---------------------------------------------------------------------------
# Minimal PNG writer/reader (RGB8/RGBA8), zero external deps.


def encode_png(img, compress_level=6):
    """Encode a uint8 [H,W,3|4] (or float in [0,1]) array as PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(raw, compress_level))
    png += chunk(b"IEND", b"")
    return png


def encode_jpeg(img, quality=88):
    """Encode a uint8 [H,W,3] (or float in [0,1]) array as JPEG bytes.

    Returns (bytes, mime).  PIL-backed; PNG when PIL is absent.  Used by
    the live preview transport (app/preview.py), where libjpeg is much
    cheaper than the stdlib zlib PNG.  Goldens and --out files stay PNG
    (lossless)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    try:
        import io

        from PIL import Image as _PILImage
    except ImportError:
        return encode_png(img), "image/png"
    buf = io.BytesIO()
    _PILImage.fromarray(img[..., :3]).save(buf, "JPEG", quality=quality)
    return buf.getvalue(), "image/jpeg"


def write_png(path, img):
    """Write a uint8 [H,W,3|4] (or float in [0,1]) array as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path):
    """Read an 8-bit RGB/RGBA/gray PNG written by write_png (filters 0-4 supported)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
            assert bit_depth == 8 and interlace == 0, "only 8-bit non-interlaced"
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        ftype = raw[p]
        line = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).astype(np.int32)
        p += 1 + stride
        if ftype == 0:
            rec = line
        elif ftype == 2:  # up
            rec = (line + prev) & 0xFF
        else:  # sub/average/paeth need sequential per-pixel recon
            rec = np.zeros(stride, np.int32)
            for i in range(stride):
                a = rec[i - nch] if i >= nch else 0
                b = prev[i]
                cc = prev[i - nch] if i >= nch else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # paeth
                    pp = a + b - cc
                    pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                rec[i] = (line[i] + pred) & 0xFF
        out[y] = rec.astype(np.uint8)
        prev = rec
    return out.reshape(h, w, nch)
