"""The port's utils/image.py against the JAX package's copy.

Both are numpy f64 on the host, so SSIM and PSNR agree to 1e-12 and the PNG
bytes are identical; PNG round trips are exact.
"""

from pathlib import Path

import numpy as np
import pytest

from vulkan_pbr_renderer_tpu.utils import image as jimage
from vulkan_pbr_renderer_tpu_torch.utils import image as timage

GOLDENS = sorted((Path(__file__).parent / "goldens").glob("*.png"))
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(40, 56), (40, 56, 3)], ids=["gray", "rgb"])
def test_ssim_psnr_match_jax(shape):
    a, b = _pair(shape, 0)
    assert abs(timage.ssim(a, b) - jimage.ssim(a, b)) <= 1e-12
    assert abs(timage.psnr(a, b) - jimage.psnr(a, b)) <= 1e-12
    assert timage.ssim(a, a) == pytest.approx(1.0)
    assert timage.psnr(a, a) == float("inf")
    assert timage.ssim(a, b) < 1.0


@pytest.mark.parametrize("channels", [0, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_encode_png_bytes_match_jax(channels, dtype):
    rng = np.random.default_rng(1)
    shape = (17, 23) + ((channels,) if channels else ())
    img = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    if dtype == "u8":
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    got = timage.encode_png(img)
    assert got[:8] == PNG_MAGIC
    assert got == jimage.encode_png(img)


@pytest.mark.parametrize("channels", [0, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_roundtrip_exact(tmp_path, channels):
    rng = np.random.default_rng(2)
    shape = (19, 31) + ((channels,) if channels else ())
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "img.png"
    timage.write_png(path, img)
    back = timage.read_png(path)
    # a gray image is written as RGB with equal channels
    want = np.repeat(img[..., None], 3, -1) if channels == 0 else img
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(back, jimage.read_png(path))
    # the float path quantizes with +0.5 rounding, as the JAX copy does
    timage.write_png(path, want.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(timage.read_png(path), want)


def test_read_png_filters_match_jax(tmp_path):
    """Filter types 1-4 (sub, up, average, paeth), which write_png never
    emits: a hand-filtered file decodes as in the JAX reader."""
    import struct
    import zlib

    rng = np.random.default_rng(3)
    h, w = 5, 6
    img = rng.integers(0, 256, (h, w, 3)).astype(np.int32)
    flat = img.reshape(h, w * 3)
    rows = []
    for y in range(h):
        ftype = y % 5
        prev = flat[y - 1] if y else np.zeros(w * 3, np.int32)
        line = np.zeros(w * 3, np.int32)
        for i in range(w * 3):
            a = flat[y, i - 3] if i >= 3 else 0
            b = prev[i]
            c = prev[i - 3] if i >= 3 else 0
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            paeth = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftype]
            line[i] = (flat[y, i] - pred) & 0xFF
        rows.append(bytes([ftype]) + line.astype(np.uint8).tobytes())

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    path = tmp_path / "filtered.png"
    path.write_bytes(png)
    got = timage.read_png(path)
    np.testing.assert_array_equal(got, img.astype(np.uint8))
    np.testing.assert_array_equal(got, jimage.read_png(path))


@pytest.mark.parametrize("path", GOLDENS, ids=[p.stem for p in GOLDENS])
def test_read_png_goldens_match_jax(path):
    got = timage.read_png(path)
    assert got.dtype == np.uint8 and got.ndim == 3
    np.testing.assert_array_equal(got, jimage.read_png(path))


@pytest.mark.parametrize("dtype", ["u8", "f32", "gray"])
def test_encode_jpeg_magic_and_mime(dtype):
    """JPEG (SOI marker) when PIL is present, PNG otherwise; the mime says
    which, and both copies agree."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    if dtype == "u8":
        img = (img * 255).astype(np.uint8)
    if dtype == "gray":
        img = img[..., 0]
    data, mime = timage.encode_jpeg(img)
    assert mime in ("image/jpeg", "image/png")
    if mime == "image/jpeg":
        assert data[:2] == b"\xff\xd8"
    else:
        assert data[:8] == PNG_MAGIC
    jdata, jmime = jimage.encode_jpeg(img)
    assert (data, mime) == (jdata, jmime)
