"""DDS container + BC1/BC3/BC5 block decompression (vectorized numpy).

The reference keeps DDS data GPU-compressed (ddspp header parse, data uploaded
as BC blocks, asset_import.cpp:42-53).  The material atlas is built from
dense arrays, so we decode at load time.  A native C++ decoder
(native/bcdec.cpp) is used when it can be built — this numpy path is always
available and is the reference implementation for its tests.  Numpy copy of
vulkan_pbr_renderer_tpu/assets/dds.py.
"""

from __future__ import annotations

import struct

import numpy as np

_DDPF_FOURCC = 0x4


def _parse_header(data):
    assert data[:4] == b"DDS ", "not a DDS file"
    (size, flags, h, w, pitch, depth, mips) = struct.unpack_from("<7I", data, 4)
    pf_flags, fourcc = struct.unpack_from("<II", data, 80)
    rgb_bits = struct.unpack_from("<I", data, 88)[0]
    offset = 128
    fmt = None
    if pf_flags & _DDPF_FOURCC:
        name = data[84:88]
        if name == b"DX10":
            (dxgi, dim, misc, asize, misc2) = struct.unpack_from("<5I", data, 128)
            offset = 148
            fmt = {71: "BC1", 74: "BC2", 77: "BC3", 80: "BC4", 83: "BC5",
                   28: "RGBA8", 87: "BGRA8"}.get(dxgi)
        else:
            fmt = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3",
                   b"ATI1": "BC4", b"BC4U": "BC4", b"ATI2": "BC5",
                   b"BC5U": "BC5"}.get(name)
    elif rgb_bits == 32:
        fmt = "RGBA8"
    if fmt is None:
        raise ValueError("unsupported DDS format")
    return w, h, max(1, mips), fmt, offset


def _expand565(c):
    r = ((c >> 11) & 31).astype(np.float32) / 31.0
    g = ((c >> 5) & 63).astype(np.float32) / 63.0
    b = (c & 31).astype(np.float32) / 31.0
    return np.stack([r, g, b], -1)


def decode_bc1(raw, w, h, force_four_color=False):
    """BC1: [n_blocks * 8 bytes] -> [H,W,4] float; 1-bit alpha supported.

    force_four_color: BC3's color block is always decoded in 4-color mode —
    the c0<=c1 comparison is ignored per the BC3 spec."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(raw, np.uint8, bw * bh * 8).reshape(-1, 8)
    c0 = blocks[:, 0].astype(np.uint32) | (blocks[:, 1].astype(np.uint32) << 8)
    c1 = blocks[:, 2].astype(np.uint32) | (blocks[:, 3].astype(np.uint32) << 8)
    bits = (
        blocks[:, 4].astype(np.uint32)
        | (blocks[:, 5].astype(np.uint32) << 8)
        | (blocks[:, 6].astype(np.uint32) << 16)
        | (blocks[:, 7].astype(np.uint32) << 24)
    )
    p0 = _expand565(c0)
    p1 = _expand565(c1)
    opaque = (c0 > c1) | force_four_color
    # palette [n, 4, 3]
    p2 = np.where(opaque[:, None], (2 * p0 + p1) / 3, (p0 + p1) / 2)
    p3 = np.where(opaque[:, None], (p0 + 2 * p1) / 3, 0.0)
    pal = np.stack([p0, p1, p2, p3], 1)
    a3 = np.where(opaque, 1.0, 0.0)
    pal_a = np.stack(
        [np.ones_like(a3), np.ones_like(a3), np.ones_like(a3), a3], 1
    )
    sel = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32)[None, :])) & 3  # [n,16]
    rgb = np.take_along_axis(pal, sel[..., None].astype(np.int64), 1)
    a = np.take_along_axis(pal_a, sel.astype(np.int64), 1)
    out = np.concatenate([rgb, a[..., None]], -1).reshape(bh, bw, 4, 4, 4)
    out = out.transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    return out[:h, :w]


def _decode_bc4_channel(blocks8):
    """blocks8 [n, 8] uint8 -> [n, 16] float channel values."""
    a0 = blocks8[:, 0].astype(np.float32)
    a1 = blocks8[:, 1].astype(np.float32)
    bits = np.zeros(blocks8.shape[0], np.uint64)
    for i in range(6):
        bits |= blocks8[:, 2 + i].astype(np.uint64) << (8 * i)
    sel = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64)[None, :])) & 7  # [n,16]
    sel = sel.astype(np.int64)
    interp = np.zeros(blocks8.shape[:1] + (8,), np.float32)
    interp[:, 0] = a0
    interp[:, 1] = a1
    big = a0 > a1
    for i in range(2, 8):
        with_big = (a0 * (7 - (i - 1)) + a1 * (i - 1)) / 7.0
        j = i - 1
        with_small = np.where(
            i < 6, (a0 * (5 - j) + a1 * j) / 5.0, np.where(i == 6, 0.0, 255.0)
        )
        interp[:, i] = np.where(big, with_big, with_small)
    return np.take_along_axis(interp, sel, 1) / 255.0


def decode_bc3(raw, w, h):
    """BC3 (DXT5): BC4 alpha block + BC1 color block."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(raw, np.uint8, bw * bh * 16).reshape(-1, 16)
    alpha = _decode_bc4_channel(blocks[:, :8])
    rgb = decode_bc1(np.ascontiguousarray(blocks[:, 8:]).tobytes(), w, h,
                     force_four_color=True)[..., :3]
    a = alpha.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)[:h, :w]
    return np.concatenate([rgb, a[..., None]], -1)


def decode_bc5(raw, w, h):
    """BC5: two BC4 channels (RG) — tangent-space normal xy."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(raw, np.uint8, bw * bh * 16).reshape(-1, 16)
    r = _decode_bc4_channel(blocks[:, :8])
    g = _decode_bc4_channel(blocks[:, 8:])
    def unblk(c):
        return c.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)[:h, :w]
    return np.stack([unblk(r), unblk(g)], -1)


def decode_bc4(raw, w, h):
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(raw, np.uint8, bw * bh * 8).reshape(-1, 8)
    r = _decode_bc4_channel(blocks)
    return r.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)[:h, :w, None]


def read_dds(path, try_native=True):
    """Returns float32 [H,W,C] in [0,1] (mip 0 only)."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, mips, fmt, offset = _parse_header(data)
    raw = data[offset:]
    if try_native and fmt in ("BC1", "BC3", "BC5"):
        try:
            from . import native_bcdec

            out = native_bcdec.decode(fmt, raw, w, h)
            if out is not None:
                return out
        except ImportError:
            pass
    if fmt == "BC1":
        return decode_bc1(raw, w, h)
    if fmt == "BC3":
        return decode_bc3(raw, w, h)
    if fmt == "BC5":
        return decode_bc5(raw, w, h)
    if fmt == "BC4":
        return decode_bc4(raw, w, h)
    if fmt in ("RGBA8", "BGRA8"):
        img = np.frombuffer(raw, np.uint8, w * h * 4).reshape(h, w, 4).astype(np.float32) / 255.0
        if fmt == "BGRA8":
            img = img[..., [2, 1, 0, 3]]
        return img
    raise ValueError(f"unhandled format {fmt}")
