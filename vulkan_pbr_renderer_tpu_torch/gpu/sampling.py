"""Texture sampling (counterpart of vulkan_pbr_renderer_tpu/gpu/sampling.py),
the samplers the ported frame calls.

Conventions match the reference package: 2D textures are [H,W,C] with texel
centers at (i+0.5)/N and v=0 the top row; cubemaps are [6,S,S,C] in Vulkan
face order with the Vulkan face-UV mapping; mip chains live in one "mip
atlas" [H, Wa, C] with level k at rows [0, H>>k) and a static column offset.

The window packs (each texel row holding its whole filter window) are kept
from the reference package because they fix WHICH texels a filter reads and
how they are quantized; the quantized values are part of the image and are
kept: u16 shadow depth, f16 environment atlas, u8 materials.  The reference
package's int32 bitcast views of 16-bit tables were a TPU gather-rate trick
and are not carried over.  u16 tables are stored as torch.int16 holding the
u16 bit pattern (int16 has full operator support on every device);
`dequant_u16` decodes them.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# gathers and address modes


def take_rows(flat, idx):
    """Rows of flat [N, C] at integer idx [...] -> [..., C]."""
    return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + flat.shape[1:])


def _wrap_coord(i, n, mode):
    if mode == "clamp":
        return torch.clamp(i, 0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    raise ValueError(f"unknown address mode {mode!r}")


def _gather2d(tex, iy, ix):
    """tex [H,W,C] gathered at int iy/ix [...] -> [...,C]."""
    h, w, c = tex.shape
    return take_rows(tex.reshape(h * w, c), iy * w + ix)


def _floor_i32(x):
    return torch.floor(x).to(torch.int32)


# ---------------------------------------------------------------------------
# 16-bit depth quantization


def quantize_u16(depth):
    """[0,1] depth -> u16 levels round(d*65535), stored as the int16 bit
    pattern."""
    q = torch.clamp(torch.round(depth * 65535.0), 0.0, 65535.0).to(torch.int32)
    return torch.where(q > 32767, q - 65536, q).to(torch.int16)


def dequant_u16(rows):
    """int16 bit patterns of u16 levels -> f32 in [0,1] (level * (1/65535))."""
    return (rows.to(torch.int32) & 0xFFFF).to(torch.float32) * (1.0 / 65535.0)


# ---------------------------------------------------------------------------
# 2D sampling


def sample_bilinear(tex, uv, mode="clamp"):
    """Bilinear 2D sample. tex [H,W,C], uv [...,2] -> [...,C]."""
    h, w, _ = tex.shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    x0c, x1c = _wrap_coord(x0, w, mode), _wrap_coord(x0 + 1, w, mode)
    y0c, y1c = _wrap_coord(y0, h, mode), _wrap_coord(y0 + 1, h, mode)
    t00 = _gather2d(tex, y0c, x0c)
    t10 = _gather2d(tex, y0c, x1c)
    t01 = _gather2d(tex, y1c, x0c)
    t11 = _gather2d(tex, y1c, x1c)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def _clamp_index(x0f, n):
    """Integer texel index of a floored coordinate, clamped to [0, n-1]; the
    clamp runs on the float first so out-of-range values saturate."""
    return torch.clamp(torch.clamp(x0f, 0.0, n - 1.0).to(torch.int32), 0, n - 1)


def sample_nearest(tex2d, uv):
    """Nearest sample of a single-channel [H,W] texture, clamp addressing
    (the values of the reference package's sample_nearest8: a -0.0 texel
    comes back as +0.0)."""
    h, w = tex2d.shape
    ix = _clamp_index(torch.floor(uv[..., 0] * w), w)
    iy = _clamp_index(torch.floor(uv[..., 1] * h), h)
    return tex2d.reshape(-1)[(iy * w + ix).to(torch.int64)] + 0.0


# ---------------------------------------------------------------------------
# 3D sampling (the lightgrid)


def sample_trilinear_3d(vol, uvw):
    """Trilinear 3D sample, clamp addressing. vol [D,H,W,C], uvw [...,3]
    (x,y,z) -> [...,C]."""
    d, h, w, c = vol.shape
    flat = vol.reshape(d * h * w, c)
    x = uvw[..., 0] * w - 0.5
    y = uvw[..., 1] * h - 0.5
    z = uvw[..., 2] * d - 0.5
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = (x - x0f)[..., None], (y - y0f)[..., None], (z - z0f)[..., None]
    x0, y0, z0 = x0f.to(torch.int32), y0f.to(torch.int32), z0f.to(torch.int32)

    def g(dz, dy, dx):
        iz = torch.clamp(z0 + dz, 0, d - 1)
        iy = torch.clamp(y0 + dy, 0, h - 1)
        ix = torch.clamp(x0 + dx, 0, w - 1)
        return take_rows(flat, (iz * h + iy) * w + ix)

    c00 = g(0, 0, 0) + (g(0, 0, 1) - g(0, 0, 0)) * fx
    c10 = g(0, 1, 0) + (g(0, 1, 1) - g(0, 1, 0)) * fx
    c01 = g(1, 0, 0) + (g(1, 0, 1) - g(1, 0, 0)) * fx
    c11 = g(1, 1, 0) + (g(1, 1, 1) - g(1, 1, 0)) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def window_pack3d(vol, dtype=None):
    """[D,H,W,C] -> [D,H,W,8C]; row (z,y,x) holds the edge-clamped 2x2x2
    corner block, channel layout (dz*4+dy*2+dx)*C + c."""
    d, h, w = vol.shape[:3]
    if dtype is not None:
        vol = vol.to(dtype)
    dev = vol.device
    p = (vol.index_select(0, _pad_index(d, 1, "edge", dev))
         .index_select(1, _pad_index(h, 1, "edge", dev))
         .index_select(2, _pad_index(w, 1, "edge", dev)))
    return torch.cat([p[dz:dz + d, dy:dy + h, dx:dx + w]
                      for dz in range(2) for dy in range(2) for dx in range(2)], dim=-1)


def _window_corner(uvw, d, h, w):
    """(ix, iy, iz, fx, fy, fz) of a window-pack trilinear fetch: the
    clamped lower corner and the fractionals [..., 1]."""
    x = uvw[..., 0] * w - 0.5
    y = uvw[..., 1] * h - 0.5
    z = uvw[..., 2] * d - 0.5
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    # below 0 the fractional also clamps, so the edge texel repeats
    fx = torch.where(x0f < 0, 0.0, torch.clamp(x - x0f, 0.0, 1.0))[..., None]
    fy = torch.where(y0f < 0, 0.0, torch.clamp(y - y0f, 0.0, 1.0))[..., None]
    fz = torch.where(z0f < 0, 0.0, torch.clamp(z - z0f, 0.0, 1.0))[..., None]
    ix, iy, iz = _clamp_index(x0f, w), _clamp_index(y0f, h), _clamp_index(z0f, d)
    return ix, iy, iz, fx, fy, fz


def sample_trilinear_window(wvol, uvw, channels, decode=None):
    """Trilinear sample from a window_pack3d volume — one gathered row.
    decode: optional per-corner [...,C] -> [...,C] transform applied BEFORE
    the lerp (quantized packs interpolate in the decoded space)."""
    d, h, w, c8 = wvol.shape
    ix, iy, iz, fx, fy, fz = _window_corner(uvw, d, h, w)
    row = take_rows(wvol.reshape(d * h * w, c8), (iz * h + iy) * w + ix).to(torch.float32)
    corners = row.reshape(row.shape[:-1] + (8, channels))
    return _trilerp_corners(corners, decode, fx, fy, fz)


def sample_trilinear_table(vol, uvw, decode=None, channels=None):
    """The fetch of sample_trilinear_window(window_pack3d(vol), uvw, C,
    decode) read from the unpacked [D,H,W,C] table: the 8 corners gathered
    with the pack's edge clamp, so the values are the same bit for bit.
    channels: optional list of the channels to return."""
    d, h, w, c = vol.shape
    ix, iy, iz, fx, fy, fz = _window_corner(uvw, d, h, w)
    ixs = (ix, torch.clamp(ix + 1, max=w - 1))
    iys = (iy, torch.clamp(iy + 1, max=h - 1))
    izs = (iz, torch.clamp(iz + 1, max=d - 1))
    idx = torch.stack([(izs[dz] * h + iys[dy]) * w + ixs[dx]
                       for dz in range(2) for dy in range(2) for dx in range(2)], -1)
    corners = take_rows(vol.reshape(d * h * w, c), idx).to(torch.float32)
    if channels is not None:
        corners = corners[..., channels]
    return _trilerp_corners(corners, decode, fx, fy, fz)


def _trilerp_corners(corners, decode, fx, fy, fz):
    """Lerp the [..., 8, C] corners (layout dz*4+dy*2+dx) along x, y, then
    z, after the optional per-corner decode."""
    if decode is not None:
        corners = decode(corners)
    k = [corners[..., i, :] for i in range(8)]
    c00 = k[0] + (k[1] - k[0]) * fx
    c10 = k[2] + (k[3] - k[2]) * fx
    c01 = k[4] + (k[5] - k[4]) * fx
    c11 = k[6] + (k[7] - k[6]) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def edge_rows(full, y0, rows, top, bottom):
    """Rows [y0 - top, y0 + rows + bottom) of `full`, edge-clamped: a row
    window of a frame with its halo rows."""
    idx = torch.arange(y0 - top, y0 + rows + bottom, device=full.device)
    return full.index_select(0, idx.clamp(0, full.shape[0] - 1))


# ---------------------------------------------------------------------------
# window packs: each texel row holds its wy x wx filter window


def _pad_index(n, extra, mode, device):
    i = torch.arange(n + extra, device=device)
    return torch.clamp(i, max=n - 1) if mode == "edge" else torch.remainder(i, n)


def window_pack(tex, wy, wx, pad_mode="edge", dtype=None):
    """[..., H, W, C] -> [..., H, W, wy*wx*C]; row (y,x) holds
    tex[y:y+wy, x:x+wx], channel layout (dy*wx+dx)*C + c.  pad_mode 'edge' =
    clamp addressing, 'wrap' = repeat addressing.  dtype: storage dtype."""
    h, w = tex.shape[-3], tex.shape[-2]
    if dtype is not None:
        tex = tex.to(dtype)
    iy = _pad_index(h, wy - 1, pad_mode, tex.device)
    ix = _pad_index(w, wx - 1, pad_mode, tex.device)
    p = tex.index_select(-3, iy).index_select(-2, ix)
    return torch.cat(
        [p[..., dy:dy + h, dx:dx + w, :] for dy in range(wy) for dx in range(wx)],
        dim=-1,
    )


def _bilerp_row(row, c, fx, fy):
    """Bilinear combine of a gathered 2x2 window row (4*c channels)."""
    t00 = row[..., 0 * c:1 * c]
    t10 = row[..., 1 * c:2 * c]
    t01 = row[..., 2 * c:3 * c]
    t11 = row[..., 3 * c:4 * c]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def sample_bilinear_window(wtex, base_h, base_w, uv, channels, mode="clamp"):
    """Bilinear sample from a 2x2 window_pack — one gathered row."""
    x = uv[..., 0] * base_w - 0.5
    y = uv[..., 1] * base_h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    if mode == "wrap":
        ix = torch.remainder(x0f.to(torch.int32), base_w)
        iy = torch.remainder(y0f.to(torch.int32), base_h)
    else:
        ix = torch.clamp(x0f.to(torch.int32), 0, base_w - 1)
        iy = torch.clamp(y0f.to(torch.int32), 0, base_h - 1)
        fx = torch.where((x0f < 0)[..., None], 0.0, fx)
        fy = torch.where((y0f < 0)[..., None], 0.0, fy)
    row = take_rows(wtex.reshape(base_h * base_w, -1), iy * base_w + ix)
    return _bilerp_row(row.to(torch.float32), channels, fx, fy)


def sample_bilinear_table(tex, uv):
    """sample_bilinear_window(window_pack(tex, 2, 2), H, W, uv, C) read from
    the unpacked [H,W,C] table: the 4 texels gathered with the pack's edge
    clamp, so the values are the same bit for bit (the f16 BRDF LUT)."""
    base_h, base_w, c = tex.shape
    x = uv[..., 0] * base_w - 0.5
    y = uv[..., 1] * base_h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = torch.where((x0f < 0)[..., None], 0.0, (x - x0f)[..., None])
    fy = torch.where((y0f < 0)[..., None], 0.0, (y - y0f)[..., None])
    ix = torch.clamp(x0f.to(torch.int32), 0, base_w - 1)
    iy = torch.clamp(y0f.to(torch.int32), 0, base_h - 1)
    ix1, iy1 = torch.clamp(ix + 1, max=base_w - 1), torch.clamp(iy + 1, max=base_h - 1)
    flat = tex.reshape(base_h * base_w, c)
    row = torch.cat([take_rows(flat, yy * base_w + xx)
                     for yy, xx in ((iy, ix), (iy, ix1), (iy1, ix), (iy1, ix1))], -1)
    return _bilerp_row(row.to(torch.float32), c, fx, fy)


def _catmull_weights(uv, base_h, base_w):
    tex_size = torch.tensor([base_w, base_h], dtype=torch.float32, device=uv.device)
    sample_pos = uv * tex_size
    t1 = torch.floor(sample_pos - 0.5)
    f = sample_pos - 0.5 - t1
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    return t1, (w0, w1, w2, w3)


def sample_catmull_rom_window_decode(wtex, base_h, base_w, uv, channels):
    """Full 16-texel Catmull-Rom (taa_resolve.glsl:125-174) from a 4x4
    window pack — one gathered row.  (The reference package's optional
    per-texel decode hook has no caller in the frame and is not ported.)"""
    t1, ws = _catmull_weights(uv, base_h, base_w)
    wx = [w[..., 0] for w in ws]
    wy = [w[..., 1] for w in ws]
    t0x = torch.clamp(t1[..., 0].to(torch.int32) - 1, 0, base_w - 4)
    t0y = torch.clamp(t1[..., 1].to(torch.int32) - 1, 0, base_h - 4)
    row = take_rows(wtex.reshape(base_h * base_w, -1), t0y * base_w + t0x)
    row = row.to(torch.float32)
    cc = channels
    out = 0.0
    for i in range(4):
        for j in range(4):
            k = (i * 4 + j) * cc
            out = out + row[..., k:k + cc] * (wy[i] * wx[j])[..., None]
    return out


# ---------------------------------------------------------------------------
# shadow-map PCF (lighting_pass.glsl:592-608)


def pack_depth_window_u16(depth):
    """[S,S] depth -> u16 2x2 window pack [S,S,4] (int16 bit patterns)."""
    return window_pack(quantize_u16(depth)[..., None], 2, 2)


def sample_depth_compare_window(wdepth, base_size, uv, ref):
    """One bilinear compare tap (ref < stored) from the 2x2 u16 depth pack."""
    s = base_size
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = torch.where(x0f < 0, 0.0, x - x0f)
    fy = torch.where(y0f < 0, 0.0, y - y0f)
    ix, iy = _clamp_index(x0f, s), _clamp_index(y0f, s)
    row = dequant_u16(take_rows(wdepth.reshape(s * s, 4), iy * s + ix))
    c00, c10, c01, c11 = ((ref < row[..., i]).to(torch.float32) for i in range(4))
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample_pcf4_u16(qmap, uv, ref, offsets):
    """The 4-tap bilinear PCF (lighting_pass.glsl:592-608) from the u16 map
    itself (quantize_u16's [S,S] int16 bit patterns): the 16 texels of the
    4x4 window at the base texel, which lies inside the map, so no clamp;
    the values of the reference package's split 4x4 window pack
    (sample_pcf4_window_split) without the per-frame pack."""
    s = qmap.shape[0]
    p = uv * s - 0.5
    base_x = torch.clamp(_floor_i32(p[..., 0]) - 1, 0, s - 4)
    base_y = torch.clamp(_floor_i32(p[..., 1]) - 1, 0, s - 4)
    flat = qmap.reshape(s * s)
    row = torch.stack([flat[((base_y + i) * s + base_x + j).to(torch.int64)]
                       for i in range(4) for j in range(4)], -1)
    return _pcf4_eval(dequant_u16(row), base_x, base_y, p, ref, offsets)


def _pcf4_eval(row, base_x, base_y, p, ref, offsets):
    """4-tap evaluation over a gathered 16-channel 4x4 window row."""
    cmp = [[(ref < row[..., i * 4 + j]).to(torch.float32) for j in range(4)]
           for i in range(4)]
    vis = 0.0
    for (ox, oy) in offsets:
        tx = p[..., 0] + ox
        ty = p[..., 1] + oy
        x0 = _floor_i32(tx)
        y0 = _floor_i32(ty)
        fx = tx - x0.to(torch.float32)
        fy = ty - y0.to(torch.float32)
        ux = torch.clamp(x0 - base_x, 0, 2)
        uy = torch.clamp(y0 - base_y, 0, 2)

        def pick(dy, dx):
            def col(j):
                return torch.where(uy == 0, cmp[0 + dy][j],
                                   torch.where(uy == 1, cmp[1 + dy][j], cmp[2 + dy][j]))
            return torch.where(ux == 0, col(0 + dx),
                               torch.where(ux == 1, col(1 + dx), col(2 + dx)))

        c00, c10 = pick(0, 0), pick(0, 1)
        c01, c11 = pick(1, 0), pick(1, 1)
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        vis = vis + top + (bot - top) * fy
    return vis / len(offsets)


# ---------------------------------------------------------------------------
# mip atlases


def n_mip_levels(h, w):
    return int(math.floor(math.log2(max(1, min(h, w))))) + 1


def mip_sizes(h, w, levels=None):
    levels = levels or n_mip_levels(h, w)
    return [(max(1, h >> k), max(1, w >> k)) for k in range(levels)]


def mip_offsets(h, w, levels=None):
    """Static column offsets of each level inside the atlas, total width."""
    offs, x = [], 0
    for (_, lw) in mip_sizes(h, w, levels):
        offs.append(x)
        x += lw
    return offs, x


def downsample2x(tex):
    """2x2 box filter downsample of [..., H, W, C] (GPU_OpGenerateMipmaps)."""
    h, w, c = tex.shape[-3:]
    h2, w2 = max(1, h // 2), max(1, w // 2)
    t = tex[..., :h2 * 2, :w2 * 2, :].reshape(tex.shape[:-3] + (h2, 2, w2, 2, c))
    return t.mean(dim=(-4, -2))


def build_mip_atlas(tex, levels=None):
    """Pack tex [..., H, W, C] and its box-filtered mip chain into one
    [..., H, Wa, C] atlas."""
    h, w, c = tex.shape[-3:]
    levels = levels or n_mip_levels(h, w)
    offs, wa = mip_offsets(h, w, levels)
    atlas = torch.zeros(tex.shape[:-3] + (h, wa, c), dtype=tex.dtype, device=tex.device)
    cur = tex
    for k in range(levels):
        lh, lw = max(1, h >> k), max(1, w >> k)
        atlas[..., :lh, offs[k]:offs[k] + lw, :] = cur
        if k + 1 < levels:
            cur = downsample2x(cur)
    return atlas


def pack_mip_atlas(levels_list):
    """Pack an explicit list of mip images ([..., H>>k, W>>k, C]) into one
    atlas (the bloom chain as the next frame's prev-frame pyramid)."""
    first = levels_list[0]
    h, w, c = first.shape[-3:]
    offs, wa = mip_offsets(h, w, len(levels_list))
    atlas = torch.zeros(first.shape[:-3] + (h, wa, c), dtype=first.dtype,
                        device=first.device)
    for k, lv in enumerate(levels_list):
        lh, lw = lv.shape[-3:-1]
        atlas[..., :lh, offs[k]:offs[k] + lw, :] = lv
    return atlas


def sample_mip_atlas(atlas, base_h, base_w, uv, lod, levels=None):
    """Trilinear (bilinear + mip lerp) sample of a screen mip atlas [H,Wa,C]
    (build_mip_atlas / pack_mip_atlas with `levels`), clamp addressing, at a
    per-lane continuous lod (textureLod, lighting_pass.glsl:377).  A bf16
    atlas is lerped as the reference package does it: texel differences in
    bf16, weights in f32."""
    levels = levels or n_mip_levels(base_h, base_w)
    offs, _ = mip_offsets(base_h, base_w, levels)
    dev = uv.device
    offs_arr = torch.tensor(offs, dtype=torch.int32, device=dev)
    lh_arr = torch.tensor([max(1, base_h >> k) for k in range(levels)],
                          dtype=torch.int32, device=dev)
    lw_arr = torch.tensor([max(1, base_w >> k) for k in range(levels)],
                          dtype=torch.int32, device=dev)
    lod = torch.clamp(lod, 0.0, levels - 1)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=levels - 1)
    fl = (lod - l0.to(torch.float32))[..., None]
    h, wa, c = atlas.shape
    flat = atlas.reshape(h * wa, c)

    def level_sample(lv):
        lh, lw, off = lh_arr[lv], lw_arr[lv], offs_arr[lv]
        x = uv[..., 0] * lw - 0.5
        y = uv[..., 1] * lh - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        x0, y0 = x0f.to(torch.int32), y0f.to(torch.int32)

        def g(iy, ix):
            iy = torch.minimum(torch.clamp(iy, min=0), lh - 1)
            ix = torch.minimum(torch.clamp(ix, min=0), lw - 1)
            return take_rows(flat, iy * wa + off + ix)

        t00, t10 = g(y0, x0), g(y0, x0 + 1)
        t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        return top + (bot - top) * fy

    s0 = level_sample(l0)
    s1 = level_sample(l1)
    return s0 + (s1 - s0) * fl


# ---------------------------------------------------------------------------
# u8 material atlases (the reference's 8-bit material textures)


def quantize_u8(tex, scale):
    """f32 [..,C] in [0, scale_c] -> uint8 with round-to-nearest-even."""
    return torch.clamp(torch.round(tex / scale * 255.0), 0.0, 255.0).to(torch.uint8)


def build_mip_atlas_window_u8(tex, scale, levels=None):
    """Mip atlas whose texels carry their wrap-addressed 2x2 window (4C
    channels), uint8-quantized by the per-channel `scale` [C]; mips are
    box-filtered in f32 before quantization."""
    h, w, c = tex.shape
    levels = levels or n_mip_levels(h, w)
    offs, wa = mip_offsets(h, w, levels)
    atlas = torch.zeros((h, wa, 4 * c), dtype=torch.uint8, device=tex.device)
    scale4 = scale.repeat(4)
    cur = tex
    for k in range(levels):
        lh, lw = max(1, h >> k), max(1, w >> k)
        atlas[:lh, offs[k]:offs[k] + lw] = quantize_u8(
            window_pack(cur, 2, 2, pad_mode="wrap"), scale4)
        if k + 1 < levels:
            cur = downsample2x(cur)
    return atlas


def sample_mip_atlas_array_window_nearest(atlas, layer, uv, lod, channels,
                                          scale=None, mode="wrap", rows=None):
    """Bilinear sample at the nearest mip level from a layered window atlas
    [L,H,Wa,4C] (uint8 with dequant `scale` [C], or float).  rows: a list
    that receives the atlas rows read (the flat [L*H*Wa] index per lane)."""
    nl, base_h, wa, c4 = atlas.shape
    c = channels
    levels = n_mip_levels(base_h, base_h)
    offs, wa_expect = mip_offsets(base_h, base_h, levels)
    assert wa == wa_expect
    dev = uv.device
    offs_arr = torch.tensor(offs, dtype=torch.int32, device=dev)
    size_arr = torch.tensor([max(1, base_h >> k) for k in range(levels)],
                            dtype=torch.int32, device=dev)
    lod = torch.clamp(lod, 0.0, levels - 1)
    lv = torch.round(lod).to(torch.int64)
    ls = size_arr[lv]
    off = offs_arr[lv]
    x = uv[..., 0] * ls - 0.5
    y = uv[..., 1] * ls - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    if mode == "wrap":
        ix = torch.remainder(x0f.to(torch.int32), ls)
        iy = torch.remainder(y0f.to(torch.int32), ls)
    else:
        ix = torch.minimum(torch.clamp(x0f.to(torch.int32), min=0), ls - 1)
        iy = torch.minimum(torch.clamp(y0f.to(torch.int32), min=0), ls - 1)
        fx = torch.where((x0f < 0)[..., None], 0.0, fx)
        fy = torch.where((y0f < 0)[..., None], 0.0, fy)
    flat = atlas.reshape(nl * base_h * wa, c4)
    idx = (layer * base_h + iy) * wa + off + ix
    if rows is not None:
        rows.append(idx)
    row = take_rows(flat, idx).to(torch.float32)
    if scale is not None:
        row = row * (scale.repeat(4) / 255.0)
    return _bilerp_row(row, c, fx, fy)


def sample_mip_atlas_array_window_trilinear(atlas, layer, uv, lod, channels,
                                            scale=None, mode="wrap", rows=None):
    """Trilinear (two nearest-level bilinear samples + lod lerp) from a
    layered window atlas — the reference's fixed-function material filter."""
    levels = n_mip_levels(atlas.shape[1], atlas.shape[1])
    lod = torch.clamp(lod, 0.0, levels - 1)
    l0 = torch.floor(lod)
    fl = (lod - l0)[..., None]
    a = sample_mip_atlas_array_window_nearest(atlas, layer, uv, l0, channels,
                                              scale=scale, mode=mode, rows=rows)
    b = sample_mip_atlas_array_window_nearest(
        atlas, layer, uv, torch.clamp(l0 + 1.0, max=levels - 1.0), channels,
        scale=scale, mode=mode, rows=rows)
    return a + (b - a) * fl


# ---------------------------------------------------------------------------
# cubemaps (Vulkan face order and UV mapping, gen_irradiance_map.glsl:11-66)


def cubemap_dir_from_face_uv(face_index, face_uv):
    """Unit direction for (face int [...], uv [...,2])."""
    sc = 2.0 * (face_uv[..., 0] - 0.5)
    tc = 2.0 * (face_uv[..., 1] - 0.5)
    one = torch.ones_like(sc)
    dirs = torch.stack(
        [
            torch.stack([one, -tc, -sc], -1),   # +X
            torch.stack([-one, -tc, sc], -1),   # -X
            torch.stack([sc, one, tc], -1),     # +Y
            torch.stack([sc, -one, -tc], -1),   # -Y
            torch.stack([sc, -tc, one], -1),    # +Z
            torch.stack([-sc, -tc, -one], -1),  # -Z
        ],
        dim=0,
    )
    f = torch.broadcast_to(torch.as_tensor(face_index, device=sc.device), sc.shape)
    idx = f.to(torch.int64).reshape(1, -1, 1).expand(1, -1, 3)
    d = torch.gather(dirs.reshape(6, -1, 3), 0, idx)[0].reshape(sc.shape + (3,))
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def cubemap_face_uv_from_dir(r):
    """Direction [...,3] -> (face i32 [...], uv [...,2])."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    ).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-20)
    sc = torch.where(is_x, torch.where(x >= 0, -z, z),
                     torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    u = 0.5 * sc / ma + 0.5
    v = 0.5 * tc / ma + 0.5
    return face, torch.stack([u, v], -1)


def build_cube_mip_atlas(faces, levels=None):
    """[6,S,S,C] cubemap -> [6,S,Wa,C] per-face box-filtered mip atlas."""
    s = faces.shape[1]
    return build_mip_atlas(faces, levels or n_mip_levels(s, s))


def sample_cubemap_lod(cube_atlas, base_size, r, lod):
    """Trilinear cubemap sample with dynamic LOD from a cube mip atlas
    [6,S,Wa,C] (textureLod(samplerCube, dir, lod))."""
    six, s, wa, c = cube_atlas.shape
    levels = n_mip_levels(base_size, base_size)
    offs, _ = mip_offsets(base_size, base_size, levels)
    dev = r.device
    offs_arr = torch.tensor(offs, dtype=torch.int32, device=dev)
    size_arr = torch.tensor([max(1, base_size >> k) for k in range(levels)],
                            dtype=torch.int32, device=dev)
    face, uv = cubemap_face_uv_from_dir(r)
    lod = torch.clamp(lod, 0.0, levels - 1)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=levels - 1)
    fl = (lod - l0.to(torch.float32))[..., None]
    flat = cube_atlas.reshape(6 * s * wa, c)

    def level_sample(lv):
        ls = size_arr[lv]
        off = offs_arr[lv]
        x = uv[..., 0] * ls - 0.5
        y = uv[..., 1] * ls - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        x0 = x0f.to(torch.int32)
        y0 = y0f.to(torch.int32)

        def g(iy, ix):
            iy = torch.minimum(torch.clamp(iy, min=0), ls - 1)
            ix = off + torch.minimum(torch.clamp(ix, min=0), ls - 1)
            return take_rows(flat, (face * s + iy) * wa + ix)

        t00, t10 = g(y0, x0), g(y0, x0 + 1)
        t01, t11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        return top + (bot - top) * fy

    s0 = level_sample(l0)
    s1 = level_sample(l1)
    return s0 + (s1 - s0) * fl


def pack_cube_mip_atlas_window(cube_atlas, base_size, dtype=torch.float16):
    """Cube mip atlas [6,S,Wa,C] -> window-packed [6,S,Wa,4C] (f16): each
    level packed separately with edge clamping, so a static-level sample is
    one row and a dynamic-LOD sample two."""
    six, s, wa, c = cube_atlas.shape
    levels = n_mip_levels(base_size, base_size)
    offs, _ = mip_offsets(base_size, base_size, levels)
    out = torch.zeros((six, s, wa, 4 * c), dtype=dtype, device=cube_atlas.device)
    for k in range(levels):
        ls = max(1, base_size >> k)
        lvl = cube_atlas[:, :ls, offs[k]:offs[k] + ls]
        out[:, :ls, offs[k]:offs[k] + ls] = window_pack(lvl, 2, 2, "edge", dtype)
    return out


def _cube_window_level_sample(flat, s, wa, c, face, uv, ls, off):
    """One bilinear sample from a window-packed cube atlas level; ls / off
    are python ints or per-lane int tensors."""
    x = uv[..., 0] * ls - 0.5
    y = uv[..., 1] * ls - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    ix = torch.minimum(torch.clamp(x0f.to(torch.int32), min=0),
                       torch.as_tensor(ls - 1, device=x.device))
    iy = torch.minimum(torch.clamp(y0f.to(torch.int32), min=0),
                       torch.as_tensor(ls - 1, device=x.device))
    fx = torch.where((x0f < 0)[..., None], 0.0, fx)
    fy = torch.where((y0f < 0)[..., None], 0.0, fy)
    row = take_rows(flat, (face * s + iy) * wa + off + ix).to(torch.float32)
    return _bilerp_row(row, c, fx, fy)


def sample_cubemap_level_window(wcube, base_size, r, level):
    """Bilinear cubemap sample at one static mip level — one row."""
    six, s, wa, c4 = wcube.shape
    levels = n_mip_levels(base_size, base_size)
    level = min(int(level), levels - 1)
    offs, _ = mip_offsets(base_size, base_size, levels)
    face, uv = cubemap_face_uv_from_dir(r)
    return _cube_window_level_sample(
        wcube.reshape(six * s * wa, c4), s, wa, c4 // 4, face, uv,
        max(1, base_size >> level), offs[level])


def sample_cubemap_lod_window(wcube, base_size, r, lod):
    """Trilinear cubemap sample (bilinear + mip lerp) — two rows."""
    six, s, wa, c4 = wcube.shape
    levels = n_mip_levels(base_size, base_size)
    offs, _ = mip_offsets(base_size, base_size, levels)
    dev = r.device
    offs_arr = torch.tensor(offs, dtype=torch.int32, device=dev)
    size_arr = torch.tensor([max(1, base_size >> k) for k in range(levels)],
                            dtype=torch.int32, device=dev)
    face, uv = cubemap_face_uv_from_dir(r)
    lod = torch.clamp(lod, 0.0, levels - 1)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=levels - 1)
    fl = (lod - l0.to(torch.float32))[..., None]
    flat = wcube.reshape(six * s * wa, c4)
    s0 = _cube_window_level_sample(flat, s, wa, c4 // 4, face, uv,
                                   size_arr[l0], offs_arr[l0])
    s1 = _cube_window_level_sample(flat, s, wa, c4 // 4, face, uv,
                                   size_arr[l1], offs_arr[l1])
    return s0 + (s1 - s0) * fl
