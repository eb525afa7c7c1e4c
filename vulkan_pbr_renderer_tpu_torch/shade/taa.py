"""Temporal anti-aliasing resolve (counterpart of
vulkan_pbr_renderer_tpu/shade/taa.py, taa_resolve.glsl:180-287).

Mitchell-Netravali 3x3 source filter, neighborhood moments, closest-depth
velocity dilation (the intended form of the reference's loop, see the
reference package's note), Catmull-Rom history resampling at the reprojected
uv, variance clipping and velocity-difference history rejection.

`taa_resolve` dispatches: a CUDA tensor launches csrc/post.cu's taa_kernel,
a thread per output pixel; a CPU tensor takes `taa_resolve_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..gpu import cuda_build, sampling
from ..utils import math3d as m3


def _mitchell(x, b=1.0 / 3.0, c=1.0 / 3.0):
    ax = abs(x)
    if ax < 1:
        return ((12 - 9 * b - 6 * c) * ax**3 + (-18 + 12 * b + 6 * c) * ax**2 + (6 - 2 * b)) / 6
    if ax < 2:
        return ((-b - 6 * c) * ax**3 + (6 * b + 30 * c) * ax**2 + (-12 * b - 48 * c) * ax
                + (8 * b + 24 * c)) / 6
    return 0.0


def _pad_edge(x, pad_y=1):
    """Edge-pad [H,W,...] by one pixel on each side of W and pad_y on each
    side of H."""
    h, w = x.shape[:2]
    iy = torch.clamp(torch.arange(-pad_y, h + pad_y, device=x.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-1, w + 1, device=x.device), 0, w - 1)
    return x.index_select(0, iy).index_select(1, ix)


def taa_resolve_plain(lighting, depth, velocity, velocity_prev, history, blend=0.05,
                      velocity_rejection=1000.0, gamma=1.0, catmull_history=True,
                      full_rgb_catmull=False, halo=0, row_offset=0, full_height=None):
    """New TAA output [H,W,3] from the current lighting [H,W,3], depth [H,W],
    velocity [H,W,2] and the previous frame's velocity and TAA output.

    Row-sharded frame (taa.py:42-68): lighting, depth and velocity are the
    rows [row_offset, row_offset + H) WITH one edge-clamped halo row on each
    side (halo=1), which supply the 3x3 neighbourhoods; history and
    velocity_prev stay full_height tall (the reprojected uv can land on any
    row).  The output is then the same rows of the whole-frame resolve."""
    w = depth.shape[1]
    h = depth.shape[0] - 2 * halo
    fh = full_height or h
    dev = depth.device
    offsets = [(dy, dx) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    weights = [_mitchell(np.hypot(dx, dy)) for (dy, dx) in offsets]
    wsum = float(sum(weights))

    pad = _pad_edge(lighting, 1 - halo)
    source = lighting.new_zeros((h, w, 3))
    m1 = lighting.new_zeros((h, w, 3))
    m2 = lighting.new_zeros((h, w, 3))
    for (dy, dx), wgt in zip(offsets, weights):
        nb = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        source = source + float(np.float32(wgt)) * nb
        m1 = m1 + nb
        m2 = m2 + nb * nb
    source = source * float(np.float32(1.0 / wsum))
    m1 = m1 * float(np.float32(1.0 / 9.0))
    m2 = m2 * float(np.float32(1.0 / 9.0))
    sigma = m3.sqrt(torch.abs(m2 - m1 * m1))
    minc = m1 - gamma * sigma
    maxc = m1 + gamma * sigma

    # closest-depth velocity dilation
    dpad = _pad_edge(depth, 1 - halo)
    vpad = _pad_edge(velocity, 1 - halo)
    best_d = dpad[1:1 + h, 1:1 + w]
    vel = vpad[1:1 + h, 1:1 + w]
    for (dy, dx) in offsets:
        if dy == 0 and dx == 0:
            continue
        d_n = dpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        v_n = vpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        take = d_n < best_d
        best_d = torch.where(take, d_n, best_d)
        vel = torch.where(take[..., None], v_n, vel)

    u = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + row_offset + 0.5) / fh
    uv = torch.stack([u.expand(h, w), v.expand(h, w)], -1)
    reproj_uv = uv - vel * 0.5

    if catmull_history and full_rgb_catmull:
        # full-RGB 16-tap Catmull-Rom + bilinear prev velocity
        wrgb = sampling.window_pack(history, 4, 4, dtype=torch.float16)
        prev_color = torch.clamp(
            sampling.sample_catmull_rom_window_decode(wrgb, fh, w, reproj_uv, 3), min=0.0)
        wvel = sampling.window_pack(velocity_prev, 2, 2, dtype=torch.float16)
        prev_vel = sampling.sample_bilinear_window(wvel, fh, w, reproj_uv, 2)
    elif catmull_history:
        # YCoCg split: 16-tap Catmull-Rom of f16 luma, bilinear f16 chroma
        # and prev velocity from one shared 2x2 window row
        y = 0.25 * history[..., 0] + 0.5 * history[..., 1] + 0.25 * history[..., 2]
        co = 0.5 * history[..., 0] - 0.5 * history[..., 2]
        cg = -0.25 * history[..., 0] + 0.5 * history[..., 1] - 0.25 * history[..., 2]
        wluma = sampling.window_pack(y[..., None], 4, 4, dtype=torch.float16)
        wcv = sampling.window_pack(
            torch.cat([torch.stack([co, cg], -1), velocity_prev], -1), 2, 2,
            dtype=torch.float16)
        y_s = torch.clamp(sampling.sample_catmull_rom_window_decode(
            wluma, fh, w, reproj_uv, 1)[..., 0], min=0.0)
        cv = sampling.sample_bilinear_window(wcv, fh, w, reproj_uv, 4)
        co_s, cg_s = cv[..., 0], cv[..., 1]
        prev_vel = cv[..., 2:4]
        prev_color = torch.stack([y_s + co_s - cg_s, y_s + cg_s, y_s - co_s - cg_s], -1)
    else:
        whv = sampling.window_pack(torch.cat([history, velocity_prev], -1), 2, 2,
                                   dtype=torch.float16)
        hv = sampling.sample_bilinear_window(whv, fh, w, reproj_uv, 5)
        prev_color = hv[..., :3]
        prev_vel = hv[..., 3:5]
    prev_color = torch.minimum(torch.maximum(prev_color, minc), maxc)

    weight_b = blend + velocity_rejection * torch.linalg.vector_norm(prev_vel - vel, dim=-1)
    offscreen = torch.any((reproj_uv < 0.0) | (reproj_uv > 1.0), dim=-1)
    weight_b = torch.where(offscreen, 1.0, weight_b)[..., None]
    weight_a = torch.where(offscreen[..., None], 0.0, 1.0 - blend)
    return (source * weight_b + prev_color * weight_a) / torch.clamp(
        weight_b + weight_a, min=1e-5)


@functools.cache
def _filter():
    """The f32 Mitchell weights of the 3x3 offsets (dx-outer, dy-inner), and
    the f32 factors 1 / their sum and 1 / 9, as taa_resolve_plain uses them."""
    offsets = [(dy, dx) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    weights = [_mitchell(np.hypot(dx, dy)) for (dy, dx) in offsets]
    return ([float(np.float32(wt)) for wt in weights], float(np.float32(1.0 / sum(weights))),
            float(np.float32(1.0 / 9.0)))


def _check(lighting, depth, velocity, velocity_prev, history, halo, full_height, row_begin,
           row_count):
    """Raise ValueError unless the inputs are what taa_resolve takes; returns
    (output rows, full height)."""
    fn = "taa_resolve"
    if not torch.is_tensor(lighting) or lighting.dim() != 3 or lighting.shape[2] != 3:
        raise ValueError(f"{fn}: lighting must be an [H, W, 3] tensor")
    dev = lighting.device
    n_in, w = lighting.shape[:2]
    if row_begin is not None:
        if halo or (full_height not in (None, n_in)):
            raise ValueError(f"{fn}: a row window reads full-height lighting, depth and "
                             "velocity (halo 0)")
        if row_count is None or row_begin < 0 or row_count < 1 or row_begin + row_count > n_in:
            raise ValueError(f"{fn}: rows ({row_begin}, {row_count}) outside the frame's "
                             f"{n_in} rows")
        rows, fh = row_count, n_in
    else:
        rows = n_in - 2 * halo
        fh = full_height or rows
    for t, what, shape in ((lighting, "lighting", (n_in, w, 3)), (depth, "depth", (n_in, w)),
                           (velocity, "velocity", (n_in, w, 2)),
                           (velocity_prev, "velocity_prev", (fh, w, 2)),
                           (history, "history", (fh, w, 3))):
        if not torch.is_tensor(t) or t.dtype != torch.float32 or t.device != dev:
            got = f"{t.dtype} on {t.device}" if torch.is_tensor(t) else type(t).__name__
            raise ValueError(f"{fn}: {what} must be a float32 tensor on {dev}, got {got}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {what} must have shape {shape}, got {tuple(t.shape)}")
    if rows < 1:
        raise ValueError(f"{fn}: no output rows")
    return rows, fh


def taa_resolve(lighting, depth, velocity, velocity_prev, history, blend=0.05,
                velocity_rejection=1000.0, gamma=1.0, catmull_history=True,
                full_rgb_catmull=False, halo=0, row_offset=0, full_height=None,
                row_begin=None, row_count=None):
    """taa_resolve_plain's resolve (its docstring, the halo API included).
    Or a row window of the output: rows [row_begin, row_begin + row_count)
    of the whole-frame resolve, from full-height lighting, depth and
    velocity (the row-sharded frame; no halo slab).  The inputs are checked
    first (ValueError); then a CUDA tensor launches csrc/post.cu's taa_kernel
    (or raises) and a CPU tensor takes taa_resolve_plain (a window as its
    halo=1 slab).  `taa_resolve.launches` counts launches."""
    rows, fh = _check(lighting, depth, velocity, velocity_prev, history, halo, full_height,
                      row_begin, row_count)
    kw = dict(blend=blend, velocity_rejection=velocity_rejection, gamma=gamma,
              catmull_history=catmull_history, full_rgb_catmull=full_rgb_catmull)
    if not lighting.is_cuda:
        if row_begin is None:
            return taa_resolve_plain(lighting, depth, velocity, velocity_prev, history, halo=halo,
                                     row_offset=row_offset, full_height=full_height, **kw)
        slabs = [sampling.edge_rows(t, row_begin, row_count, 1, 1)
                 for t in (lighting, depth, velocity)]
        return taa_resolve_plain(*slabs, velocity_prev, history, halo=1, row_offset=row_begin,
                                 full_height=fh, **kw)
    w = lighting.shape[1]
    if catmull_history and (w < 4 or fh < 4):
        raise ValueError("taa_resolve: the Catmull-Rom history needs a frame of at least 4x4")
    ins = (lighting, depth, velocity, velocity_prev, history)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("taa_resolve: the kernel reads contiguous inputs")
    out = torch.empty((rows, w, 3), dtype=torch.float32, device=lighting.device)
    weights, inv_wsum, inv9 = _filter()
    window = row_begin is not None
    args = _TaaArgs(
        *[t.data_ptr() for t in ins], out.data_ptr(), (ctypes.c_float * 9)(*weights),
        inv_wsum, inv9, blend, 1.0 - blend, velocity_rejection, gamma,
        # PyTorch on the card divides by a Python number as a product with
        # its f32 reciprocal: the kernel does too
        float(np.float32(1.0) / np.float32(w)), float(np.float32(1.0) / np.float32(fh)),
        rows, w, lighting.shape[0], row_begin if window else halo,
        row_begin if window else row_offset, fh,
        (1 if full_rgb_catmull else 0) if catmull_history else 2)
    lib = _library()
    with torch.cuda.device(lighting.device):
        err = lib.taa_resolve_launch(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"taa_resolve kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    taa_resolve.launches += 1
    return out


taa_resolve.launches = 0


class _TaaArgs(ctypes.Structure):
    """struct TaaArgs of csrc/post.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "lighting", "depth", "velocity", "velocity_prev", "history", "out")] + [
        ("weights", ctypes.c_float * 9)] + [(n, ctypes.c_float) for n in (
            "inv_wsum", "inv9", "blend", "one_minus_blend", "velocity_rejection", "gamma",
            "inv_w", "inv_fh")] + [(n, ctypes.c_int) for n in (
                "rows", "w", "in_rows", "in_shift", "v_row0", "fh", "mode")]


def _library():
    """The built post library (csrc/post.cu)."""
    lib = cuda_build.load_library("post")
    lib.taa_resolve_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.taa_resolve_launch.restype = ctypes.c_int
    return lib
