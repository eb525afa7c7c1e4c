"""Triangle setup for 2D-homogeneous rasterization (counterpart of
vulkan_pbr_renderer_tpu/raster/setup.py).

Olano-Greer 2D homogeneous rasterization: edge functions and screen-linear
interpolation coefficients come from the adjugate of the 3x3 matrix of
clip-space (x_px*w, y_px*w, w) rows, so triangles crossing w=0 need no
near-plane clipping.  Same conventions as the reference package: clip x,y in
[-w,w] with y down, z in [0,w]; pixel centers at +0.5; a pixel is inside a
front-facing triangle iff all three edge values are >= 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..gpu import cuda_build
from ..utils import math3d as m3

CULL_MODES = ("back", "front", "none")   # csrc/setup.cu's cull argument, in order


class TriSetup(NamedTuple):
    """Per-triangle rasterization data (all [N, ...])."""

    adj: torch.Tensor      # [N,3,3] adjugate; columns j = edge j coeffs
    c_w: torch.Tensor      # [N,3]   1/w-interp numerator coeffs (adj @ ones)
    c_z: torch.Tensor      # [N,3]   screen-linear depth plane (w<=0 tris)
    z_vert: torch.Tensor   # [N,3]   (z0_ndc, z1-z0, z2-z0) high-precision depth
    z_mode: torch.Tensor   # [N]     bool: True = use z_vert (all w healthy)
    det: torch.Tensor      # [N]     signed 2x area (homogeneous)
    bbox: torch.Tensor     # [N,4]   i32 pixel bbox (x0, y0, x1, y1), clipped
    valid: torch.Tensor    # [N]     bool: rasterize this triangle


def _adjugate3(a):
    """Adjugate of [...,3,3] (transpose of the cofactor matrix)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return torch.stack(
        [
            torch.stack([c00, c10, c20], -1),
            torch.stack([c01, c11, c21], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        dim=-2,
    )


def setup_triangles(clip, width, height, cull="back"):
    """TriSetup from clip-space triangle vertices clip [N,3,4].

    cull: 'back' (keep camera-facing det<0 tris), 'front', or 'none' (keep
    both; back faces are orientation-flipped so edge tests still work).
    Edge / interpolation coefficients are in pixel space.
    """
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    xh = (0.5 * x + 0.5 * w) * width
    yh = (0.5 * y + 0.5 * w) * height
    m = torch.stack([xh, yh, w], dim=-1)  # [N,3,3] rows = vertices

    adj = _adjugate3(m)
    det = (
        m[..., 0, 0] * adj[..., 0, 0]
        + m[..., 0, 1] * adj[..., 1, 0]
        + m[..., 0, 2] * adj[..., 2, 0]
    )

    # y-down pixel coords: camera-facing triangles have det < 0
    if cull == "back":
        valid = det < 0.0
        flip = -torch.ones_like(det)
    elif cull == "front":
        valid = det > 0.0
        flip = torch.ones_like(det)
    elif cull == "none":
        valid = det != 0.0
        flip = torch.sign(det)
    else:
        raise ValueError(f"bad cull mode {cull!r}")
    adj = adj * flip[..., None, None]

    c_w = adj[..., 0] + adj[..., 1] + adj[..., 2]        # adj @ ones
    abs_det = flip * det
    c_z = (adj[..., 0] * z[:, 0:1] + adj[..., 1] * z[:, 1:2]
           + adj[..., 2] * z[:, 2:3])
    c_z = c_z / torch.where(abs_det == 0, torch.ones_like(abs_det), abs_det)[..., None]

    # high-precision depth: per-vertex z_ndc + deltas (TriSetup docstring)
    eps_w = 1e-6
    safe_w = torch.where(torch.abs(w) < eps_w, torch.full_like(w, eps_w), w)
    zv = z / safe_w
    z_vert = torch.stack([zv[:, 0], zv[:, 1] - zv[:, 0], zv[:, 2] - zv[:, 0]], -1)
    z_mode = torch.all(w > eps_w, dim=-1)

    # Screen bbox: project and bound the front vertices; a triangle crossing
    # w = eps extends to the screen border along each sign of its crossing
    # directions (setup.py of the reference package, round 3).
    eps = 1e-6
    front = w > eps                                        # [N,3]
    pxv = xh / torch.clamp(w, min=eps)
    pyv = yh / torch.clamp(w, min=eps)
    big = 1e9
    px_min = torch.where(front, pxv, big).amin(-1)
    px_max = torch.where(front, pxv, -big).amax(-1)
    py_min = torch.where(front, pyv, big).amin(-1)
    py_max = torch.where(front, pyv, -big).amax(-1)
    ext_xp = torch.zeros_like(valid)
    ext_xn = torch.zeros_like(valid)
    ext_yp = torch.zeros_like(valid)
    ext_yn = torch.zeros_like(valid)
    for i in range(3):
        j = (i + 1) % 3
        wi, wj = w[..., i], w[..., j]
        cross = front[..., i] != front[..., j]
        dw = wj - wi
        denom = torch.where(torch.abs(dw) < 1e-30, torch.full_like(dw, 1e-30), dw)
        t = (eps - wi) / denom
        dx = xh[..., i] + t * (xh[..., j] - xh[..., i])
        dy = yh[..., i] + t * (yh[..., j] - yh[..., i])
        ext_xp |= cross & (dx >= 0)
        ext_xn |= cross & (dx <= 0)
        ext_yp |= cross & (dy >= 0)
        ext_yn |= cross & (dy <= 0)
    px_min = torch.where(ext_xn, -big, px_min)
    px_max = torch.where(ext_xp, big, px_max)
    py_min = torch.where(ext_yn, -big, py_min)
    py_max = torch.where(ext_yp, big, py_max)
    x0 = torch.clamp(torch.floor(px_min), 0, width).to(torch.int32)
    y0 = torch.clamp(torch.floor(py_min), 0, height).to(torch.int32)
    x1 = torch.clamp(torch.ceil(px_max) + 1, 0, width).to(torch.int32)
    y1 = torch.clamp(torch.ceil(py_max) + 1, 0, height).to(torch.int32)
    bbox = torch.stack([x0, y0, x1, y1], -1)
    any_front = torch.any(front, dim=-1)
    nonempty = (x1 > x0) & (y1 > y0)
    valid = valid & any_front & nonempty
    return TriSetup(adj=adj, c_w=c_w, c_z=c_z, z_vert=z_vert, z_mode=z_mode,
                    det=det, bbox=bbox, valid=valid)


def transform_to_clip(positions, mat, jitter=None):
    """World [N,3] -> clip [N,4] via mat [4,4]; optional TAA jitter [2] in NDC
    added in clip space scaled by w (geometry_pass.glsl:109-113)."""
    clip = m3.transform_points(mat, positions)
    if jitter is not None:
        clip = torch.cat([clip[..., :2] + jitter * clip[..., 3:4], clip[..., 2:]], -1)
    return clip


def transform_and_setup(tri_pos, mat, width, height, cull="back", jitter=None):
    """TriSetup of world triangles tri_pos [N,3,3] under mat [4,4] (with the
    optional TAA jitter [2]): setup_triangles(transform_to_clip(...)).

    A CPU tensor takes that composition, the plain version.  A CUDA tensor
    launches csrc/setup.cu once (or raises): every field from one pass over
    the triangles, bit for bit the composition on the card.  tri_pos's rows
    may be any stride apart (the renderer's view of scene.tri_attr is read
    in place) but each [3,3] must be contiguous.
    `transform_and_setup.launches` counts kernel launches."""
    if not tri_pos.is_cuda:
        return setup_triangles(transform_to_clip(tri_pos, mat, jitter), width, height, cull)
    fn, dev = "transform_and_setup", tri_pos.device
    if cull not in CULL_MODES:
        raise ValueError(f"bad cull mode {cull!r}")
    if (tri_pos.dtype != torch.float32 or tri_pos.dim() != 3
            or tuple(tri_pos.shape[1:]) != (3, 3)):
        raise ValueError(f"{fn}: tri_pos must be a float32 [N,3,3] tensor, got "
                         f"{tri_pos.dtype} {tuple(tri_pos.shape)}")
    n = tri_pos.shape[0]
    if n > 1 and tri_pos.stride()[1:] != (3, 1):
        raise ValueError(f"{fn}: each [3,3] of tri_pos must be contiguous, strides "
                         f"{tri_pos.stride()}")
    # the kernel reads the matrix and the jitter as dense arrays
    mat = mat.contiguous() if torch.is_tensor(mat) else mat
    jitter = jitter.contiguous() if torch.is_tensor(jitter) else jitter
    cuda_build.need(mat, "mat", fn, dev, (4, 4))
    if jitter is not None:
        cuda_build.need(jitter, "jitter", fn, dev, (2,))
    if not (0 < width < 2 ** 24 and 0 < height < 2 ** 24):
        raise ValueError(f"{fn}: viewport {width}x{height} out of range")
    out = TriSetup(
        adj=torch.empty((n, 3, 3), dtype=torch.float32, device=dev),
        c_w=torch.empty((n, 3), dtype=torch.float32, device=dev),
        c_z=torch.empty((n, 3), dtype=torch.float32, device=dev),
        z_vert=torch.empty((n, 3), dtype=torch.float32, device=dev),
        z_mode=torch.empty((n,), dtype=torch.bool, device=dev),
        det=torch.empty((n,), dtype=torch.float32, device=dev),
        bbox=torch.empty((n, 4), dtype=torch.int32, device=dev),
        valid=torch.empty((n,), dtype=torch.bool, device=dev))
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.setup_launch(
            tri_pos.data_ptr(), tri_pos.stride(0), mat.data_ptr(),
            jitter.data_ptr() if jitter is not None else None, int(width), int(height),
            CULL_MODES.index(cull), n, *(t.data_ptr() for t in (
                out.adj, out.c_w, out.c_z, out.z_vert, out.z_mode, out.det, out.bbox,
                out.valid)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"setup kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")
    transform_and_setup.launches += 1
    return out


transform_and_setup.launches = 0


def _library():
    lib = cuda_build.load_library("setup")
    lib.setup_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
    lib.setup_launch.restype = ctypes.c_int
    return lib
