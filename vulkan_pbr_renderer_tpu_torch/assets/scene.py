"""Scene container (counterpart of vulkan_pbr_renderer_tpu/assets/scene.py).

One merged triangle soup with per-triangle material ids, and one packed
uint8 material mip atlas (channels 0-3 base color rgba, 4-5 normal xy, 6-8
ORM, 9-11 emissive, each texel carrying its 2x2 bilinear window) with
per-channel dequantization scales.  The arrays equal those of the JAX
package's build_scene.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..gpu import sampling


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description; textures are numpy [h,w,c] in [0,1]."""

    base_color: Optional[np.ndarray] = None   # rgba; alpha used for alpha test
    normal: Optional[np.ndarray] = None       # tangent-space, xy in [0,1]
    orm: Optional[np.ndarray] = None          # occlusion/roughness/metallic
    emissive: Optional[np.ndarray] = None
    base_color_factor: tuple = (1.0, 1.0, 1.0, 1.0)
    orm_factor: tuple = (1.0, 0.7, 0.0)
    emissive_factor: tuple = (0.0, 0.0, 0.0)
    alpha_test: bool = False


@dataclasses.dataclass
class MeshPart:
    """Host-side mesh part: one material, triangle soup."""

    positions: np.ndarray       # [V,3]
    normals: np.ndarray         # [V,3]
    uvs: np.ndarray             # [V,2]
    indices: np.ndarray         # [T,3] int32
    material: int


class Scene(NamedTuple):
    """Device-side scene."""

    tex_packed: torch.Tensor    # [M,TS,Wa,48] uint8 window-packed mip atlas
    tex_scale: torch.Tensor     # [12] f32: value = u8/255 * tex_scale[c]
    tri_attr: torch.Tensor      # [T,24] f32: pos0..2 (9), nrm0..2 (9), uv0..2 (6)
    mat_id: torch.Tensor        # [T] i32
    tri_alpha: torch.Tensor     # [T] f32: 1.0 where the material alpha-tests

    @property
    def num_tris(self) -> int:
        return self.tri_attr.shape[0]


def _resize_bilinear_np(img, size):
    """Host-side bilinear resize to (size,size)."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.astype(np.float32)
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def _prep_tex(tex, factor, size, channels, fill):
    """Resize / constant-fill one material texture to [size,size,channels]."""
    if tex is None:
        base = np.broadcast_to(np.asarray(fill, np.float32), (size, size, channels)).copy()
    else:
        t = np.asarray(tex, np.float32)
        if t.ndim == 2:
            t = t[..., None]
        if t.shape[-1] < channels:  # missing channels (e.g. alpha) default to 1
            pad = np.ones(t.shape[:-1] + (channels - t.shape[-1],), np.float32)
            t = np.concatenate([t, pad], -1)
        base = _resize_bilinear_np(t[..., :channels], size)
    return base * np.asarray(factor, np.float32)[:channels]


def build_scene(parts: Sequence[MeshPart], materials: Sequence[MaterialDesc],
                texture_size: int = 256, device="cuda") -> Scene:
    """Merge parts into one triangle soup + build the material atlas, on
    `device` (the card unless the caller asks for the CPU; raises without
    one)."""
    device = resolve_device(device)
    assert texture_size & (texture_size - 1) == 0, "texture_size must be pow2"
    pos = np.concatenate([np.asarray(p.positions, np.float32) for p in parts])
    nrm = np.concatenate([np.asarray(p.normals, np.float32) for p in parts])
    uv = np.concatenate([np.asarray(p.uvs, np.float32) for p in parts])
    v_off = np.cumsum([0] + [p.positions.shape[0] for p in parts])[:-1]
    idx = np.concatenate([np.asarray(p.indices, np.int64) + o
                          for p, o in zip(parts, v_off)]).astype(np.int32)
    mat = np.concatenate([np.full((p.indices.shape[0],), p.material, np.int32)
                          for p in parts])

    ts = texture_size
    packed = np.stack([
        np.concatenate([
            _prep_tex(m.base_color, m.base_color_factor, ts, 4, (1, 1, 1, 1)),
            _prep_tex(m.normal, (1, 1), ts, 2, (0.5, 0.5)),
            _prep_tex(m.orm, (1, 1, 1), ts, 3, m.orm_factor),
            _prep_tex(m.emissive, (1, 1, 1), ts, 3, m.emissive_factor),
        ], axis=-1)
        for m in materials
    ])
    # per-channel dequant scale = max over all materials, at least 1
    tex_scale = np.maximum(packed.reshape(-1, 12).max(axis=0), 1.0).astype(np.float32)
    arr = torch.as_tensor(packed, dtype=torch.float32, device=device)
    scale = torch.as_tensor(tex_scale, device=device)
    tex_packed = torch.stack([sampling.build_mip_atlas_window_u8(arr[i], scale)
                              for i in range(arr.shape[0])])

    tri_attr = np.concatenate(
        [pos[idx].reshape(-1, 9), nrm[idx].reshape(-1, 9), uv[idx].reshape(-1, 6)],
        axis=1,
    ).astype(np.float32)
    at = np.asarray([m.alpha_test for m in materials], bool)
    return Scene(
        tex_packed=tex_packed,
        tex_scale=scale,
        tri_attr=torch.as_tensor(tri_attr, device=device),
        mat_id=torch.as_tensor(mat, device=device),
        tri_alpha=torch.as_tensor(at[mat].astype(np.float32), device=device),
    )
