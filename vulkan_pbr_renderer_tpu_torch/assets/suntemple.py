"""Procedural SunTemple stand-in (numpy copy of
vulkan_pbr_renderer_tpu/assets/suntemple.py, which cannot be imported
without importing jax).

A columned temple hall: stone floor and walls, two colonnades, a ceiling
with skylight openings, emissive braziers and gold trim.  The triangle count
grows ~detail^2; detail 4.5 gives 638,700 triangles.  Z-up, floor at z=0,
hall along +Y, inside the ±40-unit sun volume.
"""

from __future__ import annotations

import numpy as np

from .scene import MaterialDesc, MeshPart

M_FLOOR, M_WALL, M_COLUMN, M_GOLD, M_EMBER, M_CEIL = range(6)


def _grid_plane(center, size, normal_axis, sign, nx, ny, material, uv_scale=1.0):
    """Subdivided plane with outward normal sign along normal_axis."""
    c = np.asarray(center, np.float32)
    ua, va = [a for a in (0, 1, 2) if a != normal_axis]
    xs = np.linspace(-size[0] / 2, size[0] / 2, nx + 1)
    ys = np.linspace(-size[1] / 2, size[1] / 2, ny + 1)
    P = np.zeros(((nx + 1) * (ny + 1), 3), np.float32)
    UV = np.zeros(((nx + 1) * (ny + 1), 2), np.float32)
    k = 0
    for j, y in enumerate(ys):
        for i, x in enumerate(xs):
            p = c.copy()
            p[ua] += x
            p[va] += y
            P[k] = p
            UV[k] = (i / nx * uv_scale, j / ny * uv_scale)
            k += 1
    n = np.zeros(3, np.float32)
    n[normal_axis] = sign
    N = np.tile(n, ((nx + 1) * (ny + 1), 1))
    # winding accounts for the handedness of the (ua, va, normal) basis
    rh = 1.0 if (ua, va) == ((normal_axis + 1) % 3, (normal_axis + 2) % 3) else -1.0
    I = []
    for j in range(ny):
        for i in range(nx):
            a = j * (nx + 1) + i
            b = a + nx + 1
            if sign * rh > 0:
                I += [[a, a + 1, b + 1], [a, b + 1, b]]
            else:
                I += [[a, b + 1, a + 1], [a, b, b + 1]]
    return MeshPart(P, N, UV, np.asarray(I, np.int32), material)


def _cylinder(center, radius, height, seg, rings, material):
    c = np.asarray(center, np.float32)
    P, N, UV, I = [], [], [], []
    for r in range(rings + 1):
        z = height * r / rings
        for s in range(seg + 1):
            a = 2 * np.pi * s / seg
            n = np.array([np.cos(a), np.sin(a), 0], np.float32)
            P.append(c + n * radius + [0, 0, z])
            N.append(n)
            UV.append((s / seg * 3, r / rings * 2))
    for r in range(rings):
        for s in range(seg):
            a = r * (seg + 1) + s
            b = a + seg + 1
            I += [[a, b, a + 1], [a + 1, b, b + 1]]
    return MeshPart(np.asarray(P, np.float32), np.asarray(N, np.float32),
                    np.asarray(UV, np.float32), np.asarray(I, np.int32), material)


def _box(center, size, material, nsub=1):
    """Subdivided box from 6 grid planes merged."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32)
    parts = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            other = [s[i] for i in range(3) if i != axis]
            ctr = c.copy()
            ctr[axis] += sign * s[axis] / 2
            parts.append(_grid_plane(ctr, other, axis, sign, nsub, nsub, material))
    return merge_parts(parts)


def merge_parts(parts):
    P = np.concatenate([p.positions for p in parts])
    N = np.concatenate([p.normals for p in parts])
    UV = np.concatenate([p.uvs for p in parts])
    off = np.cumsum([0] + [p.positions.shape[0] for p in parts])[:-1]
    I = np.concatenate([p.indices + o for p, o in zip(parts, off)]).astype(np.int32)
    return MeshPart(P, N, UV, I, parts[0].material)


def _stone_texture(size=128, seed=0, base=(0.45, 0.42, 0.38), var=0.12):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 1, (size // 8, size // 8))
    big = np.kron(noise, np.ones((8, 8)))
    fine = rng.normal(0, 0.3, (size, size))
    t = np.clip(np.asarray(base)[None, None] * (1 + var * (big + fine))[..., None], 0, 1)
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mortar = ((x % 32 < 2) | (y % 16 < 2)).astype(np.float32)[..., None]
    return (t * (1 - 0.4 * mortar)).astype(np.float32)


def materials():
    return [
        MaterialDesc(base_color=_stone_texture(128, 0, (0.42, 0.40, 0.37)),
                     orm_factor=(1.0, 0.8, 0.0)),                       # floor
        MaterialDesc(base_color=_stone_texture(128, 1, (0.48, 0.44, 0.38)),
                     orm_factor=(1.0, 0.85, 0.0)),                      # wall
        MaterialDesc(base_color=_stone_texture(128, 2, (0.55, 0.52, 0.48), 0.06),
                     orm_factor=(1.0, 0.6, 0.0)),                       # column
        MaterialDesc(base_color_factor=(0.85, 0.65, 0.25, 1.0),
                     orm_factor=(1.0, 0.25, 1.0)),                      # gold
        MaterialDesc(base_color_factor=(0.9, 0.4, 0.1, 1.0),
                     emissive_factor=(1.0, 0.45, 0.12),
                     orm_factor=(1.0, 0.8, 0.0)),                       # ember
        MaterialDesc(base_color=_stone_texture(128, 3, (0.38, 0.36, 0.34)),
                     orm_factor=(1.0, 0.9, 0.0)),                       # ceiling
    ]


def build_parts(detail=1.0):
    """list[MeshPart]; detail scales subdivision (tri count ~ detail^2)."""
    d = max(0.15, detail)

    def g(k):
        return max(1, int(round(k * d)))

    parts = []
    hall_w, hall_l, hall_h = 24.0, 56.0, 14.0

    parts.append(_grid_plane((0, 0, 0), (hall_w, hall_l), 2, 1, g(48), g(112), M_FLOOR, 12))
    # ceiling strips; every other strip is open to let the sun in
    strip_l = hall_l / 7
    for i in range(0, 7, 2):
        yc = -hall_l / 2 + (i + 0.5) * strip_l
        parts.append(_grid_plane((0, yc, hall_h), (hall_w, strip_l), 2, -1,
                                 g(24), g(12), M_CEIL, 4))

    parts.append(_grid_plane((-hall_w / 2, 0, hall_h / 2), (hall_h, hall_l), 0, 1,
                             g(16), g(64), M_WALL, 8))
    parts.append(_grid_plane((hall_w / 2, 0, hall_h / 2), (hall_h, hall_l), 0, -1,
                             g(16), g(64), M_WALL, 8))
    parts.append(_grid_plane((0, -hall_l / 2, hall_h / 2), (hall_w, hall_h), 1, 1,
                             g(24), g(16), M_WALL, 6))
    parts.append(_grid_plane((0, hall_l / 2, hall_h / 2), (hall_w, hall_h), 1, -1,
                             g(24), g(16), M_WALL, 6))

    # colonnades: 2 rows x 7 columns
    for side in (-1, 1):
        for i in range(7):
            y = -hall_l / 2 + (i + 1) * hall_l / 8
            x = side * hall_w * 0.3
            parts.append(_cylinder((x, y, 0.8), 0.9, hall_h - 2.4, g(24), g(12), M_COLUMN))
            parts.append(_box((x, y, 0.4), (2.4, 2.4, 0.8), M_COLUMN, g(3)))
            parts.append(_box((x, y, hall_h - 1.2), (2.6, 2.6, 0.8), M_GOLD, g(3)))
            parts.append(_box((x, y, hall_h * 0.45), (0.5, 0.5, 0.5), M_EMBER, g(2)))

    # altar at the far end, central fire pit
    parts.append(_box((0, hall_l / 2 - 6, 1.0), (6, 3, 2), M_COLUMN, g(6)))
    parts.append(_box((0, hall_l / 2 - 6, 2.6), (4, 2, 1.2), M_GOLD, g(4)))
    parts.append(_cylinder((0, 0, 0.0), 1.6, 1.0, g(20), g(3), M_COLUMN))
    parts.append(_box((0, 0, 1.15), (2.0, 2.0, 0.35), M_EMBER, g(3)))
    return parts


def camera_path(t, cfg=None):
    """Fly-through position + target at path time t in [0,1] (cfg is unused,
    kept for the signature)."""
    y = -24.0 + 44.0 * t
    x = 4.5 * np.sin(t * 2.6 * np.pi * 0.5)
    z = 2.2 + 0.7 * np.sin(t * 3.1)
    pos = np.array([x, y, z], np.float32)
    tgt = np.array([0.0, y + 10.0, 3.0 + 1.5 * np.sin(t * 2.0)], np.float32)
    return pos, tgt
