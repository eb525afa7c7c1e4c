"""Procedural geometry, textures and the sky cubemap (numpy copy of
vulkan_pbr_renderer_tpu/assets/procedural.py, which cannot be imported
without importing jax).  Builders return
host-side numpy MeshParts; build_scene() turns them into device tensors.
"""

from __future__ import annotations

import numpy as np

from .scene import MeshPart


def make_cube(center=(0, 0, 0), size=(1, 1, 1), material=0):
    """Axis-aligned cube, 12 tris, outward winding."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) * 0.5
    faces = [
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((-1, 0, 0), (0, -1, 0), (0, 0, 1)),
        ((0, 1, 0), (-1, 0, 0), (0, 0, 1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
    ]
    P, N, UV, I = [], [], [], []
    for n, ua, va in faces:
        n = np.asarray(n, np.float32)
        ua = np.asarray(ua, np.float32)
        va = np.asarray(va, np.float32)
        base = len(P)
        for (u, v) in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            P.append(c + (n + ua * u + va * v) * s)
            N.append(n)
            UV.append(((u + 1) / 2, (v + 1) / 2))
        I += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return MeshPart(np.asarray(P, np.float32), np.asarray(N, np.float32),
                    np.asarray(UV, np.float32), np.asarray(I, np.int32), material)


def make_plane(center=(0, 0, 0), size=(10, 10), normal_axis=2, material=0, uv_scale=1.0):
    c = np.asarray(center, np.float32)
    ua, va = [a for a in (0, 1, 2) if a != normal_axis]
    n = np.zeros(3, np.float32)
    n[normal_axis] = 1.0
    P, N, UV = [], [], []
    for (u, v) in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
        p = c.copy()
        p[ua] += u * size[0] / 2
        p[va] += v * size[1] / 2
        P.append(p)
        N.append(n)
        UV.append(((u + 1) / 2 * uv_scale, (v + 1) / 2 * uv_scale))
    I = [[0, 1, 2], [0, 2, 3]]
    return MeshPart(np.asarray(P, np.float32), np.asarray(N, np.float32),
                    np.asarray(UV, np.float32), np.asarray(I, np.int32), material)


def make_uv_sphere(center=(0, 0, 0), radius=1.0, lat=16, lon=32, material=0):
    c = np.asarray(center, np.float32)
    P, N, UV, I = [], [], [], []
    for i in range(lat + 1):
        theta = np.pi * i / lat
        for j in range(lon + 1):
            phi = 2 * np.pi * j / lon
            n = np.array(
                [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)],
                np.float32,
            )
            P.append(c + n * radius)
            N.append(n)
            UV.append((j / lon, i / lat))
    for i in range(lat):
        for j in range(lon):
            a = i * (lon + 1) + j
            b = a + lon + 1
            I += [[a, b, a + 1], [a + 1, b, b + 1]]
    return MeshPart(np.asarray(P, np.float32), np.asarray(N, np.float32),
                    np.asarray(UV, np.float32), np.asarray(I, np.int32), material)


def checker_texture(size=64, squares=8, c0=(1, 1, 1), c1=(0.2, 0.2, 0.2)):
    """[size,size,3] two-colour checkerboard of squares x squares cells."""
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    sq = size // squares
    mask = (((x // sq) + (y // sq)) % 2).astype(np.float32)[..., None]
    c0 = np.asarray(c0, np.float32)
    c1 = np.asarray(c1, np.float32)
    return c0 * (1 - mask) + c1 * mask


def bump_normal_texture(size=64, freq=4, amp=0.3):
    """Sinusoidal tangent-space normal map, xy encoded in [0,1]."""
    y, x = np.meshgrid(np.arange(size) / size, np.arange(size) / size, indexing="ij")
    dx = amp * np.cos(2 * np.pi * freq * x) * 2 * np.pi * freq / size * size * 0.05
    dy = amp * np.cos(2 * np.pi * freq * y) * 2 * np.pi * freq / size * size * 0.05
    n = np.stack([-dx, -dy, np.ones_like(dx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n[..., :2] * 0.5 + 0.5).astype(np.float32)


def make_sky_cubemap(size=128, sun_dir=(0.3, 0.2, -0.9), ground=(0.25, 0.22, 0.2),
                     horizon=(0.85, 0.9, 1.0), zenith=(0.25, 0.45, 0.95),
                     sun_intensity=30.0):
    """Procedural HDR sky env cubemap [6,S,S,3] (stand-in for the reference's
    HDR environment).  sun_dir points FROM the sun."""
    sd = np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    uv1 = (np.arange(size) + 0.5) / size
    u, v = np.meshgrid(uv1, uv1, indexing="xy")
    sc = 2.0 * (u - 0.5)
    tc = 2.0 * (v - 0.5)
    one = np.ones_like(sc)
    face_dirs = [
        np.stack([one, -tc, -sc], -1), np.stack([-one, -tc, sc], -1),
        np.stack([sc, one, tc], -1), np.stack([sc, -one, -tc], -1),
        np.stack([sc, -tc, one], -1), np.stack([-sc, -tc, -one], -1),
    ]
    faces = []
    for d in face_dirs:
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        up = np.clip(d[..., 2], -1, 1)
        sky = np.where(
            (up >= 0)[..., None],
            np.asarray(horizon)
            + (np.asarray(zenith) - np.asarray(horizon)) * (np.maximum(up[..., None], 0.0) ** 0.7),
            np.asarray(horizon) + (np.asarray(ground) - np.asarray(horizon)) * np.minimum(1, -up[..., None] * 4),
        )
        cos_sun = -(d @ sd)
        disk = np.exp((cos_sun - 1.0) * 4000.0) * sun_intensity
        sky = sky + disk[..., None] * np.array([1.0, 0.9, 0.7])
        faces.append(sky.astype(np.float32))
    return np.stack(faces)


def transform_part(part: MeshPart, matrix: np.ndarray) -> MeshPart:
    """Apply a rigid [4,4] transform to a host-side part."""
    p = part.positions @ matrix[:3, :3].T + matrix[:3, 3]
    n = part.normals @ np.linalg.inv(matrix[:3, :3])  # inverse-transpose
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return MeshPart(p.astype(np.float32), n.astype(np.float32), part.uvs, part.indices, part.material)
