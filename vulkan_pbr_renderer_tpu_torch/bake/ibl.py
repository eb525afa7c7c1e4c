"""One-time IBL precompute (counterpart of vulkan_pbr_renderer_tpu/bake/ibl.py):
the diffuse irradiance map, the prefiltered specular environment and the
split-sum BRDF LUT.

All use the reference's golden-spiral hemisphere point set
(gen_irradiance_map.glsl:84-92).  Sample loops run in chunks so memory stays
bounded; each chunk's samples are summed and added to the running total in
the order of the reference package.  The frame does not use the irradiance
map (the reference leaves it unused too, lighting_pass.glsl:689-691), so the
Renderer does not bake it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..gpu import sampling
from ..shade import brdf
from ..utils import math3d as m3

SOME_VECTOR = (12.123825810901, 6.11831989512, -5.12039214121)
PI = np.pi
# the hardcoded per-mip roughness table (gen_prefiltered_env_map.glsl:117)
PREFILTER_ROUGHNESS = (0.0, 0.03, 0.15, 0.4, 0.6)


def golden_spiral(n, device):
    """(pitch, yaw) f32 tensors of the reference's hemisphere point set."""
    i = np.arange(n, dtype=np.float64)
    pitch = PI - np.arccos(np.clip(i / n - 1.0, -1.0, 1.0))
    yaw = 2.0 * PI * (i / 1.61803398875)
    return (torch.as_tensor(pitch.astype(np.float32), device=device),
            torch.as_tensor(yaw.astype(np.float32), device=device))


def _face_dirs(size, device):
    """[6,S,S,3] unit directions at cubemap texel centers."""
    uv1 = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    v, u = torch.meshgrid(uv1, uv1, indexing="ij")
    uvg = torch.stack([u, v], -1)
    return torch.stack([
        sampling.cubemap_dir_from_face_uv(
            torch.full((size, size), f, dtype=torch.int32, device=device), uvg)
        for f in range(6)])


def _hemisphere_dir(n, tangent, pitch, yaw):
    """Rotate(Rotate(N, tangent, pitch), N, yaw), batched over a leading
    sample axis of pitch / yaw [K,1,1,1,1]."""
    d = m3.rotate_about_axis(n, tangent, pitch)
    return m3.rotate_about_axis(d, n, yaw)


def bake_irradiance(env_cube_atlas, env_base_size, size=32, samples=1024, chunk=64,
                    device="cuda"):
    """Diffuse irradiance cubemap (gen_irradiance_map.glsl:73-101): mean of
    cos(pitch)-weighted env samples at LOD 6, on `device` (the card unless
    the caller asks for the CPU; raises without one).  Returns [6,S,S,3]."""
    dev = resolve_device(device)
    env = torch.as_tensor(env_cube_atlas, dtype=torch.float32, device=dev)
    chunk = min(chunk, samples)
    n = _face_dirs(size, dev)
    tangent = m3.normalize(m3.cross(n, torch.tensor(SOME_VECTOR, device=dev)))
    pitches, yaws = golden_spiral(samples, dev)
    acc = torch.zeros((6, size, size, 3), dtype=torch.float32, device=dev)
    for i0 in range(0, samples, chunk):
        pk = pitches[i0:i0 + chunk].reshape(-1, 1, 1, 1, 1)
        yk = yaws[i0:i0 + chunk].reshape(-1, 1, 1, 1, 1)
        d = _hemisphere_dir(n, tangent, pk, yk)
        val = sampling.sample_cubemap_lod(
            env, env_base_size, d, torch.full(d.shape[:-1], 6.0, device=dev))
        acc = acc + torch.sum(m3.cpu_serial(torch.cos, pk) * val[..., :3], dim=0)
    return acc / samples


def bake_prefiltered_env(env_cube_atlas, env_base_size, size=256, min_size=16,
                         samples=8192, chunk=64):
    """Specular prefiltered env mips (gen_prefiltered_env_map.glsl:103-151).

    mip 0: env lookup at LOD 1; mips 1..4 down to min_size: Beckmann-weighted
    golden-spiral convolution at env LOD 3+mip, divided by pi; smaller mips
    box-filtered from the last baked level.  Returns the cube mip atlas
    [6,S,Wa,3]."""
    dev = env_cube_atlas.device
    chunk = min(chunk, samples)
    levels = []
    mip, s = 0, size
    while s >= 1:
        if mip == 0:
            d = _face_dirs(s, dev)
            lv = sampling.sample_cubemap_lod(
                env_cube_atlas, env_base_size, d, torch.ones(d.shape[:-1], device=dev)
            )[..., :3]
        elif s >= min_size and mip < len(PREFILTER_ROUGHNESS):
            r = _face_dirs(s, dev)
            tangent = m3.normalize(m3.cross(r, torch.tensor(SOME_VECTOR, device=dev)))
            rough = PREFILTER_ROUGHNESS[mip]
            pitches, yaws = golden_spiral(samples, dev)
            dw = 2.0 * PI / samples
            acc = torch.zeros((6, s, s, 3), dtype=torch.float32, device=dev)
            for i0 in range(0, samples, chunk):
                pk = pitches[i0:i0 + chunk].reshape(-1, 1, 1, 1, 1)
                yk = yaws[i0:i0 + chunk].reshape(-1, 1, 1, 1, 1)
                l = _hemisphere_dir(r, tangent, pk, yk)
                rad = sampling.sample_cubemap_lod(
                    env_cube_atlas, env_base_size, l,
                    torch.full(l.shape[:-1], 3.0 + mip, device=dev))[..., :3]
                d_w = brdf.distribution_beckmann(m3.cpu_serial(torch.cos, pk * 0.5), rough)
                acc = acc + torch.sum(d_w * rad * m3.cpu_serial(torch.cos, pk) * dw, dim=0)
            lv = acc / PI
        else:
            lv = sampling.downsample2x(levels[-1])
        levels.append(lv)
        s //= 2
        mip += 1
    return sampling.pack_mip_atlas(levels)


def bake_brdf_lut(size=256, samples=4096, chunk=256, device="cuda"):
    """Split-sum BRDF LUT (gen_brdf_integration_map.glsl:142-210): [S,S,2]
    (scale, bias) over NdotV (width) x roughness (height), D_Beckmann *
    G_Mikkelsen weighted, on `device` (the card unless the caller asks for
    the CPU; raises without one)."""
    device = resolve_device(device)
    chunk = min(chunk, samples)
    uv1 = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    n_dot_v = uv1[None, :].expand(size, size)
    roughness = uv1[:, None].expand(size, size)
    sin_v = m3.sqrt(torch.clamp(1.0 - n_dot_v ** 2, 0.0, 1.0))
    v = torch.stack([torch.zeros_like(n_dot_v), -sin_v, n_dot_v], -1)

    pitches, yaws = golden_spiral(samples, device)
    dw = 2.0 * PI / samples
    scale = torch.zeros((size, size), dtype=torch.float32, device=device)
    bias = torch.zeros_like(scale)
    for i0 in range(0, samples, chunk):
        pk = pitches[i0:i0 + chunk].reshape(-1, 1, 1)
        yk = yaws[i0:i0 + chunk].reshape(-1, 1, 1)
        # L = Rotate(Rotate(N=(0,0,1), x-axis, pitch), N, yaw)
        sp, cp = m3.cpu_serial(torch.sin, pk), m3.cpu_serial(torch.cos, pk)
        cy, sy = m3.cpu_serial(torch.cos, yk), m3.cpu_serial(torch.sin, yk)
        zero = torch.zeros_like(pk)
        l = torch.stack([cy * zero - sy * (-sp), sy * zero + cy * (-sp), cp], -1)
        l = l.expand(-1, size, size, 3)
        h = m3.normalize(l + v)
        n_dot_l = l[..., 2]
        n_dot_h = h[..., 2]
        v_dot_h = torch.sum(v * h, -1)
        d = brdf.distribution_beckmann(n_dot_h, roughness)
        g = brdf.geometry_mikkelsen(n_dot_h, n_dot_v, n_dot_l, v_dot_h)
        fc = torch.pow(torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5.0)
        common = d * g * dw / (4.0 * torch.clamp(n_dot_v, min=1e-4))
        scale = scale + torch.sum(common * (1.0 - fc), 0)
        bias = bias + torch.sum(common * fc, 0)
    return torch.stack([scale, bias], -1)
