"""Sun shadowing (counterpart of vulkan_pbr_renderer_tpu/shade/shadow.py):
the ortho sun matrix (render.cpp:959-971), the 4-tap rotated-grid PCF with
normal-offset bias (lighting_pass.glsl:592-608) and the light shafts
(lighting_pass.glsl:620-651): the polar-profile form and the per-step
march."""

from __future__ import annotations

import math

import torch

from ..gpu import sampling
from ..utils import math3d as m3

# rotated-grid PCF offsets in shadow-map texels (lighting_pass.glsl:604-608)
PCF_OFFSETS = (
    (0.75, 0.25),
    (-0.25, 0.75),
    (0.25, -0.75),
    (-0.75, -0.25),
)


def sun_matrices(sun_angle_x_deg, sun_angle_y_deg, half_size=40.0):
    """(sun_space_from_world [4,4], sun_dir [3]) on the host, per
    render.cpp:962-970: sun_ori = Rotate_RH(angle.x, axis=(cos y, sin y, 0)),
    sun_space = ortho(-h..h)^3 @ inv(sun_ori), sun_dir = sun_ori @ (0,0,-1)."""
    ax = torch.deg2rad(torch.tensor(sun_angle_x_deg, dtype=torch.float32))
    ay = torch.deg2rad(torch.tensor(sun_angle_y_deg, dtype=torch.float32))
    axis = torch.stack([torch.cos(ay), torch.sin(ay), torch.zeros_like(ay)])
    sun_ori = m3.rotate_rh(ax, axis)
    ortho = m3.orthographic_rh_zo(-half_size, half_size, -half_size, half_size,
                                  -half_size, half_size)
    sun_space_from_world = ortho @ m3.inverse(sun_ori)
    sun_dir = m3.transform_dirs(sun_ori, torch.tensor([0.0, 0.0, -1.0]))
    return sun_space_from_world, sun_dir


def sun_visibility(sun_space_from_world, world_pos, normal, noise_1, noise_2,
                   wdepth, base_size, normal_offset=0.1):
    """4-tap PCF sun visibility in [0,1] from the split 4x4 u16 window pack
    wdepth = sampling.pack_depth_window_u16_4x4_split(sun_depth)."""
    px = 1.0 / base_size
    p = world_pos + normal * normal_offset
    sun_p = m3.transform_points(sun_space_from_world, p)[..., :3]
    uv = sun_p[..., :2] * 0.5 + 0.5
    ref = sun_p[..., 2]
    uv = uv + 2.0 * torch.stack([noise_2 - 0.5, noise_1 - 0.5], -1) * px  # glsl:600
    return sampling.sample_pcf4_window_split(wdepth[0], wdepth[1], base_size,
                                             uv, ref, PCF_OFFSETS)


def light_shafts_polar(sun_depth, sun_space_from_world, camera_pos, world_pos,
                       normal, noise_1, sun_emission, intensity=0.001,
                       normal_offset=0.1, max_steps=48, n_theta=4096, n_r=48):
    """Volumetric shaft march through a polar shadow profile.

    Every pixel's march starts at the camera, so all march samples lie on a
    polar bundle around the camera's sun-space xy: the shadow depth is
    tabulated once per frame on that grid D[theta, rho] (u16-quantized), and
    each pixel reads one [n_r] row and compares on it.  Radial bin = 1/16 sun
    NDC (the reference march step), bins weighted by arc-steps-per-bin
    dist/r_xy, truncated at max_steps like the bounded march."""
    two_pi = 2.0 * math.pi
    step_size = 1.0 / 16.0
    dev = world_pos.device
    cam_sun = m3.transform_points(sun_space_from_world, camera_pos)[..., :3]
    p_sun = m3.transform_points(sun_space_from_world,
                                world_pos + normal * normal_offset)[..., :3]
    delta = p_sun - cam_sun
    dist = torch.linalg.vector_norm(delta, dim=-1)
    r_xy = torch.linalg.vector_norm(delta[..., :2], dim=-1)

    # per-frame polar profile; bin centers (j + 1.5)*dr
    dr = step_size
    theta = (torch.arange(n_theta, dtype=torch.float32, device=dev) + 0.5) * (two_pi / n_theta)
    rho = (torch.arange(n_r, dtype=torch.float32, device=dev) + 1.5) * dr
    pxy = (cam_sun[:2]
           + torch.stack([torch.cos(theta), torch.sin(theta)], -1)[:, None, :]
           * rho[None, :, None])                                  # [K,J,2]
    uv = pxy * 0.5 + 0.5
    prof = sampling.sample_bilinear(sun_depth[..., None], uv)[..., 0]
    prof_u16 = sampling.quantize_u16(prof)

    # per pixel: one row fetch + n_r compares
    ang = torch.atan2(delta[..., 1], delta[..., 0])
    kf = ang / two_pi * n_theta + (noise_1 - 0.5)                 # theta dither
    k = torch.remainder(torch.round(kf).to(torch.int32), n_theta)
    row = sampling.dequant_u16(sampling.take_rows(prof_u16, k))

    s = dist / torch.clamp(r_xy, min=1e-6)                        # arc-steps per bin
    z_j = cam_sun[2] + rho * (delta[..., 2:3] / torch.clamp(r_xy[..., None], min=1e-6))
    vis = (z_j < row).to(torch.float32)
    active = (rho <= r_xy[..., None]) & (rho * s[..., None] <= max_steps * step_size)
    acc = torch.sum(torch.where(active, vis, 0.0), dim=-1) * s
    acc = torch.clamp(acc, max=float(max_steps))
    return acc[..., None] * (intensity * sun_emission)


def light_shafts(sun_depth, sun_space_from_world, camera_pos, world_pos, normal,
                 noise_1, sun_emission, intensity=0.001, normal_offset=0.1,
                 max_steps=48, wdepth=None):
    """The reference's volumetric shaft march (lighting_pass.glsl:620-651):
    from the camera to the surface point in shadow-map space, absolute step
    1/16 starting at (noise + 1)/16, summing one bilinear shadow compare per
    step while the travelled distance stays within the segment; the
    while(true) is bounded by max_steps.  The positions are affine in the
    step index, so every step is evaluated at once.  wdepth: the 2x2 u16
    window pack (sampling.pack_depth_window_u16) of sun_depth."""
    cam_sun = m3.transform_points(sun_space_from_world, camera_pos)[..., :3]
    p_sun = m3.transform_points(sun_space_from_world,
                                world_pos + normal * normal_offset)[..., :3]
    delta = p_sun - cam_sun
    dist = torch.linalg.vector_norm(delta, dim=-1)
    step_size = 1.0 / 16.0
    step = step_size * delta / torch.clamp(dist, min=1e-8)[..., None]
    if wdepth is None:
        wdepth = sampling.pack_depth_window_u16(sun_depth)
    i = torch.arange(1, max_steps + 1, dtype=torch.float32, device=world_pos.device)
    t = noise_1[..., None] + i                                   # [..., S]
    pos = cam_sun + step[..., None, :] * t[..., None]
    active = step_size * t <= dist[..., None]
    vis = sampling.sample_depth_compare_window(wdepth, sun_depth.shape[0],
                                               pos[..., :2] * 0.5 + 0.5, pos[..., 2])
    acc = torch.sum(torch.where(active, vis, 0.0), dim=-1)
    return acc[..., None] * (intensity * sun_emission)
