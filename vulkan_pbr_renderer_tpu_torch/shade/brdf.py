"""BRDF terms (counterpart of vulkan_pbr_renderer_tpu/shade/brdf.py,
lighting_pass.glsl:21-117).  Elementwise tensor math; scalars broadcast."""

from __future__ import annotations

import torch

from ..utils import math3d as m3

PI = 3.14159265358979323846


def distribution_ggx(n_dot_h, roughness):
    """GGX NDF with alpha = roughness^2 (lighting_pass.glsl:21-31)."""
    a = roughness * roughness
    a2 = a * a
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * d * d)


def distribution_beckmann(n_dot_h, m):
    """Beckmann NDF (lighting_pass.glsl:108-113); m is the rms slope."""
    m2 = m * m
    nh = torch.clamp(n_dot_h, 1e-4, 1.0)
    nh2 = nh * nh
    tan2 = (1.0 - nh2) / nh2
    return m3.cpu_serial(torch.exp, -tan2 / m2) / (PI * m2 * nh2 * nh2)


def geometry_mikkelsen(n_dot_h, v_dot_n, l_dot_n, v_dot_h):
    """Cook-Torrance geometric attenuation (glsl:72-74)."""
    vh = torch.clamp(v_dot_h, min=1e-6)
    return torch.clamp(
        torch.minimum(2.0 * n_dot_h * v_dot_n / vh, 2.0 * n_dot_h * l_dot_n / vh),
        max=1.0)


def fresnel_schlick(cos_theta, f0):
    """Schlick Fresnel (glsl:76-79); f0 broadcasts against cos_theta[...,None]."""
    c = torch.clamp(cos_theta, 0.0, 1.0)
    if f0.ndim > c.ndim:
        c = c[..., None]
    return f0 + (1.0 - f0) * torch.pow(1.0 - c, 5.0)


def f0_from_metallic(base_color, metallic, f0_dielectric=0.04):
    """F0 = mix(0.04, albedo, metallic) (lighting_pass.glsl:657-658)."""
    m = metallic[..., None] if metallic.ndim < base_color.ndim else metallic
    return f0_dielectric * (1.0 - m) + base_color * m


def cook_torrance_direct(n, v, l, base_color, roughness, metallic, f0_dielectric=0.04):
    """Direct-light Cook-Torrance as the sun term (glsl:655-679): D = GGX,
    G = Mikkelsen, F = Schlick(VdotH), kD from Fresnel(NdotV); returns
    [...,3] BRDF*NdotL (no light color)."""
    h_un = l + v
    h = h_un / torch.clamp(torch.linalg.vector_norm(h_un, dim=-1, keepdim=True), min=1e-8)
    n_dot_l = torch.clamp(torch.sum(n * l, -1), min=0.0)
    v_dot_n = torch.clamp(torch.sum(n * v, -1), min=0.0)
    v_dot_h = torch.clamp(torch.sum(v * h, -1), min=0.0)
    n_dot_h = torch.clamp(torch.sum(n * h, -1), min=0.0)

    f0 = f0_from_metallic(base_color, metallic, f0_dielectric)
    d = distribution_ggx(n_dot_h, roughness)
    g = geometry_mikkelsen(n_dot_h, v_dot_n, n_dot_l, v_dot_h)
    f = fresnel_schlick(v_dot_h, f0)
    spec = f * (g * d / torch.clamp(4.0 * n_dot_l * v_dot_n, min=1e-4))[..., None]

    ks = fresnel_schlick(v_dot_n, f0)
    kd = (1.0 - ks) * (1.0 - metallic[..., None])
    out = kd * base_color / PI + spec
    return torch.where(n_dot_l[..., None] > 0.0, out * n_dot_l[..., None], 0.0)
