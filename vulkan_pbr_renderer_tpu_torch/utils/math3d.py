"""3D math helpers (counterpart of vulkan_pbr_renderer_tpu/utils/math3d.py).

Same conventions as the reference package: right-handed Z-up world, view
space +X right / +Y down / +Z forward, LH_ZO perspective with depth in
[0, 1], [4,4] row-major matrices applied to column vectors (batched points
are transformed as pts @ M.T).  Camera and projection builders return
float32 CPU tensors (host-side, per frame); the batched helpers run on
their inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    """float32 CPU tensor from a tensor, array or tuple."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def sqrt(x):
    """torch.sqrt(x), the same bits on any number of CPU threads.  On the
    CPU torch.sqrt runs MKL's vector math, whose first call in a process,
    made from several threads at once, has returned one thread's chunk at
    ~12-bit accuracy (cpu_threads_probe.py); numpy's sqrt there is the
    hardware's, correctly rounded.  On the card it is torch.sqrt, whose
    bits the kernels mirror."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    out = torch.empty_like(x)
    np.sqrt(x.numpy(), out=out.numpy())
    return out


# PyTorch splits its CPU vector-math functions (exp, log, log2, sin, cos,
# arccos, ...) across threads in pieces of at least this many values
CPU_GRAIN = 2048


def cpu_serial(fn, x):
    """fn(x) for one of PyTorch's vector-math functions (torch.exp,
    torch.log2, torch.sin, torch.cos, torch.arccos), the same bits on any
    number of CPU threads.  On the CPU these run MKL's vector math, whose
    first call from several threads at once has returned one thread's chunk
    at ~12-bit accuracy (cpu_threads_probe.py); here the CPU takes the
    values in pieces of CPU_GRAIN, which PyTorch never splits, so each comes
    out as a one-thread call gives it.  On the card it is fn(x)."""
    if x.device.type != "cpu" or x.numel() <= CPU_GRAIN:
        return fn(x)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    for i in range(0, flat.numel(), CPU_GRAIN):
        fn(flat[i:i + CPU_GRAIN], out=out[i:i + CPU_GRAIN])
    return out.view(x.shape)


def normalize(v, dim=-1, eps=1e-12):
    """Unit-length vector; safe for zero vectors."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def dot(a, b, dim=-1, keepdim=False):
    return torch.sum(a * b, dim=dim, keepdim=keepdim)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n, keepdim=True) * n


def mix(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def rotate_about_axis(v, n, theta):
    """Rotate v about unit axis n by angle theta (Rodrigues,
    lighting_pass.glsl:98-101).  theta broadcasts with trailing dim 1."""
    c = cpu_serial(torch.cos, theta)
    s = cpu_serial(torch.sin, theta)
    d = dot(v, n, keepdim=True)
    return c * (v - d * n) + s * cross(n, v) + d * n


# Quaternions are stored as (x, y, z, w), matching HandmadeMath.


def quat_identity():
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)


def quat_from_axis_angle(axis, angle):
    """Right-handed rotation of `angle` radians about unit `axis` (x,y,z,w)."""
    half = angle * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half).reshape(1)])


def quat_mul(q1, q2):
    """Hamilton product q1*q2 (apply q2's rotation first, then q1's)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)


def quat_slerp(a, b, t):
    """Spherical lerp used by the reference's lazy camera (camera.h:96)."""
    cos_th = torch.sum(a * b, dim=-1)
    b = torch.where(cos_th < 0, -b, b)
    cos_th = torch.abs(cos_th)
    # lerp for nearly-parallel quats
    theta = cpu_serial(torch.arccos, torch.clamp(cos_th, -1.0, 1.0))
    sin_th = cpu_serial(torch.sin, theta)
    use_lerp = sin_th < 1e-5
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    den = torch.clamp(sin_th, min=1e-12)
    w_a = torch.where(use_lerp, 1.0 - t, cpu_serial(torch.sin, (1.0 - t) * theta) / den)
    w_b = torch.where(use_lerp, t, cpu_serial(torch.sin, t * theta) / den)
    return quat_normalize(w_a[..., None] * a + w_b[..., None] * b)


def quat_to_mat4(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy), zero,
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx), zero,
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy), zero,
            zero, zero, zero, one,
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (4, 4))


def mat4_identity():
    return torch.eye(4, dtype=torch.float32)


def translate(v):
    m = torch.eye(4, dtype=torch.float32)
    m[:3, 3] = _t(v)
    return m


def scale(v):
    return torch.diag(torch.cat([_t(v), torch.ones(1, dtype=torch.float32)]))


def rotate_rh(angle, axis):
    """Rotation matrix about `axis` by `angle` rad, right-handed
    (HMM_Rotate_RH, render.cpp:966)."""
    return quat_to_mat4(quat_from_axis_angle(normalize(axis), angle))


def perspective_lh_zo(fov_y_rad, aspect_x_over_y, z_near, z_far):
    """HMM_Perspective_LH_ZO (camera.h:112): w = +z_view, depth in [0,1]."""
    f = 1.0 / np.tan(fov_y_rad / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect_x_over_y
    m[1, 1] = f
    m[2, 2] = z_far / (z_far - z_near)
    m[2, 3] = -z_far * z_near / (z_far - z_near)
    m[3, 2] = 1.0
    return torch.from_numpy(m)


def orthographic_rh_zo(left, right, bottom, top, near, far):
    """HMM_Orthographic_RH_ZO (render.cpp:969), depth in [0,1]."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    m[3, 3] = 1.0
    return torch.from_numpy(m)


def look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """view_from_world for +X right, +Y DOWN, +Z forward (common.h:6)."""
    eye = _t(eye)
    f = normalize(_t(target) - eye)
    r = normalize(cross(f, _t(up)))
    d = cross(f, r)
    rot = torch.stack([r, d, f])
    m = torch.eye(4, dtype=torch.float32)
    m[:3, :3] = rot
    m[:3, 3] = -(rot @ eye)
    return m


def inverse(m):
    return torch.linalg.inv(m)


def transform_points(m, pts):
    """Apply a [4,4] matrix to [..., 3] points (w=1). Returns [..., 4].

    Written as products and a pairwise sum, (x*m0 + y*m1) + (z*m2 + m3) —
    the order the JAX package's f32 dot takes on the CPU — not as a matmul:
    unprojecting depth near the far plane cancels catastrophically, so a
    different summation order moves reconstructed positions visibly (and
    would flip shadow-map compares)."""
    x, y, z = pts[..., 0:1], pts[..., 1:2], pts[..., 2:3]
    return (x * m[:, 0] + y * m[:, 1]) + (z * m[:, 2] + m[:, 3])


def transform_dirs(m, dirs):
    """Apply a [4,4] matrix to [..., 3] directions (w=0). Returns [..., 3]."""
    return dirs @ m[:3, :3].T


def project_points(m, pts):
    """Transform [...,3] points and perspective-divide -> ([...,3] ndc, w)."""
    clip = transform_points(m, pts)
    w = clip[..., 3:4]
    return clip[..., :3] / w, w[..., 0]
