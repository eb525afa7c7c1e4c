"""Sun shadowing (counterpart of vulkan_pbr_renderer_tpu/shade/shadow.py):
the ortho sun matrix (render.cpp:959-971), the 4-tap rotated-grid PCF with
normal-offset bias (lighting_pass.glsl:592-608) and the light shafts
(lighting_pass.glsl:620-651): the polar-profile form and the per-step
march.

`shafts_polar` dispatches the polar shafts at the shaft grid: on a CUDA
tensor one launch of csrc/lighting.cu's shafts_polar_kernel (the profile
in bands of theta rows, then a thread per shaft pixel, each waiting on its
row's band), through a plan cached per shape; on a CPU
tensor `shafts_polar_plain`.  The helpers at the end
(`launch`, `noise_offset`, `_recip`) serve csrc/lighting.cu's
other wrappers too (shade/gi_modes.py, shade/lighting.py)."""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from ..gpu import cuda_build, sampling
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


def sun_visibility(sun_space_from_world, world_pos, normal, noise_1, noise_2, sun_u16,
                   normal_offset=0.1):
    """4-tap PCF sun visibility in [0,1] from the u16 sun map
    sun_u16 = sampling.quantize_u16(sun_depth) [S,S]."""
    px = 1.0 / sun_u16.shape[0]
    p = world_pos + normal * normal_offset
    sun_p = m3.transform_points(sun_space_from_world, p)[..., :3]
    uv = sun_p[..., :2] * 0.5 + 0.5
    ref = sun_p[..., 2]
    uv = uv + 2.0 * torch.stack([noise_2 - 0.5, noise_1 - 0.5], -1) * px  # glsl:600
    return sampling.sample_pcf4_u16(sun_u16, uv, ref, PCF_OFFSETS)


def polar_profile_plain(sun_depth, sun_space_from_world, camera_pos, n_theta=4096, n_r=48):
    """The per-frame polar shadow profile of light_shafts_polar: u16 [n_theta,
    n_r] (int16 bit patterns), the sun depth sampled bilinearly at the bin
    centers (j + 1.5)/16 on n_theta rays around the camera's sun-space xy."""
    two_pi = 2.0 * math.pi
    dev = sun_depth.device
    cam_sun = m3.transform_points(sun_space_from_world, camera_pos)[..., :3]
    theta = (torch.arange(n_theta, dtype=torch.float32, device=dev) + 0.5) * (two_pi / n_theta)
    rho = (torch.arange(n_r, dtype=torch.float32, device=dev) + 1.5) * (1.0 / 16.0)
    pxy = (cam_sun[:2]
           + torch.stack([m3.cpu_serial(torch.cos, theta), m3.cpu_serial(torch.sin, theta)],
                         -1)[:, None, :]
           * rho[None, :, None])                                  # [K,J,2]
    uv = pxy * 0.5 + 0.5
    prof = sampling.sample_bilinear(sun_depth[..., None], uv)[..., 0]
    return sampling.quantize_u16(prof)


def shafts_from_profile(prof_u16, sun_space_from_world, camera_pos, world_pos, normal,
                        noise_1, sun_emission, intensity=0.001, normal_offset=0.1,
                        max_steps=48):
    """light_shafts_polar's per-pixel part: one profile row fetched by the
    dithered angle, n_r compares, the bins weighted by arc-steps-per-bin
    dist/r_xy and truncated at max_steps."""
    two_pi = 2.0 * math.pi
    step_size = 1.0 / 16.0
    n_theta, n_r = prof_u16.shape
    cam_sun = m3.transform_points(sun_space_from_world, camera_pos)[..., :3]
    p_sun = m3.transform_points(sun_space_from_world,
                                world_pos + normal * normal_offset)[..., :3]
    delta = p_sun - cam_sun
    dist = torch.linalg.vector_norm(delta, dim=-1)
    r_xy = torch.linalg.vector_norm(delta[..., :2], dim=-1)
    rho = (torch.arange(n_r, dtype=torch.float32, device=world_pos.device) + 1.5) * step_size

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
    prof_u16 = polar_profile_plain(sun_depth, sun_space_from_world, camera_pos, n_theta, n_r)
    return shafts_from_profile(prof_u16, sun_space_from_world, camera_pos, world_pos, normal,
                               noise_1, sun_emission, intensity, normal_offset, max_steps)


def shafts_polar_plain(sun_depth, sun_space_from_world, camera_pos, normal, depth,
                       world_from_clip, view_from_clip, k, frame_idx_mod_59, sun_emission,
                       intensity=0.001, normal_offset=0.1, max_steps=48, n_theta=4096, n_r=48,
                       row_offset=0, full_height=None):
    """light_shafts_polar at the [::k, ::k] grid of the G-buffer (normal
    [H,W,3], depth [H,W]), each pixel's world position and noise recomputed
    at its subsampled centre (lighting.sub_grid_inputs)."""
    from .lighting import sub_grid_inputs

    n_s, _, pw_s, _, (noise_s, _, _) = sub_grid_inputs(
        normal, None, depth, world_from_clip, view_from_clip, k, frame_idx_mod_59,
        row_offset, full_height)
    return light_shafts_polar(sun_depth, sun_space_from_world, camera_pos, pw_s, n_s, noise_s,
                              sun_emission, intensity, normal_offset, max_steps, n_theta, n_r)


class _ShaftArgs(ctypes.Structure):
    """struct ShaftArgs of csrc/lighting.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "sun_depth", "sun_from_world", "camera_pos", "profile", "normal", "depth",
        "world_from_clip", "out", "flags")] + [("epoch", ctypes.c_uint)] + [
        (n, ctypes.c_float) for n in (
            "theta_step", "inv_two_pi", "inv_fw", "inv_fh", "noise_offset", "normal_offset",
            "step_limit")] + [("emission", ctypes.c_float * 3)] + [(n, ctypes.c_int) for n in (
                "s", "n_theta", "n_r", "max_steps", "w", "k", "row_offset", "rows", "cols")]


class _ShaftPlan(cuda_build.Epochs):
    """What a shafts launch of one shape keeps between frames: the launch's
    struct with every per-shape field set, the [n_theta, n_r] profile and
    the band flags it points into (zeroed once), the output's shape and the
    inputs' shapes, which each call's inputs are compared with (`accepts`);
    the launch's grid is sized by the library from the units.  A call sets
    the seven data pointers, the noise offset, the emission and the epoch,
    under the plan's lock.  A plan serves one stream, which orders its
    launches: two launches in flight at once would share the profile and
    the flags."""

    def __init__(self, device, s, h, w, k, n_theta, n_r, row_offset, fh, max_steps,
                 normal_offset):
        self.lock = threading.Lock()
        rows, cols = -(-h // k), -(-w // k)
        self.out_shape = (rows, cols, 3)
        self.shapes = ((s, s), (4, 4), (3,), (h, w, 3), (h, w), (4, 4))
        self.device = device.index
        self.profile = torch.empty((n_theta, n_r), dtype=torch.int16, device=device)
        self.args = _ShaftArgs(
            profile=self.profile.data_ptr(),
            theta_step=2.0 * math.pi / n_theta, inv_two_pi=_recip(2.0 * math.pi),
            inv_fw=_recip(cols * k), inv_fh=_recip(fh), normal_offset=normal_offset,
            step_limit=max_steps * (1.0 / 16.0), s=s, n_theta=n_theta, n_r=n_r,
            max_steps=max_steps, w=w, k=k, row_offset=row_offset, rows=rows, cols=cols)
        bands = library().shafts_polar_flags(ctypes.byref(self.args))
        self.flags = torch.zeros(bands, dtype=torch.int32, device=device)
        self.args.flags = self.flags.data_ptr()

    def accepts(self, ts):
        """Whether the kernel's inputs ts are float32, contiguous, on the
        plan's card and of its shapes."""
        return all(t.dtype == torch.float32 and t.is_cuda and t.get_device() == self.device
                   and t.shape == shape and t.is_contiguous()
                   for t, shape in zip(ts, self.shapes))


@functools.lru_cache(maxsize=16)
def _shaft_plan(device, stream, s, h, w, k, n_theta, n_r, row_offset, fh, max_steps,
                normal_offset):
    return _ShaftPlan(device, s, h, w, k, n_theta, n_r, row_offset, fh, max_steps,
                      normal_offset)


def _shaft_inputs(sun_depth, sun_space_from_world, camera_pos, normal, depth, world_from_clip,
                  view_from_clip):
    """The inputs checked (ValueError), the matrices and camera dense: the
    full checks, for the CPU and for a call the plan does not accept."""
    h, w = depth.shape
    dev = depth.device
    sun_space_from_world, world_from_clip, view_from_clip, camera_pos = (
        t.contiguous() for t in (sun_space_from_world, world_from_clip, view_from_clip,
                                 camera_pos))
    for t, what, shape in ((sun_depth, "sun_depth", None), (normal, "normal", (h, w, 3)),
                           (depth, "depth", (h, w)),
                           (sun_space_from_world, "sun_from_world", (4, 4)),
                           (world_from_clip, "world_from_clip", (4, 4)),
                           (view_from_clip, "view_from_clip", (4, 4)),
                           (camera_pos, "camera_pos", (3,))):
        cuda_build.need(t, what, "shafts_polar", dev, shape)
    if sun_depth.dim() != 2 or sun_depth.shape[0] != sun_depth.shape[1]:
        raise ValueError(f"shafts_polar: sun_depth must be [S, S], got {tuple(sun_depth.shape)}")
    return sun_space_from_world, camera_pos, world_from_clip, view_from_clip


def shafts_polar(sun_depth, sun_space_from_world, camera_pos, normal, depth, world_from_clip,
                 view_from_clip, k, frame_idx_mod_59, sun_emission, intensity=0.001,
                 normal_offset=0.1, max_steps=48, n_theta=4096, n_r=48, row_offset=0,
                 full_height=None):
    """shafts_polar_plain's shafts [ceil(H/k), ceil(W/k), 3].  sun_emission:
    the sun's f32 rgb, a host sequence (lighting.sun_emission).  A CUDA
    tensor launches csrc/lighting.cu's shafts_polar_kernel once (the
    [n_theta, n_r] profile in bands, then a thread per shaft pixel) through
    a plan cached per shape and stream (_ShaftPlan), or raises; a CPU
    tensor takes shafts_polar_plain.  On the card a call's inputs are
    compared with its plan's dtype, device, shapes and layout; the full
    checks (ValueError) run on the CPU and where that comparison fails.
    `shafts_polar.launches` counts launches, one per call."""
    h, w = depth.shape
    dev = depth.device
    fh = full_height or h
    if not depth.is_cuda:
        sfw, cam, wfc, vfc = _shaft_inputs(sun_depth, sun_space_from_world, camera_pos, normal,
                                           depth, world_from_clip, view_from_clip)
        return shafts_polar_plain(sun_depth, sfw, cam, normal, depth, wfc, vfc, k,
                                  frame_idx_mod_59, torch.as_tensor(
                                      np.asarray(sun_emission, np.float32), device=dev),
                                  intensity, normal_offset, max_steps, n_theta, n_r, row_offset,
                                  fh)
    if not torch.is_tensor(sun_depth) or sun_depth.dim() != 2:
        _shaft_inputs(sun_depth, sun_space_from_world, camera_pos, normal, depth,
                      world_from_clip, view_from_clip)   # raises
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = _shaft_plan(dev, stream, sun_depth.shape[0], h, w, k, n_theta, n_r, row_offset, fh,
                       max_steps, normal_offset)
    ts = (sun_depth, sun_space_from_world, camera_pos, normal, depth, world_from_clip)
    if not plan.accepts(ts):
        sfw, cam, wfc, _ = _shaft_inputs(*ts, view_from_clip)
        ts = (sun_depth, sfw, cam, normal, depth, wfc)
    em = np.float32(intensity) * np.asarray(sun_emission, np.float32)
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=dev)
    with plan.lock:
        args = plan.args
        (args.sun_depth, args.sun_from_world, args.camera_pos, args.normal, args.depth,
         args.world_from_clip) = (t.data_ptr() for t in ts)
        args.out = out.data_ptr()
        args.noise_offset = noise_offset(frame_idx_mod_59)
        args.emission[:] = em.tolist()
        args.epoch = plan.next_epoch()
        err = _shafts_launcher()(ctypes.byref(args), plan.device, stream)
    if err != 0:
        raise RuntimeError(f"shafts_polar_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(library(), err)})")
    shafts_polar.launches += 1
    return out


shafts_polar.launches = 0


@functools.cache
def _shafts_launcher():
    """csrc/lighting.cu's shafts_polar_launch(args, device, stream)."""
    fn = library().shafts_polar_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shafts_occupancy():
    """{registers, local_bytes, shared_bytes, blocks_per_sm} of the built
    shafts kernel on the current card."""
    return cuda_build.query_ints(library(), "shafts_occupancy", (
        "registers", "local_bytes", "shared_bytes", "blocks_per_sm"))


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


# ---------------------------------------------------------------------------
# csrc/lighting.cu's launches (shared with shade/gi_modes.py and
# shade/lighting.py)


def _recip(x):
    """The f32 reciprocal of a Python number, as PyTorch on the card divides
    a tensor by it."""
    return float(np.float32(1.0) / np.float32(x))


def noise_offset(frame_idx_mod_59):
    """utils/noise.py frame_noise's per-frame offset, f32(1000 phi) * f32(f59)."""
    return float(np.float32(1000.0 * 1.61803398875) * np.float32(frame_idx_mod_59))


def launch(name, args, device):
    """Call csrc/lighting.cu's launcher `name` on the current stream; raise
    on a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} "
                           f"({cuda_build.error_string(lib, err)})")


def library():
    """The built lighting library (csrc/lighting.cu)."""
    lib = cuda_build.load_library("lighting")
    lib.shade_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.shade_launch.restype = ctypes.c_int
    lib.gi_inputs_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.gi_inputs_launch.restype = ctypes.c_int
    lib.shafts_polar_flags.argtypes = [ctypes.c_void_p]
    lib.shafts_polar_flags.restype = ctypes.c_int
    return lib
