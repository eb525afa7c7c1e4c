"""GI dispatch (counterpart of vulkan_pbr_renderer_tpu/shade/gi_modes.py),
one function per GI mode:
  * fast_march_gi: the reference-structured fog march
    (gi.sample_radiance_fog) with the bounded linear screen trace
    (gi.screen_trace_linear) as its screen term, one gi.fast_ray_resolve
    call per ray (one CUDA kernel launch on the card) — the default;
  * reference_gi: the full hybrid screen + voxel march
    (gi.sample_radiance_with_screen_trace), the fidelity yardstick, one
    gi.reference_ray_resolve call per ray (one CUDA kernel launch on the
    card).

gi_pass returns (ambient, spec, new_gi_cache | None) at the gi_res_divisor
grid; lighting's shade applies the split-sum weights and the upsample.  The
temporal interleave (cfg.gi_temporal_div = 2) traces half the GI lanes per
frame into the persistent FrameState.gi_cache; the frame index and its
parity are host integers.  The rays' inputs at the GI grid (`gi_lane_inputs`)
are, on a CUDA tensor, one launch of csrc/lighting.cu's gi_inputs_kernel
behind a plan cached per shape (`_LanePlan`), which writes only the traced
half's lanes, contiguous, into one fresh allocation; on a CPU tensor
`gi_lane_inputs_plain`.  Both modes read the lightgrid's u8 table that
the sweep wrote beside it (`grid_table`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..gpu import cuda_build
from ..utils import math3d as m3
from . import gi, shadow


def gi_temporal_active(cfg):
    """True when the temporal GI interleave can run: GI on in fast march
    mode (or in reference mode with the gi_temporal_reference opt-in),
    diffuse and specular at the same divisor, an even number of GI columns
    (and rows under "checker").  init_frame_state sizes FrameState.gi_cache
    by it."""
    kg = cfg.gi_res_divisor
    mode_ok = ((cfg.gi_mode == "fast" and cfg.gi_fast_march)
               or (cfg.gi_mode == "reference" and cfg.gi_temporal_reference))
    return (cfg.gi_temporal_div >= 2 and cfg.enable_gi and mode_ok
            and (cfg.gi_res_divisor_diffuse or kg) == kg
            and cfg.height % kg == 0 and cfg.width % kg == 0
            and (cfg.width // kg) % 2 == 0
            and (cfg.gi_temporal_pattern != "checker"
                 or (cfg.height // kg) % 2 == 0))


def bent_normal_cosine(n, noise_1, noise_3):
    """Random cosine-hemisphere direction about N (lighting_pass.glsl:551-585)."""
    some_vector = m3.normalize(torch.tensor([0.7128864983, 0.8217892113, 0.948912748],
                                            device=n.device))
    tangent = m3.normalize(m3.cross(some_vector.expand(n.shape), n))
    bitangent = m3.cross(n, tangent)
    pitch = m3.cpu_serial(torch.arccos, m3.sqrt(torch.clamp(1.0 - noise_1, 0.0, 1.0)))
    yaw = 2.0 * math.pi * noise_3
    sp = m3.cpu_serial(torch.sin, pitch)
    local = torch.stack([sp * m3.cpu_serial(torch.cos, yaw), sp * m3.cpu_serial(torch.sin, yaw),
                         m3.cpu_serial(torch.cos, pitch)], -1)
    return tangent * local[..., 0:1] + bitangent * local[..., 1:2] + n * local[..., 2:3]


def _half_lanes(x, pattern, par):
    """The parity-selected half of the GI lanes [Hg, Wg, ...] -> [Hg, Wg/2,
    ...]: x[:, par::2]; under "checker" odd rows take the opposite parity."""
    if pattern != "checker":
        return x[:, par::2]
    out = x.new_empty((x.shape[0], x.shape[1] // 2) + x.shape[2:])
    out[0::2] = x[0::2, par::2]
    out[1::2] = x[1::2, 1 - par::2]
    return out


def interleave_ops(cfg, frame_idx):
    """(half, merge) lane ops of the gi_temporal_div=2 interleave for the
    host frame index.  half(x): the parity-selected half of the GI columns,
    x[:, par::2]; under "checker" odd rows take the opposite parity.
    merge(slot, half_val): a copy of the cache slot with the freshly traced
    half written back at its positions."""
    par = frame_idx % 2
    checker = cfg.gi_temporal_pattern == "checker"

    def half(x):
        return _half_lanes(x, cfg.gi_temporal_pattern, par)

    def merge(slot, half_val):
        out = slot.clone()
        if not checker:
            out[:, par::2] = half_val
        else:
            out[0::2, par::2] = half_val[0::2]
            out[1::2, 1 - par::2] = half_val[1::2]
        return out

    return half, merge


def _specular_ray(ctx):
    """Noise-roughened reflection direction, biased toward N at high
    roughness (lighting_pass.glsl:691-697)."""
    nd, roughd = ctx.nd, ctx.roughd
    r = m3.reflect(-ctx.vd, nd)
    r = m3.normalize(r + 0.6 * roughd[..., None]
                     * (torch.stack([ctx.n1d, ctx.n2d, ctx.n3d], -1) - 0.5))
    r2 = roughd * roughd
    return r + (nd - r) * (r2 * r2)[..., None]


class GiLanes(NamedTuple):
    """The GI rays' per-lane inputs, each contiguous over the lane grid
    [rows, cols] (the traced half under the interleave)."""

    pw: torch.Tensor                    # [rows, cols, 3] world position
    pv: torch.Tensor                    # [rows, cols, 3] view position
    bent: torch.Tensor                  # [rows, cols, 3] the diffuse ray
    n3: torch.Tensor                    # [rows, cols] noise 3 (the rays' noise)
    vd: Optional[torch.Tensor] = None   # [rows, cols, 3] unit vector to the camera
    spec: Optional[torch.Tensor] = None  # [rows, cols, 3] the specular ray
    rough: Optional[torch.Tensor] = None  # [rows, cols] roughness


PATTERNS = {None: 0, "columns": 1, "checker": 2}


def gi_lane_inputs_plain(normal, orm, depth, world_from_clip, view_from_clip, camera_pos, k,
                         frame_idx_mod_59, row_offset=0, full_height=None, pattern=None,
                         parity=0, specular=True):
    """gi_lane_inputs in PyTorch ops: lighting.sub_grid_inputs at the k grid,
    vd, bent_normal_cosine and (specular) _specular_ray, then the half of
    `pattern` ("columns" / "checker", `parity`) or every lane (None)."""
    from .lighting import sub_grid_inputs

    nd, roughd, pwd, pvd, (n1d, n2d, n3d) = sub_grid_inputs(
        normal, orm, depth, world_from_clip, view_from_clip, k, frame_idx_mod_59, row_offset,
        full_height)
    vd = m3.normalize(camera_pos - pwd)
    lanes = GiLanes(pw=pwd, pv=pvd, bent=bent_normal_cosine(nd, n1d, n3d), n3=n3d)
    if specular:
        ctx = SimpleNamespace(nd=nd, roughd=roughd, vd=vd, n1d=n1d, n2d=n2d, n3d=n3d)
        lanes = lanes._replace(vd=vd, spec=_specular_ray(ctx), rough=roughd)

    def pick(x):
        if x is None:
            return None
        return (x if pattern is None else _half_lanes(x, pattern, parity)).contiguous()

    return GiLanes(*(pick(x) for x in lanes))


class _GiArgs(ctypes.Structure):
    """struct GiArgs of csrc/lighting.cu, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "normal", "orm", "depth", "world_from_clip", "view_from_clip", "camera_pos", "pw",
        "pv", "vd", "bent", "spec", "n3", "rough")] + [(n, ctypes.c_float) for n in (
            "inv_fw", "inv_fh", "noise_offset")] + [(n, ctypes.c_int) for n in (
                "w", "k", "row_offset", "rows", "cols", "pattern", "parity")]


# the floats a lane of GiLanes' fields, in order (the first four without the
# specular ray)
LANE_WIDTHS = (3, 3, 3, 1, 3, 3, 1)


def _lane_grid(h, w, k, pattern):
    """(rows, traced columns) of the lane grid of an [h, w] G-buffer at
    divisor k under `pattern`; ValueError on an unknown pattern or a grid
    the interleave cannot halve."""
    fn = "gi_lane_inputs"
    if pattern not in PATTERNS:
        raise ValueError(f"{fn}: unknown pattern {pattern!r}")
    rows, cols = -(-h // k), -(-w // k)
    if pattern is not None and (cols % 2 or (pattern == "checker" and rows % 2)):
        raise ValueError(f"{fn}: the {pattern} interleave needs an even lane grid, got "
                         f"{rows}x{cols}")
    return rows, (cols if pattern is None else cols // 2)


class _LanePlan:
    """What a lane-inputs launch of one shape keeps between frames: the
    launch's struct with every per-shape field set (the frame's reciprocal
    size, w, k, the row offset, the lane grid, the pattern), the inputs'
    shapes, which each call's inputs are compared with (`accepts`), and the
    outputs' layout in one allocation (each array on a 128-byte line).  A
    call allocates that buffer anew (`outputs`: the lanes stay fresh per
    call) and sets the data pointers, the noise offset and the parity under
    the plan's lock.  The constructor raises _lane_grid's ValueErrors."""

    def __init__(self, device, h, w, k, row_offset, fh, pattern, specular):
        rows, lc = _lane_grid(h, w, k, pattern)
        self.device, self.lock = device, threading.Lock()
        self.shapes = ((h, w, 3), (h, w, 3), (h, w), (4, 4), (4, 4), (3,))
        # GiLanes' fields in order: (shape, strides, offset) in the allocation
        self.fields, total = [], 0
        for width in LANE_WIDTHS[:None if specular else 4]:
            if width > 1:
                self.fields.append(((rows, lc, width), (lc * width, width, 1), total))
            else:
                self.fields.append(((rows, lc), (lc, 1), total))
            total += -(-rows * lc * width // 32) * 32
        self.total = total
        self.args = _GiArgs(inv_fw=shadow._recip(-(-w // k) * k), inv_fh=shadow._recip(fh),
                            w=w, k=k, row_offset=row_offset, rows=rows, cols=lc,
                            pattern=PATTERNS[pattern])

    def accepts(self, ts):
        """Whether the kernel's inputs ts are float32, contiguous, on the
        plan's device and of its shapes."""
        for t, shape in zip(ts, self.shapes):
            if (t.dtype is not torch.float32 or t.shape != shape or not t.is_contiguous()
                    or t.device != self.device):
                return False
        return True

    def outputs(self):
        """A fresh GiLanes: views of one new allocation."""
        buf = torch.empty(self.total, dtype=torch.float32, device=self.device)
        return GiLanes(*(buf.as_strided(shape, strides, off)
                         for shape, strides, off in self.fields))


@functools.lru_cache(maxsize=32)
def _lane_plan(device, stream, h, w, k, row_offset, fh, pattern, specular):
    return _LanePlan(device, h, w, k, row_offset, fh, pattern, specular)


def _lane_inputs(normal, orm, depth, world_from_clip, view_from_clip, camera_pos):
    """The inputs checked (ValueError), the matrices and camera dense: the
    full checks, for the CPU and for a call the plan does not accept."""
    fn = "gi_lane_inputs"
    h, w = depth.shape
    dev = depth.device
    # the kernel reads the matrices and the camera position as dense arrays
    world_from_clip, view_from_clip, camera_pos = (
        t.contiguous() for t in (world_from_clip, view_from_clip, camera_pos))
    ts = (normal, orm, depth, world_from_clip, view_from_clip, camera_pos)
    for t, what, shape in zip(ts, ("normal", "orm", "depth", "world_from_clip",
                                   "view_from_clip", "camera_pos"),
                              ((h, w, 3), (h, w, 3), (h, w), (4, 4), (4, 4), (3,))):
        cuda_build.need(t, what, fn, dev, shape)
    return ts


def gi_lane_inputs(normal, orm, depth, world_from_clip, view_from_clip, camera_pos, k,
                   frame_idx_mod_59, row_offset=0, full_height=None, pattern=None, parity=0,
                   specular=True):
    """The GI rays' inputs (GiLanes) at the [::k, ::k] grid of the G-buffer
    rows (normal, orm [H,W,3], depth [H,W]; rows [row_offset, row_offset +
    H) of a full_height-tall frame), with the noise of frame_idx_mod_59:
    every lane, or under the interleave (pattern "columns" / "checker")
    only the traced half of parity `parity`.  specular False: pw, pv, bent
    and n3 only (a separate diffuse grid).  A CUDA tensor launches
    csrc/lighting.cu's gi_inputs_kernel once through a plan cached per
    shape and stream (_LanePlan), or raises; a CPU tensor takes
    gi_lane_inputs_plain.  On the card a call's inputs are compared with
    its plan's dtype, device, shapes and layout; the full checks
    (ValueError) run on the CPU and where that comparison fails.  The
    outputs are views of one fresh allocation a call.
    `gi_lane_inputs.launches` counts launches."""
    h, w = depth.shape
    dev = depth.device
    fh = full_height or h
    if not depth.is_cuda:
        ts = _lane_inputs(normal, orm, depth, world_from_clip, view_from_clip, camera_pos)
        _lane_grid(h, w, k, pattern)
        return gi_lane_inputs_plain(*ts, k, frame_idx_mod_59, row_offset, fh, pattern, parity,
                                    specular)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = _lane_plan(dev, stream, h, w, k, row_offset, fh, pattern, bool(specular))
    ts = (normal, orm, depth, world_from_clip, view_from_clip, camera_pos)
    if not plan.accepts(ts):
        ts = _lane_inputs(*ts)
    lanes = plan.outputs()
    with plan.lock:
        args = plan.args
        (args.normal, args.orm, args.depth, args.world_from_clip, args.view_from_clip,
         args.camera_pos) = (t.data_ptr() for t in ts)
        (args.pw, args.pv, args.bent, args.n3, args.vd, args.spec, args.rough) = (
            None if t is None else t.data_ptr() for t in lanes)
        args.noise_offset = shadow.noise_offset(frame_idx_mod_59)
        args.parity = parity
        err = _lanes_launcher()(ctypes.byref(args), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"gi_inputs_launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(shadow.library(), err)})")
    gi_lane_inputs.launches += 1
    return lanes


gi_lane_inputs.launches = 0


@functools.cache
def _lanes_launcher():
    """csrc/lighting.cu's gi_inputs_launch(args, device, stream)."""
    return shadow.library().gi_inputs_launch


def _min_depth(trace_depth, k):
    """k x k minimum of the depth (or the [::k, ::k] subsample when k does
    not divide it)."""
    if k == 1:
        return trace_depth
    h, w = trace_depth.shape
    if h % k == 0 and w % k == 0:
        return trace_depth.reshape(h // k, k, w // k, k).amin(dim=(1, 3))
    return trace_depth[::k, ::k]


def grid_table(res):
    """The lightgrid's u8 table (gi.quantize_grid_u8's levels) that the
    sweep wrote beside it, res.lightgrid_u8; ValueError without one: the
    table travels with the grid (gi.sweep_lightgrid_u8), and the GI runs no
    quantize of its own."""
    if res.lightgrid_u8 is None:
        raise ValueError("gi_pass: LightingResources.lightgrid_u8 is None; the GI reads the "
                         "table gi.sweep_lightgrid_u8 writes beside the grid")
    return res.lightgrid_u8


def fast_march_gi(ctx):
    """The fast GI: fog march on the u8 table (trilinear) or the f16 grid
    (nearest), the linear screen trace as the screen term; each ray's lanes
    in one gi.fast_ray_resolve call (one kernel launch on the card)."""
    cfg, glob, res = ctx.cfg, ctx.glob, ctx.res
    trace_tbl = None
    if cfg.gi_fast_screen_probe:
        kdt = cfg.gi_trace_depth_div
        if kdt > 1 and cfg.gi_trace_depth_mode == "plain":
            trace_tbl = ctx.trace_depth[::kdt, ::kdt]
        else:
            trace_tbl = _min_depth(ctx.trace_depth, kdt)
        trace_tbl = trace_tbl.contiguous()
    table = grid_table(res)
    fgrid = None if cfg.gi_fast_fog_trilinear else gi.pack_grid_f16_nearest(res.lightgrid)
    # the kernel reads the matrices and the camera position as dense arrays
    mats = [t.contiguous() for t in (glob.view_from_world, glob.clip_from_view,
                                     glob.world_from_view, glob.camera_pos)]

    def march_resolve(pw, rd_unit, hit_steps, step_scale, ss_intensity, noise,
                      foggyness, pv):
        rp = gi.ray_params(cfg, hit_steps, step_scale, ss_intensity, ctx.fh // 2, ctx.w // 2)
        rgb, _ = gi.fast_ray_resolve(table, fgrid, trace_tbl, res.prev_frame_atlas, *mats, pw,
                                     rd_unit, pv, noise, foggyness, rp)
        return rgb

    lanes, dif = ctx.lanes, ctx.lanes_diffuse
    ambient = march_resolve(dif.pw, dif.bent, cfg.gi_fast_hit_steps, cfg.gi_fast_hit_step_scale,
                            cfg.gi_diffuse_ss_intensity, dif.n3, cfg.gi_diffuse_foggyness,
                            dif.pv)
    spec_fog = lanes.rough if cfg.gi_specular_foggyness_is_roughness else 0.9
    spec = march_resolve(lanes.pw, lanes.spec, cfg.gi_fast_hit_steps_spec,
                         cfg.gi_fast_hit_step_scale_spec, cfg.gi_specular_ss_intensity,
                         lanes.n3, spec_fog, lanes.pv)
    if ctx.merge is None:
        return ambient, spec, None
    ambient = ctx.merge(ctx.gi_cache[0], ambient)
    spec = ctx.merge(ctx.gi_cache[1], spec)
    return ambient, spec, torch.stack([ambient, spec])


def reference_gi(ctx):
    """The reference mode: the full hybrid march
    (gi.sample_radiance_with_screen_trace, lighting_pass.glsl:273-424) for
    the diffuse and the specular ray, against the full-resolution depth or,
    with gi_reference_depth_div = k > 1, its plain [::k, ::k] subsample;
    under gi_temporal_reference, on the interleave's half of the lanes.
    Each ray's lanes in one gi.reference_ray_resolve call (one kernel launch
    on the card) on the u8 table the sweep wrote beside the grid."""
    cfg, glob, res = ctx.cfg, ctx.glob, ctx.res
    kdr = cfg.gi_reference_depth_div
    ref_depth = (ctx.trace_depth[::kdr, ::kdr] if kdr > 1 else ctx.trace_depth).contiguous()
    table = grid_table(res)
    # the kernel reads the matrices as dense arrays
    mats = [t.contiguous() for t in (glob.view_from_world, glob.clip_from_view,
                                     glob.view_from_clip, glob.world_from_view)]

    def ref_resolve(pw, pv, vd, rd, noise, steps, step_scale, fog, intensity):
        rp = gi.reference_ray_params(cfg, steps, step_scale, intensity, ctx.fh // 2, ctx.w // 2)
        rgb, _ = gi.reference_ray_resolve(table, ref_depth, res.prev_frame_atlas, *mats, vd, pv,
                                          pw, rd, noise, fog, rp)
        return rgb

    lanes = ctx.lanes
    ambient = ref_resolve(lanes.pw, lanes.pv, lanes.vd, lanes.bent, lanes.n3,
                          cfg.gi_diffuse_steps, cfg.gi_diffuse_step_scale,
                          cfg.gi_diffuse_foggyness, cfg.gi_diffuse_ss_intensity)
    spec_fog = lanes.rough if cfg.gi_specular_foggyness_is_roughness else 0.9
    spec = ref_resolve(lanes.pw, lanes.pv, lanes.vd, lanes.spec, lanes.n3,
                       cfg.gi_specular_steps, cfg.gi_specular_step_scale, spec_fog,
                       cfg.gi_specular_ss_intensity)
    if ctx.merge is None:
        return ambient, spec, None
    ambient = ctx.merge(ctx.gi_cache[0], ambient)
    spec = ctx.merge(ctx.gi_cache[1], spec)
    return ambient, spec, torch.stack([ambient, spec])


def gi_pass(cfg, glob, res, g, trace_depth, fh, w, f59, gi_cache=None, frame_idx=None,
            row_offset=0):
    """GI of the G-buffer `g` (its rows [row_offset, row_offset + H) of an
    fh-tall frame).  Returns (ambient, spec, new_gi_cache | None) at the
    gi_res_divisor grid.  f59 and frame_idx are host numbers."""
    kg = cfg.gi_res_divisor
    # "cycle": the GI noise advances once per 2-frame refresh cycle
    f59_gi = f59
    if gi_cache is not None and cfg.gi_temporal_noise == "cycle":
        f59_gi = float(((frame_idx | 1) + cfg.gi_noise_offset) % 59)
    elif cfg.gi_noise_offset:
        f59_gi = float(np.mod(np.float32(f59) + np.float32(cfg.gi_noise_offset),
                              np.float32(59.0)))
    merge = pattern = None
    parity = 0
    if gi_cache is not None:
        assert gi_temporal_active(cfg)
        _, merge = interleave_ops(cfg, frame_idx)
        pattern, parity = cfg.gi_temporal_pattern, frame_idx % 2
    view = (g.normal, g.orm, g.depth, glob.world_from_clip, glob.view_from_clip,
            glob.camera_pos)
    lanes = gi_lane_inputs(*view, kg, f59_gi, row_offset, fh, pattern, parity)
    # the fast GI's diffuse ray, optionally at its own coarser grid
    kdif = cfg.gi_res_divisor_diffuse or kg
    lanes_diffuse = lanes
    if cfg.gi_mode != "reference" and kdif != kg:
        lanes_diffuse = gi_lane_inputs(*view, kdif, f59_gi, row_offset, fh, specular=False)
    ctx = SimpleNamespace(cfg=cfg, glob=glob, res=res, trace_depth=trace_depth, fh=fh, w=w,
                          lanes=lanes, lanes_diffuse=lanes_diffuse, gi_cache=gi_cache,
                          merge=merge)
    if cfg.gi_mode == "reference":
        return reference_gi(ctx)
    return fast_march_gi(ctx)
