"""The row-sharded multi-GPU frame on torch.distributed (counterpart of
vulkan_pbr_renderer_tpu/parallel/sharding.py).

One process is one rank.  The ranks form a dp x sp mesh (`make_mesh`):

  dp -- independent frames: each dp slice renders its own camera path and
        carries its own FrameState, held by every rank of the slice;
  sp -- rows: the ranks of a slice split the framebuffer's rows.

Inside one frame each sp rank of a slice
  1. rasterizes its rows of the sun shadow map; all_gather -> the full map
     (every rank needs arbitrary shadow lookups);
  2. voxelizes a 1/sp slice of the same GI sample stream; the packed
     partial grids combine with an all_reduce(MAX): scatter-max is
     order-independent, so the grid equals the single-device one exactly;
  3. sweeps the (replicated) lightgrid itself, and writes its u8 table;
  4. rasterizes, G-buffers and lights its own rows (the GI screen trace reads
     the all_gathered full depth);
  5. all_gathers the HDR and velocity rows, then resolves TAA, the level-1
     bloom downsample, the final full-resolution tent and the tonemap for its
     rows as row windows of the gathered frame (`_post_stack_sharded`); only
     the deep bloom levels (<= H/4 x W/4) run replicated.

JAX's `_rasterize_rows` is `app.renderer._rasterize(..., rows, y_origin)`,
which the single-device frame shares.  `all_gather(..., tiled=True)` over
sp is an all_gather into a contiguous
[sp * rows, ...] buffer; `pmax` is all_reduce(MAX) (on the packed voxel words
and on the raster overflow counters).  The frame index and the sun angle stay
host values, equal on every rank of a slice, so every rank takes the same
branch and collectives run in the same order everywhere.

As in the JAX package, the sharded frame forces gi_res_divisor =
shaft_res_divisor = 1 and gi_temporal_div = 1 (a reduced-resolution upsample
would clamp at band edges and seam), so it equals `render_frame` under that
divisor-1 config; the sky is then computed at full resolution
(lighting.py:305-318).  The lightgrid debug view is not drawn here, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..app import renderer as rmod
from ..config import RenderConfig
from ..shade import bloom as bloom_mod
from ..shade import gbuffer as gb
from ..shade import gi, lighting, taa

# the gather's name: newer torch deprecates all_gather_into_tensor for it
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the dp x sp mesh: ranks dp_idx * sp + sp_idx."""

    dp: int
    sp: int
    rank: int
    dp_idx: int
    sp_idx: int
    sp_group: Any            # the process group of this rank's dp slice
    device: torch.device
    backend: str


def make_mesh(dp=1, backend=None, device=None) -> Mesh:
    """The dp x sp mesh over the initialised process group (sp = world /
    dp); every rank calls it.  device: None for the card, cuda:{rank %
    device_count} (raises without one), or "cpu".  backend: the collectives'
    backend, default the group's: "nccl" needs one card per rank, "gloo"
    runs on the CPU and also where ranks share a card."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % dp:
        raise ValueError(f"dp={dp} must divide the world size {world}")
    sp = world // dp
    backend = backend or dist.get_backend()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = torch.device(device)
    if backend == "nccl" and (device.type != "cuda" or torch.cuda.device_count() < world):
        raise ValueError(f"backend 'nccl' needs one card per rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards, device {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # new_group is collective: every rank creates every slice's group
    groups = [dist.new_group(list(range(i * sp, (i + 1) * sp)), backend=backend)
              for i in range(dp)]
    return Mesh(dp=dp, sp=sp, rank=rank, dp_idx=rank // sp, sp_idx=rank % sp,
                sp_group=groups[rank // sp], device=device, backend=backend)


def _gather_rows(x, mesh: Mesh):
    """all_gather(x, "sp", axis=0, tiled=True): [rows, ...] -> [sp * rows, ...]."""
    if mesh.sp == 1:
        return x
    out = x.new_empty((mesh.sp * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, x.contiguous(), group=mesh.sp_group)
    return out


def _max_over_sp(x, mesh: Mesh):
    """pmax(x, "sp"), in place."""
    if mesh.sp > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.sp_group)
    return x


def _post_stack_sharded(hdr_full, depth_full, vel_full, state, cfg, y0, rows, mesh):
    """Passes 6-9 for this rank's rows (sharding.py:99-199): TAA, the level-1
    bloom downsample and the final full-resolution tent + tonemap as row
    windows over the gathered full-height buffers; the deeper levels and the
    up chain (<= [H/4, W/4]) run replicated.  The history and previous
    velocity stay replicated state (the reprojected uv can land on any row).
    On the card every step is one launch of csrc/post.cu's kernels (the up
    chain, its last level's row window included, one launch); on the CPU
    the plain versions compute the windows from edge-clamped halo slabs.
    Returns (final sRGB rows, taa_out [full, gathered], pyramid)."""
    h, w = cfg.height, cfg.width
    if cfg.enable_taa:
        history = hdr_full if state.frame_idx == 0 else state.taa_history
        taa_rows = taa.taa_resolve(
            hdr_full, depth_full, vel_full, state.velocity_prev, history, cfg.taa_blend,
            cfg.taa_velocity_rejection, catmull_history=cfg.taa_catmull_history,
            full_rgb_catmull=cfg.taa_full_rgb_catmull, row_begin=y0, row_count=rows)
        taa_out = _gather_rows(taa_rows, mesh)
    else:
        taa_rows = hdr_full[y0:y0 + rows]
        taa_out = hdr_full

    if not cfg.enable_bloom:
        final_rows = bloom_mod.bloom_up_level(None, h, w, base=taa_rows, exposure=cfg.exposure,
                                              rows=(y0, rows))
        return final_rows, taa_out, state.prev_pyramid

    passes = cfg.bloom_pass_count
    sizes = bloom_mod.chain_sizes(h, w, passes)
    pyramid, offs = bloom_mod.new_atlas(h, w, passes, hdr_full.device)
    if passes == 1:
        # no deeper level reads level 1 whole: every rank computes it whole
        cur = bloom_mod.bloom_down_level(taa_out, *sizes[1], True, atlas=pyramid,
                                         atlas_col=offs[0])
    else:
        # level 1, sharded, then gathered; level 2 writes its atlas band too
        d1 = bloom_mod.bloom_down_level(taa_out, *sizes[1], True, rows=(y0 // 2, rows // 2))
        cur = _gather_rows(d1, mesh)
    for i in range(2, passes + 1):
        cur = bloom_mod.bloom_down_level(cur, *sizes[i], atlas=pyramid, atlas_col=offs[i - 1],
                                         src_atlas_col=offs[0] if i == 2 else None)
    final_rows = bloom_mod.bloom_up_chain(cur, h, w, passes, cfg.bloom_strength, taa_rows,
                                          cfg.exposure, rows=(y0, rows))
    return final_rows, taa_out, pyramid


def sharded_config(scene, cfg: RenderConfig) -> RenderConfig:
    """The config the sharded frame renders: GI and shafts at the divisor 1
    (module docstring), and a GI config with voxelize_samples = 0 right-sized
    for the scene as Renderer does.  render_frame under it is the frame the
    sharded frame equals."""
    cfg = cfg.replace(gi_res_divisor=1, gi_res_divisor_diffuse=1, shaft_res_divisor=1,
                      gi_temporal_div=1)
    if cfg.enable_gi and cfg.voxelize_samples == 0:
        cfg = cfg.replace(voxelize_samples=gi.voxelize_sample_capacity(
            scene, cfg.lightgrid_size, cfg.lightgrid_scale))
    return cfg


def sharded_frame_fn(scene, cfg: RenderConfig, mesh: Mesh, raster_backend="xla"):
    """The multi-GPU `render_frame`: returns step(state, cam, sun_angle,
    prefiltered_env, brdf_lut) -> final sRGB image [H, W, 3] (on every rank
    of the slice), which updates this dp slice's FrameState in place as
    render_frame does.  scene, state, camera and tables live on mesh.device;
    every rank of a slice passes the same state, camera and sun.  It renders
    `sharded_config(scene, cfg)`.  The rows must split evenly: height by sp
    (by sp * 32 for "pallas"), shadow_map_size by sp."""
    sp = mesh.sp
    cfg = sharded_config(scene, cfg)
    backend = rmod.resolve_raster_backend(raster_backend, scene.num_tris)
    h, w = cfg.height, cfg.width
    if backend == "pallas":
        assert h % (sp * 32) == 0, "height must be divisible by sp * tile_h"
    else:
        assert h % sp == 0, "height must be divisible by sp"
    rows = h // sp
    sm = cfg.shadow_map_size
    assert sm % sp == 0, "shadow_map_size must be divisible by sp"
    sm_rows = sm // sp
    total_samples = cfg.voxelize_samples or (1 << 20)
    y0 = mesh.sp_idx * rows

    def step(state: rmod.FrameState, cam: rmod.CameraState, sun_angle, prefiltered_env,
             brdf_lut):
        frame_idx = state.frame_idx
        fi = rmod.frame_inputs(state, cam, sun_angle, cfg)
        zero_ovf = torch.zeros((2,), dtype=torch.int32, device=mesh.device)

        # ---- pass 1: sun depth -- this rank's shadow-map rows, gathered ----
        sun_depth, sun_ovf = state.sun_depth, zero_ovf
        if cfg.enable_shadows and fi.sun_changed:
            _, sd, _, sun_ovf = rmod._rasterize(
                scene, fi.sun_from_world, sm, sm, cfg, cull="none", backend=backend,
                rows=sm_rows, y_origin=mesh.sp_idx * sm_rows)
            sun_depth = _gather_rows(torch.where(torch.isinf(sd), 1.0, sd), mesh)

        # ---- pass 2: voxelize a slice of the sample stream, max-combined --
        # ---- pass 3: sweep (replicated), the axis rotating per frame ------
        lightgrid, lightgrid_u8 = state.lightgrid, None
        if cfg.enable_gi:
            if fi.sun_changed:
                part = gi.voxelize_scene(
                    scene, cfg.lightgrid_size, cfg.lightgrid_scale, sun_depth,
                    fi.sun_from_world, fi.sun_dir, rmod.sun_emission(cfg),
                    total_samples=total_samples, shard_idx=mesh.sp_idx, shard_count=sp,
                    plan=rmod.voxel_plan(state, scene, cfg))
                lightgrid = gi.decode_voxel_grid(_max_over_sp(part, mesh))
                state.voxelize_count += 1
            lightgrid, lightgrid_u8 = rmod.sweep_rotated(lightgrid, frame_idx, cfg)

        # ---- pass 4: raster + G-buffer of this rank's rows ----------------
        sun_u16, static, lut16 = rmod.frame_tables(state, scene, brdf_lut, cfg, sun_depth,
                                                   fi.sun_changed)
        s, depth, tri, main_ovf = rmod._rasterize(
            scene, cam.clip_from_world, w, h, cfg, jitter=fi.jitter, cull="back",
            backend=backend, rows=rows, y_origin=y0)
        gbuf = gb.gbuffer_pass(
            scene, s, depth, tri, cam.clip_from_world, fi.old_clip_from_world,
            cfg.alpha_test_threshold, world_from_clip=cam.world_from_clip, jitter=fi.jitter,
            material_filter=cfg.material_filter, frame_idx_mod_59=float(frame_idx % 59),
            row_offset=y0, full_size=(h, w), static=static)
        depth_full = _gather_rows(gbuf.depth, mesh)

        # ---- pass 5: lighting of this rank's rows -------------------------
        res = lighting.LightingResources(sun_depth=sun_depth, prefiltered_env=prefiltered_env,
                                         brdf_lut=brdf_lut, lightgrid=lightgrid,
                                         prev_frame_atlas=state.prev_pyramid,
                                         sun_u16=sun_u16, brdf_lut16=lut16,
                                         lightgrid_u8=lightgrid_u8)
        hdr_rows = lighting.lighting_pass(gbuf, rmod.build_globals(cam, fi, frame_idx), res,
                                          cfg, row_offset=y0, full_height=h,
                                          depth_full=depth_full)

        # ---- gather HDR + velocity; passes 6-9 row-sharded ----------------
        hdr = _gather_rows(hdr_rows, mesh)
        velocity = _gather_rows(gbuf.velocity, mesh)
        final_rows, taa_out, pyramid = _post_stack_sharded(hdr, depth_full, velocity, state,
                                                           cfg, y0, rows, mesh)
        final = _gather_rows(final_rows, mesh)

        ovf = _max_over_sp(torch.maximum(sun_ovf, main_ovf), mesh)
        torch.maximum(state.raster_overflow, ovf, out=state.raster_overflow)
        state.lightgrid = lightgrid
        state.sun_depth = sun_depth
        state.sun_u16 = sun_u16
        state.taa_history = taa_out
        state.velocity_prev = velocity
        state.prev_pyramid = pyramid
        state.clip_from_world_prev = cam.clip_from_world
        state.sun_angle_prev = tuple(float(np.float32(a)) for a in sun_angle)
        state.frame_idx += 1
        return final

    return step


# ---------------------------------------------------------------------------
# process launch


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(rank, fn, world_size, backend, port, results, args):
    # ranks share the host's cores: PyTorch's CPU ops run on one thread each
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world_size, rank=rank)
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size, backend, *args):
    """Run fn(*args) on world_size ranks, one spawned process each, in a
    process group of `backend` on 127.0.0.1 and a free port (each rank finds
    its rank with dist.get_rank()).  Returns the ranks' return values in
    rank order; they cross a pipe, so return numpy arrays or plain values,
    not tensors.  A failure in any rank fails the call.  Build the CUDA
    kernels in the calling process first: the ranks then load them."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(_run_rank, args=(fn, world_size, backend, _free_port(),
                                                results, args),
                               nprocs=world_size, join=False, start_method="spawn")
    out = [None] * world_size

    def drain():
        while not results.empty():
            rank, value = results.get()
            out[rank] = value

    while not procs.join(timeout=0.05):   # raises if a rank failed
        drain()
    drain()
    return out
