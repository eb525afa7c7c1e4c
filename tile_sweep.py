#!/usr/bin/env python3
"""Sweep of the tiled kernels' compile-time values on one GPU: the shade
(csrc/lighting.cu), the G-buffer (csrc/gbuffer.cu), the bloom down and up
chains (csrc/post.cu), TAA's tiled designs (the sweep-only taa_sweep.cu,
beside csrc/post.cu's thread-per-pixel kernel), the one-launch polar
shafts (csrc/lighting.cu), the GI lane inputs' tiled designs (the
sweep-only lanes_sweep.cu, beside csrc/lighting.cu's kernel), the
lightgrid sweep (csrc/sweep.cu and the sweep-only sweep_variants.cu) and
voxelize (csrc/voxelize.cu and the sweep-only voxelize_sweep.cu).

Run from the repository root:

    python3 tile_sweep.py [--parent DIR]
                          [--groups shade,chain,up,gbuffer,taa,shafts,lanes,sweep,voxelize]
                          [--out chiprun_out/tile_sweep.json]
                          [--variants a,b,...]

Builds each kernel's source once per variant, all builds started together,
and prints each build's ptxas registers and spills and the kernel's
resident blocks an SM:
  - shade: csrc/lighting.cu per shade tile (SHADE_TILE_W x SHADE_TILE_H) and
    register bound (SHADE_MIN_BLOCKS, blocks of 256 threads an SM);
  - chain: csrc/post.cu per down-chain tile (CHAIN_TILE_H rows of 32
    texels) and register bound (CHAIN_MIN_BLOCKS);
  - up: csrc/post.cu per up-chain tile (UP_TILE_H x UP_TILE_W) and register
    bound (UP_MIN_BLOCKS);
  - gbuffer: csrc/gbuffer.cu per pixel tile (GB_TILE_W x GB_TILE_H) and
    register bound (GB_MIN_BLOCKS);
  - taa: csrc/post.cu's thread-per-pixel taa_kernel (the package's), and
    the sweep-only taa_sweep.cu's tiled kernel per tile (TAA_TILE_W x
    TAA_TILE_H), history margin (TAA_HIST_MARGIN), window rows a warp
    stages at once (TAA_HIST_BATCH) and register bound (TAA_MIN_BLOCKS),
    and its forks (the neighbourhood and the output staged in 16-byte
    lines, a window fixed under the tile, no window), on path A's frame-1
    inputs and on a slow camera's (the first step of the path / SLOW_STEP:
    path A's frames lie 1/7 of the camera path apart, its mean velocity
    hundreds of pixels);
  - shafts: csrc/lighting.cu per profile band (SHAFT_BAND theta rows),
    profile samples a thread loads at once (SHAFT_BATCH) and register
    bound (SHAFT_MIN_BLOCKS), and the sweep-only shafts_sweep.cu
    ("inline": each pixel samples its own profile row, one plain launch,
    no flags);
  - lanes: csrc/lighting.cu's gi_inputs_kernel (the package's: 2D tiles,
    outputs staged) and the sweep-only lanes_sweep.cu's kernel over 2D
    tiles of lanes (LANE_TILE_W x LANE_TILE_H) with the tile's G-buffer
    spans staged in 16-byte lines (LANE_STAGE_IN) and its outputs staged
    and written as 16-byte lines (LANE_STAGE_OUT), and register bound
    (LANE_MIN_BLOCKS), all through shade/gi_modes.py's cached plan;
  - sweep: csrc/sweep.cu's ring kernel (the package's), and the sweep-only
    sweep_variants.cu's ring kernel built from the package's pieces per
    lanes a line (SWEEP_LANES), ring stages (SWEEP_STAGES), register
    bound (SWEEP_RING_MIN_BLOCKS), blocks an SM (SWEEP_RING_PER_SM) and
    quantizes a thread batches (SWEEP_STORE_BATCH), at the package's own
    values too ("variant_l16_s2"), its replay kernel at every length
    ("replay": the earlier design, the baseline), its fast rgb level
    (SWEEP_FAST_LEVEL, also checked over every third f32 bit pattern) and
    the ring kernel's probes (no scans, no quantize, no stores, no loads:
    not the plain version's bits, timed only), on path A's frame-1 grid on
    each axis;
  - voxelize: csrc/voxelize.cu's one-launch pass (voxelize_lightgrid) per
    samples a block (VOXEL_THREADS), the package's int64 route beside it
    (voxelize_scene + decode_voxel_grid, the sharded frame's), and the
    sweep-only voxelize_sweep.cu's int64 kernel with a search a sample
    ("search", with the package's decode: the earlier two-launch pass),
    its forks (a block's window of offsets staged in shared memory, the
    voxel's word read before the atomic, a warp's max per voxel before one
    atomic) and probes (no atomics; the lookup alone), on path A's frame-0
    and sun-move voxelize inputs; and the pass's own forks there (the words
    zeroed in a first phase, VOXEL_PASS_ZERO_FIRST; with the decoded grid,
    VOXEL_PASS_ZERO_OUT), each on a plan of its own
    (chip_smoke.capture_voxelize_calls), the words checked against
    voxelize_scene_plain's.
On path A's frame-1 inputs (chip_smoke.capture_slice_calls and
capture_post_call: SUNTEMPLE_1080P at 1920x1088 on the 638,700-triangle
SunTemple stand-in) it holds every variant against its plain version bit
for bit (the shade: lighting.shade_plain; the down chain: the plain chain
and its atlas; the up chain: bloom_up_chain_plain; the G-buffer: every
field of gbuffer_pass_plain; TAA: taa_resolve_plain; the shafts:
shafts_polar_plain; the lanes: every field of gi_lane_inputs_plain; the
sweep: the grid and the table of sweep_lightgrid + quantize_grid_u8, but
for the probes; voxelize: the decoded grid of the plain chain, but for the
probes), and times each with CUDA events
(chip_smoke.cuda_ms: median and min of 5 timings of 20 launches, "ms" as
the wrapper's calls come, "device_ms" queued behind a device sleep so that
only the device's time counts), the down chain whole and cut after each
level (levels 1-n), the up chain whole, without its last k levels and its
last level alone (with and without the tonemap), in two rounds, forward
and backward through the list.
With --parent DIR (an unpacked tree of another commit, e.g. `git archive` of
the parent), that tree's kernels of the chosen groups are built and timed
first in each group's list, so the rounds run them and the variants in
turns: its shade (same ShadeArgs), its G-buffer (same GBufArgs), its up
chain as the per-level bloom_up_level launches its tree makes (same
UpArgs) and its shafts through its own shade/shadow.py's wrapper (the
two-launch shafts where it has them) and its GI lane inputs through its
own shade/gi_modes.py's wrapper (before the plan: a struct, six checks
and seven allocations a call).
Writes the JSON to --out, prints one line per variant, and the last line
is the card's name and power limit.  Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke

GROUPS = ("shade", "chain", "up", "gbuffer", "taa", "shafts", "lanes", "sweep", "voxelize")
# the slow camera's TAA inputs: path A's first step divided by this
SLOW_STEP = 64
# the designs measured and not kept: the shafts' inline profile, TAA's tiles
SWEEP_SOURCE = Path(__file__).resolve().with_name("shafts_sweep.cu")
TAA_SWEEP = Path(__file__).resolve().with_name("taa_sweep.cu")
LANES_SWEEP = Path(__file__).resolve().with_name("lanes_sweep.cu")
SWEEP_VARIANTS = Path(__file__).resolve().with_name("sweep_variants.cu")
VOXEL_SWEEP = Path(__file__).resolve().with_name("voxelize_sweep.cu")
# group -> (source, {name: -D values; (sweep source, -D values...); or None:
# SWEEP_SOURCE}); the first variant is the package's default
VARIANTS = {
    "shade": ("lighting", {
        "16x16_mb6": (),
        "16x16_mb4": ("SHADE_MIN_BLOCKS=4",),
        "16x16_mb5": ("SHADE_MIN_BLOCKS=5",),
        "16x16_mb7": ("SHADE_MIN_BLOCKS=7",),
        "32x8_mb6": ("SHADE_TILE_W=32", "SHADE_TILE_H=8"),
    }),
    "chain": ("post", {
        "chain_mb4": (),
        "chain_mb5": ("CHAIN_MIN_BLOCKS=5",),
        "chain_t16": ("CHAIN_TILE_H=16",),
    }),
    "up": ("post", {
        "up_32x32_mb4": (),
        "up_16x32_mb4": ("UP_TILE_H=16",),
        "up_8x64_mb4": ("UP_TILE_H=8", "UP_TILE_W=64"),
        "up_32x32_mb3": ("UP_MIN_BLOCKS=3",),
        "up_16x32_mb5": ("UP_TILE_H=16", "UP_MIN_BLOCKS=5"),
    }),
    "gbuffer": ("gbuffer", {
        "gb_32x8_mb4": (),
        "gb_16x16_mb4": ("GB_TILE_W=16", "GB_TILE_H=16"),
        "gb_64x4_mb4": ("GB_TILE_W=64", "GB_TILE_H=4"),
        "gb_32x8_mb3": ("GB_MIN_BLOCKS=3",),
        "gb_32x8_mb5": ("GB_MIN_BLOCKS=5",),
    }),
    "taa": ("post", {
        "thread_per_pixel": (),
        # taa_sweep.cu's tiles and forks: the designs not kept
        "taa_32x4_m8_mb8": (TAA_SWEEP,),
        "taa_32x8_m8_mb4": (TAA_SWEEP, "TAA_TILE_H=8", "TAA_MIN_BLOCKS=4"),
        "taa_16x16_m8_mb4": (TAA_SWEEP, "TAA_TILE_W=16", "TAA_TILE_H=16", "TAA_MIN_BLOCKS=4"),
        "taa_64x4_m8_mb4": (TAA_SWEEP, "TAA_TILE_W=64", "TAA_TILE_H=4", "TAA_MIN_BLOCKS=4"),
        "taa_32x4_m2_mb8": (TAA_SWEEP, "TAA_HIST_MARGIN=2"),
        "taa_32x4_m16_mb8": (TAA_SWEEP, "TAA_HIST_MARGIN=16"),
        "taa_32x4_m8_mb8_batch2": (TAA_SWEEP, "TAA_HIST_BATCH=2"),
        "nb_staged": (TAA_SWEEP, "TAA_NB_STAGED=1"),
        "out_staged": (TAA_SWEEP, "TAA_OUT_STAGED=1"),
        "nb_out_staged": (TAA_SWEEP, "TAA_NB_STAGED=1", "TAA_OUT_STAGED=1"),
        "window_fixed": (TAA_SWEEP, "TAA_WINDOW_FIXED=1"),
        "no_window": (TAA_SWEEP, "TAA_NO_STAGE=1"),
    }),
    "shafts": ("lighting", {
        "band8_b2_mb4": (),
        "band8_b4_mb4": ("SHAFT_BATCH=4",),
        "band8_b1_mb4": ("SHAFT_BATCH=1",),
        "band4_b2_mb4": ("SHAFT_BAND=4",),
        "band16_b2_mb4": ("SHAFT_BAND=16",),
        "band16_b4_mb4": ("SHAFT_BAND=16", "SHAFT_BATCH=4"),
        "band8_b2_mb6": ("SHAFT_MIN_BLOCKS=6",),
        "inline": None,
    }),
    "lanes": ("lighting", {
        "out_32x8_mb6": (),
        "out_32x8_mb4": ("LANE_MIN_BLOCKS=4",),
        # lanes_sweep.cu's tiles: staged spans and outputs, or not
        "in_out_32x8_mb4": (LANES_SWEEP, "LANE_MIN_BLOCKS=4"),
        "in_32x8_mb4": (LANES_SWEEP, "LANE_STAGE_OUT=0", "LANE_MIN_BLOCKS=4"),
        "plain_32x8_mb6": (LANES_SWEEP, "LANE_STAGE_IN=0", "LANE_STAGE_OUT=0"),
        "out_64x4_mb6": (LANES_SWEEP, "LANE_STAGE_IN=0", "LANE_TILE_W=64", "LANE_TILE_H=4"),
        "out_16x16_mb6": (LANES_SWEEP, "LANE_STAGE_IN=0", "LANE_TILE_W=16", "LANE_TILE_H=16"),
    }),
    "sweep": ("sweep", {
        "ring_l16_s2": (),
        # sweep_variants.cu: the package's ring kernel rebuilt at its own
        # values (the harness's check), then other values, the replay kernel,
        # the fast level, and the ring kernel's probes (timed only)
        "variant_l16_s2": (SWEEP_VARIANTS,),
        "ring_l16_s3": (SWEEP_VARIANTS, "SWEEP_STAGES=3"),
        "ring_l16_s4": (SWEEP_VARIANTS, "SWEEP_STAGES=4"),
        "ring_l16_s2_mb8": (SWEEP_VARIANTS, "SWEEP_RING_MIN_BLOCKS=8"),
        "ring_l16_s2_b2": (SWEEP_VARIANTS, "SWEEP_STORE_BATCH=2"),
        "ring_l16_s2_b4": (SWEEP_VARIANTS, "SWEEP_STORE_BATCH=4"),
        "ring_l32_s2": (SWEEP_VARIANTS, "SWEEP_LANES=32"),
        "ring_l32_s3": (SWEEP_VARIANTS, "SWEEP_LANES=32", "SWEEP_STAGES=3"),
        "ring_l32_s2_b2": (SWEEP_VARIANTS, "SWEEP_LANES=32", "SWEEP_STORE_BATCH=2"),
        "ring_l32_s2_b4": (SWEEP_VARIANTS, "SWEEP_LANES=32", "SWEEP_STORE_BATCH=4"),
        "ring_l32_s3_per_sm2": (SWEEP_VARIANTS, "SWEEP_LANES=32", "SWEEP_STAGES=3",
                                "SWEEP_RING_PER_SM=2"),
        "ring_l32_s2_mb5": (SWEEP_VARIANTS, "SWEEP_LANES=32", "SWEEP_RING_MIN_BLOCKS=5"),
        "replay": (SWEEP_VARIANTS, "SWEEP_REPLAY_ALL=1"),
        "ring_l16_s2_fast": (SWEEP_VARIANTS, "SWEEP_FAST_LEVEL=1"),
        "ring_l32_s3_fast": (SWEEP_VARIANTS, "SWEEP_LANES=32", "SWEEP_STAGES=3",
                             "SWEEP_FAST_LEVEL=1"),
        "probe_no_scan": (SWEEP_VARIANTS, "SWEEP_PROBE=1"),
        "probe_no_quantize": (SWEEP_VARIANTS, "SWEEP_PROBE=2"),
        "probe_no_scan_no_quantize": (SWEEP_VARIANTS, "SWEEP_PROBE=3"),
        "probe_no_store": (SWEEP_VARIANTS, "SWEEP_PROBE=4"),
        "probe_no_load": (SWEEP_VARIANTS, "SWEEP_PROBE=8"),
        "probe_loads_only": (SWEEP_VARIANTS, "SWEEP_PROBE=7"),
        "probe_stores_only": (SWEEP_VARIANTS, "SWEEP_PROBE=11"),
        "probe_no_memory": (SWEEP_VARIANTS, "SWEEP_PROBE=12"),
    }),
    "voxelize": ("voxelize", {
        "pass": (),
        "pass_t128": ("VOXEL_THREADS=128",),
        "pass_t512": ("VOXEL_THREADS=512",),
        "pass_zero_first": (VOXEL_SWEEP, "VOXEL_PASS_ZERO_FIRST=1"),
        # voxelize_sweep.cu: the int64 kernel searching a sample, its forks, then probes
        # (timed only)
        "pass_zero_out": (VOXEL_SWEEP, "VOXEL_PASS_ZERO_OUT=1"),
        "search": (VOXEL_SWEEP,),
        "block_window": (VOXEL_SWEEP, "VOXEL_BLOCK_WINDOW=1"),
        "read_first": (VOXEL_SWEEP, "VOXEL_READ_FIRST=1"),
        "warp_max": (VOXEL_SWEEP, "VOXEL_WARP_MAX=1"),
        "probe_no_atomic": (VOXEL_SWEEP, "VOXEL_PROBE=1"),
        "probe_lookup_only": (VOXEL_SWEEP, "VOXEL_PROBE=2"),
    }),
}
# group -> (the kernel's name in ptxas, its occupancy query, the parent
# tree's source timed beside it)
KERNEL = {"shade": ("shade_kernel", "shade_occupancy", "lighting.cu"),
          "chain": ("bloom_down_chain", "bloom_down_chain_occupancy", None),
          "up": ("bloom_up_chain_kernel", "bloom_up_chain_occupancy", "post.cu"),
          "gbuffer": ("gbuffer_kernel", "gbuffer_occupancy", "gbuffer.cu"),
          "taa": ("taa_kernel", "taa_occupancy", None),
          "shafts": ("shafts_polar_kernel", "shafts_occupancy", "lighting.cu"),
          "lanes": ("gi_inputs_kernel", "gi_inputs_occupancy", "lighting.cu"),
          "sweep": ("sweep_ring_kernelILi8E", "sweep_occupancy", None),
          "voxelize": ("voxelize_pass_kernel", "voxelize_pass_occupancy", None)}


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _time(name, fn, check, rows, key, what):
    """Check fn's result, then time it as called and on the device alone."""
    chip_smoke.check(check(fn()), f"tile sweep {name}: not the plain version's bits")
    ms_min, ms = chip_smoke.cuda_ms(fn)
    dev_min, dev_ms = chip_smoke.cuda_ms(fn, hold=True)
    rows[key] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min)
    held = "a probe, not checked" if name.startswith("probe") else "bit-equal to the plain version"
    print(f"{name} {what}: {held}; {ms:.4f} ms median, {ms_min:.4f} "
          f"min as called; device {dev_ms:.4f} median, {dev_min:.4f} min (5 x 20 launches); "
          f"card {chip_smoke.nvidia_smi()}", flush=True)


def rgb_levels_check(lib, stride=3):
    """The sweep-only fast rgb level (sweep_variants.cu sweep_rgb_levels)
    against quantize_grid_u8 on the card over every `stride`-th f32 bit
    pattern from 0 to +inf, their negatives, NaN and inf: (values that
    differ, values checked)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    fn = lib.sweep_rgb_levels
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = total = 0
    for start in range(0, 0x7F800001, 1 << 26):
        x = torch.arange(start, min(start + (1 << 26), 0x7F800001), stride, dtype=torch.int64,
                         device="cuda").to(torch.int32).view(torch.float32)
        x = torch.cat([x, -x, torch.tensor([float("nan"), float("inf")], device="cuda")])
        got = torch.empty(x.shape, dtype=torch.uint8, device="cuda")
        err = fn(x.data_ptr(), got.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, f"sweep_rgb_levels failed: CUDA error {err}")
        want = gi.quantize_grid_u8(torch.stack([x, x, x, torch.zeros_like(x)], -1))[..., 0]
        bad += int((got != want).sum())
        total += x.numel()
    print(f"fast rgb level: {bad} of {total} values differ from quantize_grid_u8", flush=True)
    return {"differ": bad, "checked": total}


def parent_module(parent, name):
    """The parent tree's shade/<name>.py, loaded beside the package's (its
    relative imports resolve to this tree's modules): shadow for its shafts
    wrapper (its library() is swapped in by Libraries.use), gi_modes for
    its lane inputs' wrapper."""
    path = Path(parent) / "vulkan_pbr_renderer_tpu_torch" / "shade" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vulkan_pbr_renderer_tpu_torch.shade._parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Libraries:
    """Swaps the built library of a group's variant in where the package
    loads its own, and back."""

    def __init__(self):
        from vulkan_pbr_renderer_tpu_torch.shade import (bloom, gbuffer, gi, gi_modes, shadow,
                                                         taa)

        self.bloom, self.gbuffer, self.shadow, self.taa = bloom, gbuffer, shadow, taa
        self.gi, self.gi_modes = gi, gi_modes
        self.own = (shadow.library, bloom._library, gbuffer._library, taa._library,
                    gi._sweep_library, gi._voxel_library)
        self.parent_shadow = self.parent_gi_modes = None

    def use(self, group, lib, parent=False):
        self.restore()
        if group == "voxelize":
            for fn in ("voxelize_launch", "voxelize_pass_launch"):
                getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                getattr(lib, fn).restype = ctypes.c_int
            lib.decode_voxel_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p]
            lib.decode_voxel_launch.restype = ctypes.c_int
            self.gi._voxel_library = lambda: lib
        elif group == "sweep":
            lib.sweep_shared_bytes.argtypes = [ctypes.c_int] * 3
            lib.sweep_shared_bytes.restype = ctypes.c_int
            self.gi._sweep_library = lambda: lib
        elif group == "lanes":
            # the parent tree's launcher takes (args, stream), this tree's
            # (args, device, stream)
            lib.gi_inputs_launch.restype = ctypes.c_int
            lib.gi_inputs_launch.argtypes = [ctypes.c_void_p] + (
                [] if parent else [ctypes.c_int]) + [ctypes.c_void_p]
            if parent:
                self.parent_shadow.library = lambda: lib
            else:
                self.shadow.library = lambda: lib
        elif group == "taa":
            lib.taa_resolve_launch.restype = ctypes.c_int
            lib.taa_resolve_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            self.taa._library = lambda: lib
        elif group == "shafts":
            for name in ("shafts_polar_flags", "shafts_profile_launch", "shafts_pixel_launch"):
                if hasattr(lib, name):
                    getattr(lib, name).restype = ctypes.c_int
            if hasattr(lib, "shafts_polar_flags"):
                lib.shafts_polar_flags.argtypes = [ctypes.c_void_p]
            for name in ("shafts_profile_launch", "shafts_pixel_launch"):
                if hasattr(lib, name):   # the parent tree's two launches
                    getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            self.shadow.library = lambda: lib
            if self.parent_shadow is not None:
                self.parent_shadow.library = lambda: lib
        elif group == "shade":
            lib.shade_launch.restype = ctypes.c_int
            lib.shade_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            self.shadow.library = lambda: lib
        elif group == "gbuffer":
            lib.gbuffer_launch.restype = ctypes.c_int
            lib.gbuffer_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            self.gbuffer._library = lambda: lib
        else:
            for name in ("bloom_down_launch", "bloom_up_launch"):
                getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                getattr(lib, name).restype = ctypes.c_int
            for name in ("bloom_down_chain_units", "bloom_up_chain_units"):
                if hasattr(lib, name):
                    getattr(lib, name).argtypes = [ctypes.c_void_p]
                    getattr(lib, name).restype = ctypes.c_int
            self.bloom._library = lambda: lib
        self._clear()

    def restore(self):
        (self.shadow.library, self.bloom._library, self.gbuffer._library,
         self.taa._library, self.gi._sweep_library, self.gi._voxel_library) = self.own
        self._clear()

    def _clear(self):
        # the chains' and the shafts' launchers and plans (flags sized by the
        # tile or the band) follow the library
        for cached in (self.bloom._chain_launcher, self.bloom._up_chain_launcher,
                       self.bloom._chain_plan, self.bloom._up_chain_plan,
                       self.shadow._shafts_launcher, self.shadow._shaft_plan,
                       self.gi_modes._lanes_launcher, self.gi._sweep_launcher,
                       self.gi._sweep_plan):
            cached.cache_clear()

    def occupancy(self, group):
        from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
        from vulkan_pbr_renderer_tpu_torch.shade import lighting

        if group == "shade":
            return lighting.shade_occupancy()
        if group == "gbuffer":
            return self.gbuffer.gbuffer_occupancy()
        if group == "taa":   # taa_sweep.cu's tiled kernel
            return cuda_build.query_ints(self.taa._library(), "taa_occupancy", (
                "registers", "local_bytes", "shared_bytes", "blocks_per_sm", "tile_w", "tile_h",
                "margin"))
        if group == "shafts":
            return self.shadow.shafts_occupancy()
        if group == "lanes":
            return cuda_build.query_ints(self.shadow.library(), "gi_inputs_occupancy", (
                "registers", "local_bytes", "shared_bytes", "blocks_per_sm"))
        if group == "sweep":
            return self.gi.sweep_occupancy(128)
        if group == "voxelize":   # the pass's kernel and the int64 kernel
            return {k: cuda_build.query_ints(self.gi._voxel_library(), fn, (
                "registers", "local_bytes", "blocks_per_sm"))
                for k, fn in (("pass", "voxelize_pass_occupancy"),
                              ("int64", "voxelize_occupancy"))}
        if group == "up":
            return self.bloom.up_chain_occupancy()
        regs, blocks, threads = self.bloom.chain_occupancy()
        return dict(registers=regs, blocks_per_sm=blocks, threads=threads)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--groups", default=",".join(GROUPS))
    parser.add_argument("--out", default="chiprun_out/tile_sweep.json")
    parser.add_argument("--variants", default="",
                        help="comma-separated variant names to build and time (default: all)")
    args = parser.parse_args()
    groups = [g for g in args.groups.split(",") if g]
    chip_smoke.check(set(groups) <= set(GROUPS), f"tile sweep: groups {groups} not in {GROUPS}")
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build, sampling
    from vulkan_pbr_renderer_tpu_torch.shade import bloom, gi, gi_modes, lighting, shadow, taa
    from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as gb

    # (group, name) -> (library name, defines, source)
    builds = {}
    for g in groups:
        src, variants = VARIANTS[g]
        parent_src = KERNEL[g][2]
        if args.parent and parent_src:
            builds[g, "parent"] = (f"{src}_parent", (), Path(args.parent)
                                   / "vulkan_pbr_renderer_tpu_torch" / "csrc" / parent_src)
        for name, d in variants.items():
            if args.variants and name not in args.variants.split(","):
                continue
            if d is None:
                builds[g, name] = ("shafts_sweep", (), SWEEP_SOURCE)
            elif d and isinstance(d[0], Path):
                builds[g, name] = (d[0].stem, d[1:], d[0])
            else:
                builds[g, name] = (src, d, None)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(lambda b: cuda_build.build(*b), builds.values())))
    swap = Libraries()
    if args.parent and ("shafts" in groups or "lanes" in groups):
        swap.parent_shadow = parent_module(args.parent, "shadow")
    if args.parent and "lanes" in groups:
        swap.parent_gi_modes = parent_module(args.parent, "gi_modes")
        swap.parent_gi_modes.shadow = swap.parent_shadow
    libs, rows = {}, {g: {} for g in groups}
    for (g, name), (path, seconds, log) in built.items():
        libs[g, name] = _load(path)
        # the parent's up kernel is its per-level one (bloom_up_level), the
        # inline shafts' its own; a parent tree's kernel may have no
        # occupancy query (and the inline library's is the banded kernel's)
        kernel = {("up", "parent"): "bloom_up_kernel",
                  ("shafts", "inline"): "shafts_inline_kernel"}.get((g, name), KERNEL[g][0])
        if builds[g, name][2] == TAA_SWEEP:
            kernel = "taa_sweep_kernel"
        if builds[g, name][2] == LANES_SWEEP:
            kernel = "gi_inputs_tiled_kernel"
        if builds[g, name][2] == VOXEL_SWEEP:   # its int64 kernel, or its fork of the pass
            kernel = ("voxelize_pass_fork_kernel" if name.startswith("pass")
                      else "voxelize_sweep_kernel")
        if builds[g, name][2] == SWEEP_VARIANTS:   # the replay kernel, or the variant's
            defs = dict(d.split("=") for d in builds[g, name][1])   # at 128 voxels a line
            kernel = ("lightgrid_sweep_kernel" if defs.get("SWEEP_REPLAY_ALL") == "1" else
                      f"sweep_ring_variant_kernelILi{128 // int(defs.get('SWEEP_LANES', 16))}E")
        occ = None
        if hasattr(libs[g, name], KERNEL[g][1]) and (g, name) != ("shafts", "inline"):
            swap.use(g, libs[g, name], name == "parent")
            occ = swap.occupancy(g)
        ptxas = chip_smoke._ptxas_entry(log, kernel)
        rows[g][name] = {"defines": list(builds[g, name][1]), "ptxas": ptxas, "occupancy": occ}
        print(f"{g} {name}: {' '.join(builds[g, name][1]) or 'defaults'}: built in {seconds:.1f} "
              f"s; ptxas {kernel} {ptxas}; occupancy {occ}", flush=True)
    # the frames below launch the package's own kernels
    swap.restore()

    cfg = SUNTEMPLE_1080P
    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    r = Renderer(cfg, scene, device="cuda")
    cams = [make_camera(*suntemple.camera_path(i / (chip_smoke.N_FRAMES - 1)), cfg,
                        device="cuda") for i in range(2)]
    calls = chip_smoke.capture_slice_calls(r, cams)
    shade_args, shade_kw = calls["shade"]
    shade_want = lighting.shade_plain(*shade_args, **shade_kw)
    sky = float((~shade_args[0].coverage).float().mean())
    ga, gk = calls["gbuffer"]
    g_plain_args = (ga[0], gk["static"], ga[1], ga[2], ga[3], ga[4], ga[5], ga[6],
                    gk["world_from_clip"], gk["jitter"], gk["material_filter"],
                    gk["frame_idx_mod_59"])
    g_want = gb.gbuffer_pass_plain(*g_plain_args)
    post_in = chip_smoke.capture_post_call(r, cams)
    # TAA also on a slow camera's frame 1: the path's first step cut by
    # SLOW_STEP (path A's frames are 1/7 of the path apart)
    slow_cam = make_camera(*suntemple.camera_path(1 / (chip_smoke.N_FRAMES - 1) / SLOW_STEP), cfg,
                           device="cuda")
    post_slow = chip_smoke.capture_post_call(r, [cams[0], slow_cam])
    hdr = taa.taa_resolve_plain(*post_in, cfg.taa_blend, cfg.taa_velocity_rejection,
                                catmull_history=cfg.taa_catmull_history,
                                full_rgb_catmull=cfg.taa_full_rgb_catmull)
    passes = cfg.bloom_pass_count
    atlas, offs = bloom.new_atlas(cfg.height, cfg.width, passes, hdr.device)
    plain_chain = chip_smoke._down_plain_chain(hdr, passes)
    plain_atlas = sampling.pack_mip_atlas(plain_chain).to(torch.bfloat16)
    up_args = (plain_chain[-1].contiguous(), cfg.height, cfg.width, passes, cfg.bloom_strength,
               hdr, cfg.exposure)
    up_want = bloom.bloom_up_chain_plain(*up_args)
    sizes = bloom.chain_sizes(cfg.height, cfg.width, passes)
    # the up chain cut before its last k levels (levels 1..k left out; a
    # zero base), and its last level alone on the plain chain's level 1
    up_cuts = {k: (plain_chain[-1].contiguous(), *sizes[k], passes - k, 1.0,
                   torch.zeros(sizes[k] + (3,), device=hdr.device))
               for k in range(1, passes)}
    up_last = (bloom.bloom_up_chain_plain(*up_cuts[1]), cfg.height, cfg.width, 1,
               cfg.bloom_strength, hdr, cfg.exposure)
    # the last level alone, with and without the tonemap (what it costs)
    up_lasts = {"last_level": up_last, "last_level_no_tonemap": up_last[:6] + (None,)}
    up_cut_want = {k: bloom.bloom_up_chain_plain(*c) for k, c in up_cuts.items()}
    up_lasts_want = {k: bloom.bloom_up_chain_plain(*c) for k, c in up_lasts.items()}

    def chain(n):
        return lambda: bloom.bloom_down_chain(hdr, n, atlas, offs)

    def chain_same(got):
        return (all(bool(torch.equal(g, w)) for g, w in zip(got, plain_chain))
                and bool(torch.equal(atlas.view(torch.int16), plain_atlas.view(torch.int16))))

    def gbuffer_same(got):
        return all(bool(torch.equal(a, b)) for a, b in zip(got, g_want))

    taa_kw = dict(blend=cfg.taa_blend, velocity_rejection=cfg.taa_velocity_rejection,
                  catmull_history=cfg.taa_catmull_history,
                  full_rgb_catmull=cfg.taa_full_rgb_catmull)
    taa_inputs = {"": (post_in, hdr), "slow_": (post_slow, taa.taa_resolve_plain(*post_slow,
                                                                                 **taa_kw))}
    motion = {}
    for key, (ins, _) in taa_inputs.items():   # mean |velocity| in pixels, x and y
        v = ins[2].abs().mean((0, 1)).tolist()
        motion[key or "path_a"] = [v[0] * 0.5 * cfg.width, v[1] * 0.5 * cfg.height]
    print(f"taa inputs: mean |velocity| in pixels (x, y): {motion}", flush=True)
    sa, sk = calls["shafts_polar"]
    shafts_want = shadow.shafts_polar_plain(*sa[:9], torch.as_tensor(sa[9], device=hdr.device),
                                            *sa[10:], **sk)
    la, lk = calls["gi_inputs"]
    lanes_want = gi_modes.gi_lane_inputs_plain(*la, **lk)
    (grid, _, *sweep_params), _ = calls["sweep"]
    sweep_want = {}
    for axis in (0, 1, 2):
        swept = gi.sweep_lightgrid(grid, axis, *sweep_params)
        sweep_want[axis] = (swept, gi.quantize_grid_u8(swept))

    voxel_calls = (chip_smoke.capture_voxelize_calls(r, cfg) if "voxelize" in groups else {})
    voxel_words = {f: gi.voxelize_scene_plain(*va, **{k: v for k, v in vk.items() if k != "plan"})
                   for f, (va, vk) in voxel_calls.items()}
    voxel_want = {f: gi.decode_voxel_grid_plain(w) for f, w in voxel_words.items()}

    def lanes_same(got):
        return all(bool(torch.equal(a, b)) for a, b in zip(got, lanes_want) if b is not None)

    for g in groups:
        names = list(rows[g])
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                swap.use(g, libs[g, name], name == "parent")
                row = rows[g][name]
                if g == "chain":
                    _time(name, chain(passes), chain_same, row, f"round{rnd}",
                          f"round {rnd}, {passes} levels")
                    for n in range(1, passes):
                        _time(name, chain(n), lambda got, n=n: all(
                            bool(torch.equal(a, b)) for a, b in zip(got, plain_chain[:n])),
                              row, f"levels{n}_round{rnd}", f"round {rnd}, levels 1-{n}")
                elif g == "up":
                    # the parent tree's chain: its per-level launches
                    fn = ((lambda: chip_smoke._up_levels(*up_args, None)) if name == "parent"
                          else (lambda: bloom.bloom_up_chain(*up_args)))
                    _time(name, fn, lambda got: bool(torch.equal(got, up_want)), row,
                          f"round{rnd}", f"round {rnd}, {passes} levels + tonemap")
                    if name == "parent":
                        continue
                    for k, c in up_cuts.items():
                        _time(name, lambda c=c: bloom.bloom_up_chain(*c),
                              lambda got, k=k: bool(torch.equal(got, up_cut_want[k])), row,
                              f"without_last{k}_round{rnd}",
                              f"round {rnd}, levels {passes}..{k + 1} (to {sizes[k]})")
                    for key, c in up_lasts.items():
                        _time(name, lambda c=c: bloom.bloom_up_chain(*c),
                              lambda got, key=key: bool(torch.equal(got, up_lasts_want[key])),
                              row, f"{key}_round{rnd}", f"round {rnd}, {key.replace('_', ' ')}")
                elif g == "gbuffer":
                    _time(name, lambda: gb.gbuffer_pass(*ga, **gk), gbuffer_same, row,
                          f"round{rnd}", f"round {rnd}")
                elif g == "taa":
                    for key, (ins, want) in taa_inputs.items():
                        _time(name, lambda ins=ins: taa.taa_resolve(*ins, **taa_kw),
                              lambda got, want=want: bool(torch.equal(got, want)), row,
                              f"{key}round{rnd}", f"{key}round {rnd}")
                elif g == "sweep":
                    for axis, (want, want_table) in sweep_want.items():
                        _time(name, lambda axis=axis: gi.sweep_lightgrid_u8(grid, axis,
                                                                            *sweep_params),
                              lambda got, w=want, t=want_table: name.startswith("probe") or (
                                  bool(torch.equal(got[0], w)) and bool(torch.equal(got[1], t))),
                              row, f"axis{axis}_round{rnd}", f"round {rnd}, axis {axis}")
                elif g == "voxelize":
                    # the one-launch pass (the package's builds and the
                    # sweep-only fork of it), and beside the default build its
                    # int64 route; the other sweep-only builds: their int64
                    # kernel with the package's decode
                    routes = ({"": "pass", "int64_": "int64"} if name == "pass" else
                              {"": "pass"} if name.startswith("pass") else {"": "int64"})
                    for f, (va, vk) in voxel_calls.items():
                        if name != "pass" and routes.get("") == "pass":
                            # another pass build: a plan (and a word grid) of its own, so
                            # that the package's finds its plan's words zero
                            vk = {**vk, "plan": gi._VoxelPlan(
                                va[0], *va[1:3], vk.get("samples_per_voxel_area", 4.0),
                                vk["total_samples"])}
                        for prefix, route in routes.items():
                            fn = ((lambda va=va, vk=vk: gi.voxelize_lightgrid(*va, **vk))
                                  if route == "pass" else
                                  (lambda va=va, vk=vk: gi.decode_voxel_grid(
                                      gi.voxelize_scene(*va, **vk))))
                            _time(name, fn, lambda got, w=voxel_want[f]: name.startswith(
                                "probe") or bool(torch.equal(got.view(torch.int32),
                                                             w.view(torch.int32))),
                                  row, f"{prefix}frame{f}_round{rnd}",
                                  f"round {rnd}, frame {f}, {route}")
                            chip_smoke.check(name.startswith("probe") or torch.equal(
                                fn().view(torch.int32), voxel_want[f].view(torch.int32)),
                                f"tile sweep {name}: not the plain version's bits after timing")
                        if route == "int64":   # the int64 kernel alone (with its memset)
                            _time(name, lambda va=va, vk=vk: gi.voxelize_scene(*va, **vk),
                                  lambda got, w=voxel_words[f]: name.startswith("probe") or bool(
                                      torch.equal(got, w)), row, f"kernel_frame{f}_round{rnd}",
                                  f"round {rnd}, frame {f}, the int64 kernel alone")
                elif g == "lanes":
                    # the parent tree: its own wrapper (no plan)
                    mod = swap.parent_gi_modes if name == "parent" else gi_modes
                    _time(name, lambda mod=mod: mod.gi_lane_inputs(*la, **lk), lanes_same, row,
                          f"round{rnd}", f"round {rnd}")
                elif g == "shafts":
                    # the parent tree: its own wrapper (two launches)
                    mod = swap.parent_shadow if name == "parent" else shadow
                    _time(name, lambda mod=mod: mod.shafts_polar(*sa, **sk),
                          lambda got: bool(torch.equal(got, shafts_want)), row, f"round{rnd}",
                          f"round {rnd}")
                else:
                    _time(name, lambda: lighting.shade(*shade_args, **shade_kw),
                          lambda got: bool(torch.equal(got, shade_want)), row,
                          f"round{rnd}", f"round {rnd}")
        swap.restore()
    levels = {name: rgb_levels_check(libs[g, name]) for (g, name) in libs
              if g == "sweep" and "SWEEP_FAST_LEVEL=1" in builds[g, name][1]}
    result = {"card": chip_smoke.nvidia_smi(), "shape": list(shade_want.shape[:2]),
              "uncovered_share": sky, "taa_motion_px": motion, "variants": rows,
              "fast_level_check": levels}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
