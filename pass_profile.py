#!/usr/bin/env python3
"""Per-pass times of the port's frame on one GPU (paths A, D and C of chip_smoke.py).

Run from the repository root:

    python3 pass_profile.py [--out chiprun_out/pass_profile.json]

For SUNTEMPLE_1080P (path A: fast GI, folded kernel K1),
SUNTEMPLE_1080P_HIZ (path D: K1's hierarchical-z variant) and
SUNTEMPLE_1080P_REFERENCE (path C: the reference GI), on chip_smoke.py's
638,700-triangle SunTemple stand-in, camera path and sun schedule (8 frames,
the sun moving on frame 5):

  1. wraps each pass's function from the outside (nothing in the package
     changes) in torch.cuda.synchronize() + a host timer and renders the 8
     frames: ms per pass, the mean over the steady frames 1-4, the sun pass
     and voxelize from frame 5.  Sync-wrapped frames run slower than
     unwrapped ones: every pass waits for the device.  The GI block is
     gi_modes.gi_pass; inside it, the fast GI's rays are one
     gi.fast_ray_resolve call each ("GI rays (kernel)", the CUDA kernel),
     and a tree whose GI rays still run the plain marches reports them as
     "fog march" and "screen trace"; the reference GI's rays are one
     gi.reference_ray_resolve call each ("GI rays (reference kernel)"), or
     in a tree before that kernel one gi.sample_radiance_with_screen_trace
     call each ("GI rays (reference, eager)").  Where the tree has the G-buffer and
     lighting kernels, lighting also splits into the GI lane inputs
     (gi_modes.gi_lane_inputs, inside the GI block), the polar shafts
     (shadow.shafts_polar, one launch; two in a tree before its plan) and
     the full-resolution shade (lighting.shade); else the shafts are
     shadow.light_shafts_polar;
     Setup is transform_and_setup (one kernel), or in an older tree
     transform_to_clip + setup_triangles, under one label;
  2. removes the wrappers and renders 8 more frames: frames 0-5 each timed
     alone (synchronised; the steady mean over frames 1-4), the last two
     under torch.profiler: device ms per frame (the sum of the device time
     of every kernel and copy), device events per frame, the device's busy
     share of the profiled wall time, the eight largest device items, and
     the device time of every gather and indexing kernel by the pass that
     launched it, and each top-level pass's device ms and kernels per frame
     (each pass's function wrapped in a record_function range during the
     profiled frames only, no synchronize).  Post's split: TAA, the bloom
     down chain (bloom_down_chain: one launch, or in an older tree a launch
     per level) and the up chain with the tonemap (bloom_up_chain: one
     launch, or in an older tree a launch per level), where the tree has the
     kernels, else bloom_with_pyramid;
  3. the last frame's camera raster pass (renderer._rasterize) and its setup
     alone under torch.profiler: device events (every kernel, the port's
     ctypes-launched ones included, memsets and copies) and device ms; and
     so the voxelize pass (gi.voxelize_lightgrid with the state's plan; in
     a tree before it gi.voxelize_scene + gi.decode_voxel_grid) on the
     inputs of frame 5, which moved the sun (its sun map and matrices), and
     the GI block (gi_modes.gi_pass, both rays) on frame 4's inputs.

The voxelize row of step 1 is gi.voxelize_lightgrid (in a tree before it,
gi.voxelize_scene and gi.decode_voxel_grid together).

Writes the JSON to --out (chiprun_out/pass_profile.json) and prints it; the
last line is the card's name and power limit.  Fails without a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from collections import defaultdict
from pathlib import Path

import torch

import chip_smoke

STEADY = (1, 2, 3, 4)


class PassTimers:
    """Wrap functions in synchronize + host timers; ms per (frame, label).
    With ranges=True, wrap them in torch.profiler.record_function ranges
    named "pass: <label>" instead (no synchronize, no timer)."""

    def __init__(self, ranges=False):
        self.ms = defaultdict(float)
        self.frame = 0
        self.ranges = ranges
        self._undo = []

    def wrap(self, owner, name, label):
        fn = getattr(owner, name)

        @functools.wraps(fn)   # carries the wrappers' launch counters over
        def timed(*args, **kwargs):
            what = label(*args, **kwargs) if callable(label) else label
            if self.ranges:
                with torch.profiler.record_function(f"pass: {what.strip()}"):
                    return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[(self.frame, what)] += (time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def unwrap(self):
        for owner, name, fn in reversed(self._undo):
            fn.__dict__.update({k: v for k, v in getattr(owner, name).__dict__.items()
                                if k != "__wrapped__"})
            setattr(owner, name, fn)
        self._undo.clear()


def wrap_passes(timers):
    from vulkan_pbr_renderer_tpu_torch.app import renderer
    from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2
    from vulkan_pbr_renderer_tpu_torch.shade import gi, gi_modes

    state = {"pass": "camera"}

    def raster_label(*args, cull="back", **kwargs):
        state["pass"] = "sun" if cull == "none" else "camera"
        return f"raster pass ({state['pass']})"

    timers.wrap(renderer, "_rasterize", raster_label)
    if hasattr(renderer.rsetup, "transform_and_setup"):   # one kernel launch
        timers.wrap(renderer.rsetup, "transform_and_setup",
                    lambda *a, **k: f"  setup ({state['pass']})")
    else:   # a tree before the setup kernel: the plain composition's two calls
        for name in ("transform_to_clip", "setup_triangles"):
            timers.wrap(renderer.rsetup, name, lambda *a, **k: f"  setup ({state['pass']})")
    timers.wrap(visibility_v2, "bin_triangles", lambda *a, **k: f"  binning ({state['pass']})")
    for name in ("vis_folded_tiles", "vis_folded_hiz_tiles"):
        timers.wrap(visibility_v2, name, lambda *a, **k: f"  kernel ({state['pass']})")
    if hasattr(renderer.gi, "voxelize_lightgrid"):   # the pass in one launch
        timers.wrap(renderer.gi, "voxelize_lightgrid", "p2 voxelize")
    else:   # a tree before it: the words, then the decode
        timers.wrap(renderer.gi, "voxelize_scene", "p2 voxelize")
        timers.wrap(renderer.gi, "decode_voxel_grid", "p2 voxelize")
    timers.wrap(renderer, "sweep_rotated", "p3 sweep")
    timers.wrap(renderer.gb, "gbuffer_pass", "p4 G-buffer")
    timers.wrap(renderer.lighting, "lighting_pass", "p5 lighting, total")
    timers.wrap(gi_modes, "gi_pass", "  GI block (gi_pass, 2 rays)")
    if hasattr(gi_modes, "gi_lane_inputs"):
        timers.wrap(gi_modes, "gi_lane_inputs", "    GI lane inputs (kernel)")
    if hasattr(gi, "fast_ray_resolve"):
        timers.wrap(gi, "fast_ray_resolve", "    GI rays (kernel)")
    if hasattr(gi, "reference_ray_resolve"):
        timers.wrap(gi, "reference_ray_resolve", "    GI rays (reference kernel)")
    timers.wrap(gi, "sample_radiance_with_screen_trace", "    GI rays (reference, eager)")
    if hasattr(renderer.shadow, "shafts_polar"):
        # one launch since the shafts' plan (shadow._shaft_plan), two before
        one = hasattr(renderer.shadow, "_shaft_plan")
        timers.wrap(renderer.shadow, "shafts_polar",
                    "  shafts (kernel, 1 launch)" if one else "  shafts (kernel, 2 launches)")
        timers.wrap(renderer.lighting, "shade", "  shade (kernel)")
    else:
        timers.wrap(renderer.shadow, "light_shafts_polar", "  shafts")
    timers.wrap(gi, "sample_radiance_fog", "    fog march")
    timers.wrap(gi, "screen_trace_linear", "    screen trace")
    timers.wrap(renderer, "post_stack", "p6-9 post")
    timers.wrap(renderer.taa, "taa_resolve", "  TAA")
    if hasattr(renderer.bloom_mod, "bloom_down_level"):
        # the whole down chain: one launch, or one launch a level in a tree
        # whose chain calls bloom_down_level in turn
        timers.wrap(renderer.bloom_mod, "bloom_down_chain", "  bloom down chain (kernel)")
        # the whole up chain and the tonemap: one launch, or one launch a
        # level in a tree whose chain calls bloom_up_level in turn
        timers.wrap(renderer.bloom_mod, "bloom_up_chain", "  bloom up chain + tonemap (kernel)")
    else:
        timers.wrap(renderer.bloom_mod, "bloom_with_pyramid", "  bloom")


def gathers_by_pass(prof):
    """(pass, kernel) -> [device ms, calls] of the gather and indexing
    kernels under the profiler: each kernel is charged to the innermost
    "pass: " range around the host call that launched it."""
    out = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        for k in getattr(e, "kernels", None) or []:
            if "gather" not in k.name.lower() and "index" not in k.name.lower():
                continue
            p, where = e, "outside the wrapped passes"
            while p is not None:
                if p.name.startswith("pass: "):
                    where = p.name[len("pass: "):]
                    break
                p = p.cpu_parent
            out[(where, k.name[:80])][0] += k.duration / 1e3
            out[(where, k.name[:80])][1] += 1
    return out


def kernels_by_top_pass(prof):
    """pass -> [device ms, kernels] under the profiler: each kernel charged
    to the outermost "pass: " range around the host call that launched it
    (a pass's launches, its sub-passes' included).  The port's own kernels,
    launched through ctypes, have no PyTorch operator to hang on and count
    under no pass: the total's events less these are theirs."""
    out = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or []
        if not kernels:
            continue
        p, where = e, "outside the wrapped passes"
        while p is not None:
            if p.name.startswith("pass: "):
                where = p.name[len("pass: "):]
            p = p.cpu_parent
        for k in kernels:
            out[where][0] += k.duration / 1e3
            out[where][1] += 1
    return out


SENTINEL = "spin_kernel"    # torch.cuda._sleep's kernel
# device sleeps queued on each side of the call: after a session of some
# 36,000 device events (path C's eager march in a tree before its kernel)
# the next sessions lost their first two device events every time, so the
# lead is long enough to lose a few and still start with a sleep
SLEEPS = 8
PADS_S = (0.02, 0.2, 1.0)   # host seconds a session idles at each end, a try each


def device_events(fn):
    """(device events, device ms) of one call of fn alone under
    torch.profiler, after a warm-up call: every kernel, memset and copy it
    queues, the port's ctypes-launched kernels included.  A session can
    lose the device events near its start, or all of them
    (profiler_probe.py), so the session idles on the host at each end and
    the call sits between SLEEPS short device sleeps on each side, which
    are not counted.  A session counts only where its first and last
    device events are sleeps; else the next try idles longer, and after
    len(PADS_S) tries it raises."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    lost = []
    for pad in PADS_S:
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(pad)
            for _ in range(SLEEPS):
                torch.cuda._sleep(1000)
            fn()
            for _ in range(SLEEPS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
        cuda = torch.autograd.DeviceType.CUDA
        order = sorted((e for e in prof.events() if e.device_type == cuda),
                       key=lambda e: e.time_range.start)
        marks = "".join("S" if SENTINEL in e.name else "k" for e in order)
        if not (marks.startswith("S") and marks.endswith("S") and marks.count("S") >= 2):
            lost.append(f"{pad} s: {marks or '(nothing)'}")
            print(f"device_events: a session lost its edge events (idle {pad} s a side; device "
                  f"events in order, S a sleep: {marks or '(nothing)'}); trying again", flush=True)
            continue
        events, us = 0, 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if e.device_type == cuda and t > 0 and SENTINEL not in e.key:
                events += e.count
                us += t
        return events, us / 1e3
    raise RuntimeError("device_events: every profiler session lost its edge events ("
                       + "; ".join(lost) + ")")


def _frames(r, cfg, n):
    from vulkan_pbr_renderer_tpu_torch.app.renderer import make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple

    for i in range(n):
        cam = make_camera(*suntemple.camera_path(i / (chip_smoke.N_FRAMES - 1)), cfg,
                          device="cuda")
        sun = chip_smoke.SUN_MOVED if i >= chip_smoke.SUN_MOVE_FRAME else chip_smoke.SUN
        yield i, cam, sun


def profile_path(name, cfg, scene):
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer

    n = chip_smoke.N_FRAMES
    # 1. sync-wrapped passes
    r = Renderer(cfg, scene, device="cuda")
    timers = PassTimers()
    wrap_passes(timers)
    try:
        for i, cam, sun in _frames(r, cfg, n):
            timers.frame = i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(cam, sun)
            torch.cuda.synchronize()
            timers.ms[(i, "frame")] = (time.perf_counter() - t0) * 1e3
    finally:
        timers.unwrap()
    labels = []
    for (_, what) in timers.ms:
        if what not in labels:
            labels.append(what)
    passes = {}
    for what in labels:
        per_frame = [timers.ms.get((i, what)) for i in range(n)]
        steady = [per_frame[i] for i in STEADY if per_frame[i] is not None]
        passes[what] = {"steady_mean_ms": sum(steady) / len(steady) if steady else None,
                        "sun_move_frame_ms": per_frame[chip_smoke.SUN_MOVE_FRAME]}
    for what, v in passes.items():
        steady = "-" if v["steady_mean_ms"] is None else f"{v['steady_mean_ms']:.2f}"
        moved = "-" if v["sun_move_frame_ms"] is None else f"{v['sun_move_frame_ms']:.2f}"
        print(f"path {name}: {what:34s} steady {steady:>8s} ms   frame "
              f"{chip_smoke.SUN_MOVE_FRAME} {moved:>8s} ms", flush=True)

    # 2. unwrapped frames, the last two under the profiler; the GI block's
    # call of the last steady frame kept for step 3
    from vulkan_pbr_renderer_tpu_torch.shade import gi_modes

    r = Renderer(cfg, scene, device="cuda")
    frames = list(_frames(r, cfg, n))
    frame_ms, gi_call, gi_pass = [], {}, gi_modes.gi_pass

    @functools.wraps(gi_pass)
    def record(*args, **kwargs):
        if gi_call.get("frame") == STEADY[-1]:
            gi_call["call"] = (args, kwargs)
        return gi_pass(*args, **kwargs)

    gi_modes.gi_pass = record
    try:
        for i, cam, sun in frames[:-2]:
            gi_call["frame"] = i
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(cam, sun)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        gi_modes.gi_pass = gi_pass
    steady_ms = sum(frame_ms[i] for i in STEADY) / len(STEADY)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ranges = PassTimers(ranges=True)
    wrap_passes(ranges)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(PADS_S[0])   # see device_events: keeps the session's edge events
            t0 = time.perf_counter()
            for i, cam, sun in frames[-2:]:
                r.render(cam, sun)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PADS_S[0])
    finally:
        ranges.unwrap()

    def device_us(e):   # the attribute's name before PyTorch 2.4 was self_cuda_time_total
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side entries only: an operator's entry repeats its kernels' time,
    # and a "pass: " range's annotation on the device timeline spans them
    device = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
              and not e.key.startswith("pass: ")]
    device.sort(key=lambda x: -x[1])
    device_ms = sum(x[1] for x in device)
    events = sum(x[2] for x in device)
    chip_smoke.check(device_ms > 0.0, "torch.profiler recorded no device time")
    out = {"passes": passes, "frame_ms": frame_ms, "steady_frame_ms": steady_ms,
           "profiled_frames": 2, "profiled_wall_ms": wall_ms,
           "device_ms_per_frame": device_ms / 2, "device_events_per_frame": events / 2,
           "device_busy_share": device_ms / wall_ms,
           "largest_device_items": [{"name": k[:80], "ms": ms, "calls": c}
                                    for k, ms, c in device[:8]]}
    gathers = sorted(gathers_by_pass(prof).items(), key=lambda kv: -kv[1][0])
    out["gathers_by_pass"] = [{"pass": where, "name": k, "ms": ms, "calls": c}
                              for (where, k), (ms, c) in gathers]
    top = sorted(kernels_by_top_pass(prof).items(), key=lambda kv: -kv[1][0])
    out["kernels_by_pass"] = [{"pass": where, "device_ms_per_frame": ms / 2,
                               "kernels_per_frame": c / 2} for where, (ms, c) in top]
    print(f"path {name}: unwrapped frames 0-5 ms " + " ".join(f"{t:.2f}" for t in frame_ms)
          + f"; steady mean {steady_ms:.2f} ms", flush=True)
    print(f"path {name}: profiled frames 6-7 (unwrapped): wall {wall_ms / 2:.2f} ms per frame, "
          f"device {device_ms / 2:.2f} ms per frame, {events / 2:.0f} device events per frame, "
          f"busy share {100 * device_ms / wall_ms:.1f}%", flush=True)
    for k, ms, c in device[:8]:
        print(f"path {name}:   {ms:9.2f} ms {c:6d} calls  {k[:80]}", flush=True)
    print(f"path {name}: device ms and kernels per frame by top-level pass:", flush=True)
    for where, (ms, c) in top:
        print(f"path {name}:   {ms / 2:9.3f} ms {c / 2:8.1f} kernels  {where}", flush=True)
    # 3. the camera raster pass alone (the last frame's camera), and its setup
    from vulkan_pbr_renderer_tpu_torch.app import renderer as rmod

    _, cam, sun = frames[-1]
    fi = rmod.frame_inputs(r.state, cam, sun, cfg)
    tri_pos = r.scene.tri_attr[:, :9].reshape(-1, 3, 3)
    if hasattr(rmod.rsetup, "transform_and_setup"):
        def setup():
            return rmod.rsetup.transform_and_setup(tri_pos, cam.clip_from_world, cfg.width,
                                                   cfg.height, cull="back", jitter=fi.jitter)
    else:
        def setup():
            return rmod.rsetup.setup_triangles(rmod.rsetup.transform_to_clip(
                tri_pos, cam.clip_from_world, fi.jitter), cfg.width, cfg.height, cull="back")
    raster = (lambda: rmod._rasterize(r.scene, cam.clip_from_world, cfg.width, cfg.height, cfg,
                                      jitter=fi.jitter, cull="back", backend=r.raster_backend))
    # the voxelize pass on frame 5's inputs: the state's sun map is the moved
    # sun's (frames 5-7), and so are the last frame's matrices
    emission = cfg.voxelize_sun_emission_scale * torch.tensor(cfg.sun_color, device="cuda")

    if hasattr(rmod.gi, "voxelize_lightgrid"):   # one launch, the state's plan passed in
        def voxelize():
            return rmod.gi.voxelize_lightgrid(
                r.scene, cfg.lightgrid_size, cfg.lightgrid_scale, r.state.sun_depth,
                fi.sun_from_world, fi.sun_dir, emission, total_samples=r.cfg.voxelize_samples,
                plan=rmod.voxel_plan(r.state, r.scene, r.cfg))
    else:   # a tree before it: a memset and two kernels
        def voxelize():
            return rmod.gi.decode_voxel_grid(rmod.gi.voxelize_scene(
                r.scene, cfg.lightgrid_size, cfg.lightgrid_scale, r.state.sun_depth,
                fi.sun_from_world, fi.sun_dir, emission, total_samples=r.cfg.voxelize_samples))

    alone = [("camera raster pass", raster), ("  its setup", setup),
             ("voxelize pass (frame 5's inputs)", voxelize)]
    if "call" in gi_call:
        args, kwargs = gi_call["call"]
        alone.append((f"GI block (frame {STEADY[-1]}'s inputs)",
                      lambda: gi_modes.gi_pass(*args, **kwargs)))
    for what, fn in alone:
        n_ev, ms = device_events(fn)
        out.setdefault("alone", {})[what.strip()] = {"device_events": n_ev, "device_ms": ms}
        print(f"path {name}: {what} alone: {n_ev} device events, {ms:.3f} ms of device time",
              flush=True)
    print(f"path {name}: gather and indexing kernels by pass (2 frames):", flush=True)
    for (where, k), (ms, c) in gathers:
        print(f"path {name}:   {ms:9.2f} ms {c:6d} calls  {where:28s} {k[:60]}", flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/pass_profile.json")
    args = parser.parse_args()
    chip_smoke.phase_card()
    chip_smoke.phase_build()
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import (SUNTEMPLE_1080P, SUNTEMPLE_1080P_HIZ,
                                                      SUNTEMPLE_1080P_REFERENCE)

    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    result = {"card": chip_smoke.nvidia_smi(), "paths": {}}
    for name, cfg in (("A", SUNTEMPLE_1080P), ("D", SUNTEMPLE_1080P_HIZ),
                      ("C", SUNTEMPLE_1080P_REFERENCE)):
        result["paths"][name] = profile_path(name, cfg, scene)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
