#!/usr/bin/env python3
"""Sweep of the reference-GI ray kernel's designs and probes on one GPU.

Run from the repository root:

    python3 reference_sweep.py [--parent DIR] [--variants a,b,...]
                               [--out build/reference_sweep.json]

Builds the package's csrc/gi_reference_ray.cu and the sweep-only
reference_sweep.cu once per set of compile-time values (`-D`, all builds
started together) and prints each build's ptxas registers and spills, its
resident blocks an SM and its static shared memory.  On the real lanes of
path C's diffuse and specular rays and C-product's diffuse ray (frame 1 of
SUNTEMPLE_1080P_REFERENCE at 1920x1088 and REFERENCE_PRODUCT at 1920x1080
on the 638,700-triangle SunTemple stand-in; chip_smoke.capture_reference_calls)
it holds every exact variant against reference_ray_resolve_plain (statuses
equal and rgb equal bit for bit), times every variant with CUDA events
(chip_smoke.cuda_ms: median and min of 5 timings of 20 launches; "ms" as
the wrapper's calls come, "device_ms" queued behind a device sleep so that
only the device's time counts) in two rounds, forward and backward through
the list, and computes the per-phase SIMT efficiency of the lanes
(gi.reference_simt from the plain version's per-lane counts: each lane in
its 8 x 4 warp tile, the first design; and queue_simt, the queue designs'
model at several trace splits, block sizes and tile heights) and the
spread of the trace's steps.
With --parent DIR (an unpacked tree of another commit, e.g. `git archive`
of the parent), that tree's kernel is built and timed first in the list,
so the rounds run it and the design in turns (parent, design, design,
parent).

The variants.  "design" is the package's kernel (a block of four 8 x 4
warp tiles; stage 1 the skip, the trace and the resolves, stage 2 the
marches from the block's queue, 32 a warp; the squared-norm crossing test,
the third tap only where the first two leave the outcome open; the 128^3
table's fixed-size fetch);
"tile*" are the design at other warp-tile heights.  reference_sweep.cu's
variants (its header says more): "first" is the first design (a thread a
lane in its tile, every phase in place) built from the package's helpers,
and on it the probes: "full" runs every loop's whole budget on every lane
(divergence; exact), "fixed" reads every corner and depth from one address
(gathers; the control flow changes with the data), "twice" issues every
gather twice (one more gather a fetch; exact), "no_march" skips the voxel
march, "no_bank" reads the decode table without bank conflicts,
"no_lookup" with no lookup at all, "mb*" bound the registers for more
resident blocks (occupancy; exact).  "split*", "q*", "step0" and the step
forks ("batch", "pre", "sq", "tap3" and their sums) are the first queue
design (a march queue alone) at other trace splits, block sizes and trace
steps; "no_cube" takes the general fetch on the 128^3 table;
"resolve_queues" queues the pyramids and the fallbacks too; "q_mb*"
bound its registers for more resident blocks; "coop*"
shares each step's taps among the warp's lanes.  Writes the JSON to --out,
prints one line per variant, and the last line is the card's name and
power limit.  Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from vulkan_pbr_renderer_tpu_torch.shade import gi

SWEEP_SOURCE = Path(__file__).resolve().with_name("reference_sweep.cu")
FIRST = ("REF_VARIANT=0",)
Q = ("REF_VARIANT=2",)
# name -> (source: None the package's kernel, "sweep" reference_sweep.cu; -D values;
#          rows of a warp's lane tile (None: the plan's); exact)
VARIANTS = {
    "first": ("sweep", FIRST, None, True),
    "full": ("sweep", FIRST + ("REF_PROBE=1",), None, True),
    "fixed": ("sweep", FIRST + ("REF_PROBE=2",), None, False),
    "full_fixed": ("sweep", FIRST + ("REF_PROBE=3",), None, False),
    "no_march": ("sweep", FIRST + ("REF_PROBE=4",), None, False),
    "no_bank": ("sweep", FIRST + ("REF_PROBE=8",), None, False),
    "no_lookup": ("sweep", FIRST + ("REF_PROBE=16",), None, False),
    "twice": ("sweep", FIRST + ("REF_PROBE=32",), None, True),
    "mb10": ("sweep", FIRST + ("REF_MIN_BLOCKS=10",), None, True),
    "mb12": ("sweep", FIRST + ("REF_MIN_BLOCKS=12",), None, True),
    "split4": ("sweep", Q + ("REF_SPLIT=4",), None, True),
    "split8": ("sweep", Q + ("REF_SPLIT=8",), None, True),
    "split12": ("sweep", Q + ("REF_SPLIT=12",), None, True),
    "split8_b256": ("sweep", Q + ("REF_SPLIT=8", "REF_BLOCK=256"), None, True),
    "q256": ("sweep", Q + ("REF_BLOCK=256",), None, True),
    "q512": ("sweep", Q + ("REF_BLOCK=512",), None, True),
    "step0": ("sweep", Q + ("REF_STEP=0",), None, True),
    "batch": ("sweep", Q + ("REF_STEP=1",), None, True),
    "pre": ("sweep", Q + ("REF_STEP=2",), None, True),
    "sq": ("sweep", Q + ("REF_STEP=4",), None, True),
    "batch_sq": ("sweep", Q + ("REF_STEP=5",), None, True),
    "pre_sq": ("sweep", Q + ("REF_STEP=6",), None, True),
    "all3": ("sweep", Q + ("REF_STEP=7",), None, True),
    "tap3": ("sweep", Q + ("REF_STEP=8",), None, True),
    "no_cube": ("sweep", Q + ("REF_STEP=12", "REF_NO_CUBE=1"), None, True),
    "q_mb10": ("sweep", Q + ("REF_MIN_BLOCKS=10",), None, True),
    "q_mb12": ("sweep", Q + ("REF_MIN_BLOCKS=12",), None, True),
    "resolve_queues": ("sweep", ("REF_VARIANT=4",), None, True),
    "coop": ("sweep", ("REF_VARIANT=3",), None, True),
    "coop_b256": ("sweep", ("REF_VARIANT=3", "REF_BLOCK=256"), None, True),
    "sq_tap3": ("sweep", Q + ("REF_STEP=12",), None, True),
    "tile2": (None, (), 2, True),
    "tile4": (None, (), 4, True),
    "tile16": (None, (), 16, True),
    "design": (None, (), None, True),
}
# the queue design's SIMT model: (name, tiles a block, trace split, rows of a tile)
MODELS = (("queue", 4, 0, 8), ("queue_b256", 8, 0, 8), ("queue_b512", 16, 0, 8),
          ("queue_split8", 4, 8, 8), ("queue_split8_b256", 8, 8, 8),
          ("queue_tile1", 4, 0, 1), ("queue_tile2", 4, 0, 2), ("queue_tile4", 4, 0, 4),
          ("queue_tile16", 4, 0, 16), ("queue_tile32", 4, 0, 32))
RAYS = (("C", "diffuse"), ("C", "specular"), ("C-product", "diffuse"))


def queue_simt(lane_work, tiles, block_tiles, split=0):
    """Per-phase SIMT efficiency (as gi.reference_simt) of a queue design:
    blocks of `block_tiles` warp tiles (`tiles`) drain their marching lanes
    from a queue 32 a warp (gi.compact_tiles); with split > 0 the trace runs
    `split` steps in the tile's warp and the lanes past them are drained the
    same way for the rest.  The taps as the package's kernel takes them
    (the outcome's), in the tile's warp."""
    out, done, issued = {}, 0, 0
    for kind in gi.REF_PHASES:
        counts = lane_work[kind].reshape(-1).to(torch.int64)
        if kind == "march":
            parts = [(counts, gi.compact_tiles(lane_work["seed"] > 0, tiles, block_tiles))]
        elif kind == "trace" and split > 0:
            first = torch.clamp(counts, max=split)
            parts = [(first, tiles), (counts - first,
                                      gi.compact_tiles(counts > split, tiles, block_tiles))]
        else:
            parts = [(counts, tiles)]
        d, i = (sum(x) for x in zip(*(gi._issued(c, w) for c, w in parts)))
        out[kind] = d / i if i else 1.0
        done, issued = done + d, issued + i
    out["all"] = done / issued if issued else 1.0
    return out


def _f(values, digits=4):
    return "/".join(f"{v:.{digits}f}" for v in values)


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def capture(scene, cfg):
    """(diffuse, specular) arguments of gi.reference_ray_resolve in frame 1
    of cfg's path (chip_smoke.capture_reference_calls)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple

    r = Renderer(cfg, scene, device="cuda")
    cams = [make_camera(*suntemple.camera_path(i / (chip_smoke.N_FRAMES - 1)), cfg,
                        device="cuda") for i in range(2)]
    calls = chip_smoke.capture_reference_calls(r, cams)
    del r
    torch.cuda.empty_cache()
    return dict(zip(("diffuse", "specular"), calls))


def trace_spread(steps):
    """The trace's steps a lane: quantiles and the share past 4 / 6 / 8 / 12."""
    s = steps.reshape(-1).to(torch.float32)
    q = torch.quantile(s.cpu()[:: max(1, s.numel() // 1_000_000)],
                       torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9, 0.99]))
    return {"quantiles_10_25_50_75_90_99": [float(v) for v in q],
            **{f"past_{k}": float((s > k).float().mean()) for k in (4, 6, 8, 12)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a tree of another commit: time its kernel first")
    ap.add_argument("--variants", help="names of VARIANTS to run (default all)")
    ap.add_argument("--out", default="build/reference_sweep.json")
    args = ap.parse_args()
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import REFERENCE_PRODUCT, SUNTEMPLE_1080P_REFERENCE
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build

    variants = dict(VARIANTS)
    if args.variants:
        want = args.variants.split(",")
        chip_smoke.check(set(want) <= set(variants), f"reference sweep: unknown {want}")
        variants = {k: v for k, v in variants.items() if k in want}
    sources = {"sweep": str(SWEEP_SOURCE)}
    if args.parent:
        sources["parent"] = str(Path(args.parent, "vulkan_pbr_renderer_tpu_torch", "csrc",
                                     "gi_reference_ray.cu").resolve())
        variants = {"parent": ("parent", (), None, True), **variants}
    t0 = time.perf_counter()
    builds = sorted({(sources.get(v[0]), v[1]) for v in variants.values()}, key=str)

    def build(b):
        try:
            path, _, log = cuda_build.build("gi_reference_ray", b[1], b[0])
            return path, log
        except RuntimeError as e:
            return e

    with ThreadPoolExecutor(8) as pool:
        logs = dict(zip(builds, pool.map(build, builds)))
    print(f"build: {len(builds)} builds in {time.perf_counter() - t0:.2f} s", flush=True)
    libs, rows, failed = {}, {}, []
    for name, (src, defines, _, exact) in list(variants.items()):
        built = logs[(sources.get(src), defines)]
        if isinstance(built, Exception):
            failed.append(f"{name}: build failed")
            print(f"{name}: build failed: {built}", flush=True)
            del variants[name]
            continue
        path, log = built
        libs[name] = gi._ref_library(defines, sources.get(src))
        rows[name] = {"source": src or "kernel", "defines": list(defines), "exact": exact,
                      "ptxas": _ptxas(log), "library": path.name}
        if name == "parent":   # the parent's query: no table sizes, no shared bytes
            occ = dict(cuda_build.query_ints(libs[name], "gi_reference_ray_occupancy", (
                "registers", "local_bytes", "blocks_per_sm", "threads")), shared_bytes=None)
        else:
            occ = gi.reference_ray_occupancy(libs[name])
        rows[name]["occupancy"] = occ
        print(f"{name} ({path.name}): {' '.join(defines) or 'defaults'}: "
              + " | ".join(rows[name]["ptxas"])
              + f"; {occ['registers']} registers, {occ['local_bytes']} B local, "
              f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads an SM, "
              f"{occ['shared_bytes']} B shared", flush=True)

    t0 = time.perf_counter()
    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    paths = {"C": capture(scene, SUNTEMPLE_1080P_REFERENCE),
             "C-product": capture(scene, REFERENCE_PRODUCT)}
    del scene
    torch.cuda.empty_cache()
    calls = {f"{p}_{ray}": paths[p][ray] for p, ray in RAYS}
    print(f"captured {list(calls)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def run(name, key):
        return gi.run_reference_ray(libs[name], *calls[key], tile_h=variants[name][2])

    simt = {}
    for key, call in calls.items():
        lane_work = {}
        rgb_p, st_p = gi.reference_ray_resolve_plain(*call, work=lane_work)
        rows_, width = gi.lane_grid(st_p.shape)

        def tiles(h):
            return gi.lane_tiles(rows_, width, gi.lane_tile_h(rows_, h))

        simt[key] = {"tile": gi.reference_simt(lane_work, tiles(gi.TILE_H)),
                     **{m: queue_simt(lane_work, tiles(h), bt, split)
                        for m, bt, split, h in MODELS},
                     "trace_steps": trace_spread(lane_work["trace"]),
                     "steps": {k: int(v.sum()) for k, v in lane_work.items()},
                     "lanes": st_p.numel(), "lane_shape": list(st_p.shape)}
        print(f"{key}: {st_p.numel()} lanes {list(st_p.shape)}; SIMT "
              + "; ".join(f"{m} " + ", ".join(f"{k} {v:.3f}" for k, v in simt[key][m].items())
                          for m in ["tile"] + [m[0] for m in MODELS])
              + f"; trace steps {simt[key]['trace_steps']}", flush=True)
        for name in variants:
            rgb_k, st_k = run(name, key)
            torch.cuda.synchronize()
            same = st_k == st_p
            differ = int((~same).sum())
            err = float((rgb_k - rgb_p).abs().amax(-1)[same].max()) if bool(same.any()) else 0.0
            bits = differ == 0 and torch.equal(rgb_k.view(torch.int32), rgb_p.view(torch.int32))
            rows[name][f"{key}_status_differ"] = differ
            rows[name][f"{key}_max_abs_err"] = err
            rows[name][f"{key}_bit_equal"] = bits
            if variants[name][3] and not bits:
                failed.append(f"{name} {key}: {differ} statuses differ, rgb error {err}")
        print(f"{key}: exact variants against the plain version: {len(failed)} failures so far",
              flush=True)
    order = list(variants)
    for seq in (order, order[::-1]):
        for name in seq:
            for key in calls:
                row = rows[name]
                for what, hold in (("ms", False), ("device_ms", True)):
                    ms_min, ms = chip_smoke.cuda_ms(lambda: run(name, key), hold=hold)
                    row.setdefault(f"{key}_{what}", []).append(ms)
                    row.setdefault(f"{key}_{what}_min", []).append(ms_min)
    card = chip_smoke.nvidia_smi()
    for name, row in rows.items():
        print(f"{name}: " + "; ".join(
            f"{key} device ms {_f(row[key + '_device_ms'])} (min "
            f"{_f(row[key + '_device_ms_min'])}), ms {_f(row[key + '_ms'])}, bits "
            f"{row[key + '_bit_equal']}" for key in calls), flush=True)
    result = {"card": card, "torch": torch.__version__, "simt": simt, "variants": rows,
              "failed": failed}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    chip_smoke.check(not failed, "reference sweep: " + "; ".join(failed))
    print(card, flush=True)


if __name__ == "__main__":
    main()
