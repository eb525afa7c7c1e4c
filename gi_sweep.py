#!/usr/bin/env python3
"""Sweep of the fast-GI ray kernel's variants (csrc/gi_fast_ray.cu) on one GPU.

Run from the repository root:

    python3 gi_sweep.py [--parent DIR] [--out chiprun_out/gi_sweep.json]

Builds the package's csrc/gi_fast_ray.cu and gi_sweep.cu (the same kernel
with the designs this sweep measured and did not keep, and two probes, as
compile-time forks) once per set of compile-time values (`-D`, all builds
started together) and prints each build's ptxas registers and spills.  On
both rays' real lanes of path A's frame 1 (1920x1088, the 638,700-triangle
SunTemple stand-in; chip_smoke.capture_gi_calls) it holds every exact
variant against fast_ray_resolve_plain (statuses equal on every lane, rgb
max abs error), times every variant with CUDA events (chip_smoke.cuda_ms:
median and min of 5 timings of 20 launches; "ms" as the wrapper's calls
come, "device_ms" queued behind a device sleep so that only the device's
time counts) and the host's time to enqueue one call ("host_us"), in two
rounds, forward and backward through the list, and computes the SIMT efficiency
(gi.simt_efficiency) of the lanes taken in rows of 32 and in 2-, 4- and
8-row warp tiles.  With --parent DIR (an unpacked tree of another commit,
e.g. `git archive` of the parent), that tree's kernel is built and timed
first in the list, so the rounds run it and the design in turns (parent,
design, design, parent).

The variants split the kernel's time.  "design" is the package's kernel
(decode table, 8 x 4 lane tiles, one tile per warp); "base" is gi_sweep.cu
with no -D value, the same kernel through the probes' source; "pr9*" are
the parent's design through gi_sweep.cu (lanes in rows of 32, the divide
in every corner's decode).  On either: "full" forces every lane through
each loop's whole budget (divergence), "fixed" reads every corner from one
address (gathers; its results differ, so it is timed and not checked; the
compiler then also shares the 8 corners' decodes), "mb8" bounds the
registers for 8 blocks per SM (occupancy), "rows" / "tile*" take the lanes
in rows of 32 or in warp tiles (coherence; "pr9_tile8" is the design
without the decode table).  Beside the design: "block_refill" and
"warp_refill" run a persistent grid of the resident blocks whose blocks,
or warps, take their next tiles from a device counter, "paired" reads
pair_table_x's table (4 loads of 8 bytes a fetch), "t256" runs 256
threads a block.  Writes the JSON to --out, prints one line per variant,
and the last line is the card's name and power limit.  Fails without a
card.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke

SWEEP_SOURCE = Path(__file__).resolve().with_name("gi_sweep.cu")
PR9 = ("GI_LUT=0",)
# name -> (source: None the package's kernel, "sweep" gi_sweep.cu; -D values;
#          rows of a warp's lane tile (None: the wrapper's); exact)
VARIANTS = {
    "pr9": ("sweep", PR9, 1, True),
    "pr9_full": ("sweep", PR9 + ("GI_PROBE_FULL=1",), 1, True),
    "pr9_fixed": ("sweep", PR9 + ("GI_PROBE_FIXED=1",), 1, False),
    "pr9_full_fixed": ("sweep", PR9 + ("GI_PROBE_FULL=1", "GI_PROBE_FIXED=1"), 1, False),
    "pr9_mb8": ("sweep", PR9 + ("GI_MIN_BLOCKS=8",), 1, True),
    "pr9_tile8": ("sweep", PR9, 8, True),
    "rows": (None, (), 1, True),
    "tile4": (None, (), 4, True),
    "block_refill": ("sweep", ("GI_PERSISTENT=2",), None, True),
    "warp_refill": ("sweep", ("GI_PERSISTENT=1",), None, True),
    "paired": ("sweep", ("GI_PAIRED=1",), None, True),
    "mb8": (None, ("GI_MIN_BLOCKS=8",), None, True),
    "t256": (None, ("GI_THREADS=256",), None, True),
    "full": ("sweep", ("GI_PROBE_FULL=1",), None, True),
    "full_fixed": ("sweep", ("GI_PROBE_FULL=1", "GI_PROBE_FIXED=1"), None, False),
    "base": ("sweep", (), None, True),
    "design": (None, (), None, True),
}


def pair_table_x(table):
    """quantize_grid_u8's [D,H,W,4] table -> [D,H,W,8]: each texel beside its
    +x neighbour (the edge texel beside itself), the x-pairs of a trilinear
    fetch's corners (gi_sweep.cu's GI_PAIRED)."""
    w = table.shape[2]
    nxt = torch.clamp(torch.arange(1, w + 1, device=table.device), max=w - 1)
    return torch.cat([table, table.index_select(2, nxt)], -1)


def _f(values, digits=4):
    return "/".join(f"{v:.{digits}f}" for v in values)


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a tree of another commit: time its kernel first")
    ap.add_argument("--out", default="chiprun_out/gi_sweep.json")
    args = ap.parse_args()
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    variants = dict(VARIANTS)
    sources = {"sweep": str(SWEEP_SOURCE)}
    if args.parent:
        sources["parent"] = str(Path(args.parent, "vulkan_pbr_renderer_tpu_torch", "csrc",
                                     "gi_fast_ray.cu").resolve())
        # the parent's kernel in the wrapper's warp tiles (every tree since
        # the tiled design takes them)
        variants = {"parent": ("parent", (), None, True), **variants}
    t0 = time.perf_counter()
    builds = sorted({(sources.get(v[0]), v[1]) for v in variants.values()}, key=str)
    with ThreadPoolExecutor(8) as pool:
        logs = dict(zip(builds, pool.map(
            lambda b: cuda_build.build("gi_fast_ray", b[1], b[0])[2], builds)))
    print(f"build: {len(variants)} variants in {time.perf_counter() - t0:.2f} s", flush=True)
    libs, rows = {}, {}
    for name, (src, defines, tile_h, exact) in variants.items():
        libs[name] = gi._ray_library(defines, sources.get(src))
        rows[name] = {"source": src or "kernel", "defines": list(defines), "exact": exact,
                      "ptxas": _ptxas(logs[(sources.get(src), defines)])}
        if name != "parent":
            regs, blocks, threads = gi.ray_kernel_occupancy(libs[name])
            rows[name].update(registers=regs, blocks_per_sm=blocks, threads=threads)
        print(f"{name}: {' '.join(defines) or 'defaults'}: " + " | ".join(rows[name]["ptxas"])
              + (f"; {rows[name]['blocks_per_sm']} blocks per SM" if name != "parent" else ""),
              flush=True)

    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    cfg = SUNTEMPLE_1080P
    r = Renderer(cfg, scene, device="cuda")
    cams = [make_camera(*suntemple.camera_path(i / (chip_smoke.N_FRAMES - 1)), cfg,
                        device="cuda") for i in range(2)]
    calls = dict(zip(("diffuse", "specular"), chip_smoke.capture_gi_calls(r, cams)))
    del r, scene
    torch.cuda.empty_cache()

    paired = {ray: pair_table_x(call[0]) for ray, call in calls.items()}
    for ray, table in paired.items():     # the pairs hold quantize_grid_u8's levels
        src = calls[ray][0]
        chip_smoke.check(torch.equal(table[..., :4], src) and torch.equal(
            table[:, :, :-1, 4:], src[:, :, 1:]) and torch.equal(table[:, :, -1, 4:],
                                                                src[:, :, -1]),
            f"gi_sweep: the paired table of the {ray} ray differs from its levels")

    def run(name, ray):
        _, defines, tile_h, _ = variants[name]
        call = calls[ray]
        table = paired[ray] if "GI_PAIRED=1" in defines else call[0]
        return gi.run_fast_ray(libs[name], table, *call[1:4], call[4:7], *call[7:],
                               tile_h=tile_h)

    simt, failed = {}, []
    for ray, call in calls.items():
        lane_work = {}
        rgb_p, st_p = gi.fast_ray_resolve_plain(*call, work=lane_work)
        lanes, width = gi.lane_grid(call[8].shape[:-1])
        simt[ray] = {f"tile{h}": gi.simt_efficiency(lane_work, gi.lane_tiles(lanes, width, h))
                     for h in (1, 2, 4, 8)}
        simt[ray]["steps"] = {k: int(v.sum()) for k, v in lane_work.items()}
        print(f"{ray}: {st_p.numel()} lanes {list(st_p.shape)}; SIMT efficiency "
              f"{simt[ray]}", flush=True)
        for name in variants:
            rgb_k, st_k = run(name, ray)
            torch.cuda.synchronize()
            same = st_k == st_p
            differ = int((~same).sum())
            err = float((rgb_k - rgb_p).abs().amax(-1)[same].max()) if bool(same.any()) else 0.0
            rows[name][f"{ray}_status_differ"] = differ
            rows[name][f"{ray}_max_abs_err"] = err
            if variants[name][3] and (differ or err):
                failed.append(f"{name} {ray}: {differ} statuses differ, rgb error {err}")
        print(f"{ray}: exact variants against the plain version on {st_p.numel()} lanes: "
              f"{len(failed)} failures so far", flush=True)
    order = list(variants)
    for seq in (order, order[::-1]):
        for name in seq:
            for ray in calls:
                row = rows[name]
                for key, hold in (("ms", False), ("device_ms", True)):
                    ms_min, ms = chip_smoke.cuda_ms(lambda: run(name, ray), hold=hold)
                    row.setdefault(f"{ray}_{key}", []).append(ms)
                    row.setdefault(f"{ray}_{key}_min", []).append(ms_min)
                torch.cuda.synchronize()    # the host's time to enqueue one launch
                t0 = time.perf_counter()
                for _ in range(chip_smoke.KERNEL_REPS):
                    run(name, ray)
                row.setdefault(f"{ray}_host_us", []).append(
                    1e6 * (time.perf_counter() - t0) / chip_smoke.KERNEL_REPS)
                torch.cuda.synchronize()
    card = chip_smoke.nvidia_smi()
    for name, row in rows.items():
        print(f"{name}: " + "; ".join(
            f"{ray} ms {_f(row[ray + '_ms'])} (min {_f(row[ray + '_ms_min'])}), device ms "
            f"{_f(row[ray + '_device_ms'])} (min {_f(row[ray + '_device_ms_min'])}), host us "
            f"{_f(row[ray + '_host_us'], 1)}" for ray in calls), flush=True)
    result = {"card": card, "torch": torch.__version__, "simt": simt, "variants": rows,
              "failed": failed}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    chip_smoke.check(not failed, "gi_sweep: exact variants differ from the plain version: "
                     + "; ".join(failed))
    print(card, flush=True)


if __name__ == "__main__":
    main()
