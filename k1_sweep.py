#!/usr/bin/env python3
"""Sweep of K1's compile-time constants (csrc/vis_folded.cu) on one GPU.

Run from the repository root with no arguments:

    python3 k1_sweep.py

Builds vis_folded.cu once per (K1_PIECE_ROWS, K1_THREADS) pair, all builds
started together, prints each build's ptxas registers and spills, and on
frame 0's real camera (1920x1088) and sun (2048^2) passes of the
638,700-triangle SunTemple stand-in (chip_smoke.py's scene and passes):
checks every variant against vis_folded_plain over every tile (ids exactly
equal, depth within chip_smoke.DEPTH_ATOL), then times each variant with
CUDA events (chip_smoke.cuda_ms: median and min of 5 timings of 20
launches) in two rounds, forward and backward through the list.  Writes the table as JSON to
chiprun_out/k1_sweep.json and prints it; the last line is the card's name
and power limit.  Fails without a card.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke

PIECE_ROWS = (128, 256, 512, 1024)
THREADS = (128, 256)


def main():
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
    from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as v2

    variants = [(p, t) for t in THREADS for p in PIECE_ROWS]
    defines = [(f"K1_PIECE_ROWS={p}", f"K1_THREADS={t}") for p, t in variants]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(defines)) as pool:
        built = list(pool.map(lambda d: cuda_build.build("vis_folded", d), defines))
    print(f"build: {len(defines)} variants in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {}
    for (p, t), (_, _, log) in zip(variants, built):
        ptxas[f"P{p}_T{t}"] = [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]
        print(f"P={p} threads={t}: " + " | ".join(ptxas[f"P{p}_T{t}"]), flush=True)
    libs = [v2._library(d) for d in defines]

    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    cfg = SUNTEMPLE_1080P
    r = Renderer(cfg, scene, device="cuda")
    cam = make_camera(*suntemple.camera_path(0.0), cfg, device="cuda")
    passes = chip_smoke._real_passes(r, cam, chip_smoke.SUN, cfg)

    rows = {f"P{p}_T{t}": {"piece_rows": p, "threads": t, "ptxas": ptxas[f"P{p}_T{t}"]}
            for p, t in variants}
    for name, b in passes.items():
        d_p, i_p = v2.vis_folded_plain(b.starts, b.pair_data, b.tiles_x)
        for (p, t), lib in zip(variants, libs):
            d_k, i_k, _ = v2.run_vis_folded(lib, b.starts, b.pair_data, b.tiles_x)
            err = chip_smoke._compare(d_k, i_k, d_p, i_p, f"P={p} threads={t} {name} pass")
            rows[f"P{p}_T{t}"][f"{name}_max_abs_err"] = err
        print(f"{name} pass: every variant equals the plain version on all "
              f"{b.starts.shape[0] - 1} tiles", flush=True)
    order = list(zip(variants, libs))
    for rnd, seq in enumerate((order, order[::-1])):
        for (p, t), lib in seq:
            for name, b in passes.items():
                ms_min, ms = chip_smoke.cuda_ms(
                    lambda: v2.run_vis_folded(lib, b.starts, b.pair_data, b.tiles_x))
                rows[f"P{p}_T{t}"].setdefault(f"{name}_ms", []).append(ms)
                rows[f"P{p}_T{t}"].setdefault(f"{name}_ms_min", []).append(ms_min)
    card = chip_smoke.nvidia_smi()
    for key, row in rows.items():
        print(f"{key}: camera ms median {row['camera_ms']} min {row['camera_ms_min']}, "
              f"sun ms median {row['sun_ms']} min {row['sun_ms_min']}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k1_sweep.json").write_text(json.dumps({"card": card, "variants": rows}, indent=1))
    print(json.dumps({"card": card, "variants": rows}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
