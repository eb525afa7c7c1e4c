#!/usr/bin/env python3
"""Sweep of K2's compile-time constants (csrc/vis_rowblock.cu) on one GPU.

Run from the repository root with no arguments:

    python3 k2_sweep.py

Builds vis_rowblock.cu once per (K2_PIECE_ROWS, K2_THREADS) pair, all builds
started together, prints each build's ptxas registers and spills, and on
frame 0's real camera (1920x1088) and sun (2048^2) passes of the
638,700-triangle SunTemple stand-in through SUNTEMPLE_1080P_ROWBLOCK
(chip_smoke.py's scene and passes): checks every variant against
vis_rowblock_plain over every tile (ids and depths exactly equal), then
times each variant with CUDA events (chip_smoke.cuda_ms: median and min of 5
timings of 20 launches) in two rounds, forward and backward through the list.  Writes the
table as JSON to chiprun_out/k2_sweep.json and prints it; the last line is
the card's name and power limit.  Fails without a card.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke

PIECE_ROWS = (64, 128, 256, 512)
THREADS = (128, 256, 512)


def main():
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P_ROWBLOCK
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
    from vulkan_pbr_renderer_tpu_torch.raster import visibility as vis

    variants = [(p, t) for t in THREADS for p in PIECE_ROWS]
    defines = [(f"K2_PIECE_ROWS={p}", f"K2_THREADS={t}") for p, t in variants]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(defines)) as pool:
        built = list(pool.map(lambda d: cuda_build.build("vis_rowblock", d), defines))
    print(f"build: {len(defines)} variants in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {}
    for (p, t), (_, _, log) in zip(variants, built):
        ptxas[f"P{p}_T{t}"] = [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]
        print(f"P={p} threads={t}: " + " | ".join(ptxas[f"P{p}_T{t}"]), flush=True)
    libs = [vis._library(d) for d in defines]

    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    cfg = SUNTEMPLE_1080P_ROWBLOCK
    r = Renderer(cfg, scene, device="cuda")
    cam = make_camera(*suntemple.camera_path(0.0), cfg, device="cuda")
    passes = chip_smoke._real_passes(r, cam, chip_smoke.SUN, cfg)
    cap, chunk = cfg.tile_capacity, cfg.tri_chunk

    def run(lib, b):
        return vis.run_vis_rowblock(lib, b.starts, b.pair_data, b.tiles_x, cap, chunk)

    rows = {f"P{p}_T{t}": {"piece_rows": p, "threads": t, "ptxas": ptxas[f"P{p}_T{t}"]}
            for p, t in variants}
    for name, b in passes.items():
        d_p, i_p = vis.vis_rowblock_plain(b.starts, b.pair_data, b.tiles_x, cap, chunk)
        for (p, t), lib in zip(variants, libs):
            d_k, i_k, _ = run(lib, b)
            err = chip_smoke._compare(d_k, i_k, d_p, i_p, f"P={p} threads={t} {name} pass",
                                      atol=0.0)
            rows[f"P{p}_T{t}"][f"{name}_max_abs_err"] = err
        print(f"{name} pass: every variant equals the plain version on all "
              f"{b.starts.shape[0] - 1} tiles", flush=True)
    order = list(zip(variants, libs))
    for seq in (order, order[::-1]):
        for (p, t), lib in seq:
            for name, b in passes.items():
                ms_min, ms = chip_smoke.cuda_ms(lambda: run(lib, b))
                rows[f"P{p}_T{t}"].setdefault(f"{name}_ms_min", []).append(ms_min)
                rows[f"P{p}_T{t}"].setdefault(f"{name}_ms", []).append(ms)
    card = chip_smoke.nvidia_smi()
    for key, row in rows.items():
        print(f"{key}: camera ms median {row['camera_ms']} min {row['camera_ms_min']}, "
              f"sun ms median {row['sun_ms']} min {row['sun_ms_min']}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k2_sweep.json").write_text(json.dumps({"card": card, "variants": rows}, indent=1))
    print(json.dumps({"card": card, "variants": rows}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
