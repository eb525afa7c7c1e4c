#!/usr/bin/env python3
"""Sweep of K1-hiz's compile-time constants (csrc/vis_folded_hiz.cu) on one GPU.

Run from the repository root with no arguments:

    python3 khiz_sweep.py

Builds vis_folded_hiz.cu once per (KHIZ_PIECE_ROWS, KHIZ_THREADS) pair, all
builds started together, prints each build's ptxas registers, spills and
shared memory, and checks every variant against vis_folded_hiz_plain (ids
and depths exactly equal): on chip_smoke.py's tie sets (the slot-tie tile
with its ties 128, 256 and 384 rows apart, duplicated triangles, a deep
one-tile stack) and on every tile of frame 0's real camera (1920x1088) and
sun (2048^2) passes of the 638,700-triangle SunTemple stand-in
(chip_smoke.py's scene and passes, z-ordered bins).  Then it times each
variant with CUDA events (chip_smoke.cuda_ms: min and median of 5 rounds of
20 launches) in two rounds, forward and backward through the list, with the
work list in piece-major order and, for comparison, in tile-major order
(which leaves the early exit little to skip), beside K1 on the same passes'
id-ordered bins, and reports the rows each variant walked and the pixels
that took its tie re-resolve.  Writes the table as JSON to
chiprun_out/khiz_sweep.json and prints it; the last line is the card's name
and power limit.  Fails without a card.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke

PIECE_ROWS = (128, 256, 512)
THREADS = (128, 256)


def _tie_sets(dev):
    """Small z-ordered bins that exercise the tie rule and the skip."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup

    sets = [("slot_ties", chip_smoke._slot_tie_tris(), 32, 32),
            ("slot_ties_256_apart", chip_smoke._slot_tie_tris(256), 32, 32),
            ("slot_ties_384_apart", chip_smoke._slot_tie_tris(384), 32, 32),
            ("dup200x3_seed7", chip_smoke._dup_tris(200, 7), 128, 96),
            ("deep_stack2138_seed9", chip_smoke._stack_tris(2138, 9), 32, 32)]
    out = {}
    for name, clip, w, h in sets:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        out[name] = binning.bin_triangles(s, w, h, 32, 8 * clip.shape[0], 128, z_order=True)
    return out


def main():
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P_HIZ
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build
    from vulkan_pbr_renderer_tpu_torch.raster import visibility_v2 as v2

    variants = [(p, t) for t in THREADS for p in PIECE_ROWS]
    defines = [(f"KHIZ_PIECE_ROWS={p}", f"KHIZ_THREADS={t}") for p, t in variants]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(defines)) as pool:
        built = list(pool.map(lambda d: cuda_build.build("vis_folded_hiz", d), defines))
    print(f"build: {len(defines)} variants in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {}
    for (p, t), (_, _, log) in zip(variants, built):
        ptxas[f"P{p}_T{t}"] = [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"P={p} threads={t}: " + " | ".join(ptxas[f"P{p}_T{t}"]), flush=True)
    libs = [v2._hiz_library(d) for d in defines]

    def run(lib, b, piece_major=True):
        return v2.run_vis_folded_hiz(lib, b.starts, b.pair_data, b.chunk_minz, b.tiles_x,
                                     piece_major=piece_major)

    def plain(b):
        return v2.vis_folded_hiz_plain(b.starts, b.pair_data, b.chunk_minz, b.tiles_x, group=64,
                                       rows_walked=True)

    rows = {f"P{p}_T{t}": {"piece_rows": p, "threads": t, "ptxas": ptxas[f"P{p}_T{t}"]}
            for p, t in variants}
    for name, b in _tie_sets("cuda").items():
        d_p, i_p, _ = plain(b)
        for (p, t), lib in zip(variants, libs):
            for piece_major in (True, False):
                d_k, i_k, stats, items = run(lib, b, piece_major)
                chip_smoke._compare(d_k, i_k, d_p, i_p, f"P={p} threads={t} {name}", atol=0.0)
                chip_smoke._check_hiz_items(items, b, p, piece_major,
                                            f"P={p} threads={t} {name}")
            rows[f"P{p}_T{t}"][f"{name}_marked_pixels"] = int(stats[1])
        print(f"{name}: every variant equals the plain version", flush=True)

    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    cfg = SUNTEMPLE_1080P_HIZ
    r = Renderer(cfg, scene, device="cuda")
    cam = make_camera(*suntemple.camera_path(0.0), cfg, device="cuda")
    passes = chip_smoke._real_passes(r, cam, chip_smoke.SUN, cfg)
    ipasses = chip_smoke._real_passes(r, cam, chip_smoke.SUN, cfg.replace(raster_hiz=False))
    summary = {}
    for name, b in passes.items():
        d_p, i_p, walked = plain(b)
        summary[name] = {"pairs": int(b.starts[-1]), "rows_walked_serial": int(walked.sum())}
        for (p, t), lib in zip(variants, libs):
            for piece_major in (True, False):
                d_k, i_k, stats, items = run(lib, b, piece_major)
                chip_smoke._compare(d_k, i_k, d_p, i_p, f"P={p} threads={t} {name} pass",
                                    atol=0.0)
                live = chip_smoke._check_hiz_items(items, b, p, piece_major,
                                                   f"P={p} threads={t} {name} pass")
                rows[f"P{p}_T{t}"][f"{name}_work_items"] = live
                key = "" if piece_major else "_tile_major"
                rows[f"P{p}_T{t}"][f"{name}_rows_walked{key}"] = int(stats[0])
                rows[f"P{p}_T{t}"][f"{name}_marked_pixels{key}"] = int(stats[1])
        print(f"{name} pass: every variant equals the plain version on all "
              f"{b.starts.shape[0] - 1} tiles ({summary[name]})", flush=True)
    order = list(zip(variants, libs))
    for seq in (order, order[::-1]):
        for (p, t), lib in seq:
            for name, b in passes.items():
                for piece_major in (True, False):
                    key = "" if piece_major else "_tile_major"
                    ms_min, ms = chip_smoke.cuda_ms(lambda: run(lib, b, piece_major))
                    rows[f"P{p}_T{t}"].setdefault(f"{name}_ms{key}", []).append(ms)
                    rows[f"P{p}_T{t}"].setdefault(f"{name}_ms_min{key}", []).append(ms_min)
        for name, b in ipasses.items():
            ms_min, ms = chip_smoke.cuda_ms(
                lambda: v2.vis_folded_tiles(b.starts, b.pair_data, b.tiles_x))
            summary[name].setdefault("k1_ms", []).append(ms)
            summary[name].setdefault("k1_ms_min", []).append(ms_min)
    card = chip_smoke.nvidia_smi()
    for key, row in rows.items():
        print(f"{key}: camera ms median {row['camera_ms']} min {row['camera_ms_min']} "
              f"(tile-major {row['camera_ms_tile_major']}), rows {row['camera_rows_walked']} "
              f"(tile-major {row['camera_rows_walked_tile_major']}); sun ms median "
              f"{row['sun_ms']} min {row['sun_ms_min']} (tile-major {row['sun_ms_tile_major']}), "
              f"rows {row['sun_rows_walked']} (tile-major {row['sun_rows_walked_tile_major']})",
              flush=True)
    print(f"passes and K1: {summary}", flush=True)
    result = {"card": card, "passes": summary, "variants": rows}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "khiz_sweep.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
