#!/usr/bin/env python3
"""Sweep of the tiled kernels' compile-time values on one GPU: the shade
(csrc/lighting.cu) and the bloom down chain (csrc/post.cu).

Run from the repository root:

    python3 tile_sweep.py [--parent DIR] [--out chiprun_out/tile_sweep.json]

Builds csrc/lighting.cu once per shade tile (SHADE_TILE_W x SHADE_TILE_H)
and register bound (SHADE_MIN_BLOCKS, blocks of 256 threads an SM), and
csrc/post.cu once per chain tile (CHAIN_TILE_H rows of 32 texels) and
register bound (CHAIN_MIN_BLOCKS), all builds started together, and prints
each build's ptxas registers and spills and the kernel's resident blocks an
SM.  On path A's frame-1 inputs (chip_smoke.capture_slice_calls and
capture_post_call: SUNTEMPLE_1080P at 1920x1088 on the 638,700-triangle
SunTemple stand-in) it holds every shade
variant against lighting.shade_plain and every chain variant against the
plain chain and its atlas bit for bit, and times each with CUDA events
(chip_smoke.cuda_ms: median and min of 5 timings of 20 launches, "ms" as
the wrapper's calls come, "device_ms" queued behind a device sleep so that
only the device's time counts), the chain whole and cut after each level
(levels 1-n), in two rounds, forward and backward through the list.  With
--parent DIR (an unpacked tree of another commit, e.g. `git archive` of
the parent, whose ShadeArgs is the same), that tree's shade kernel is
built and timed first in the list, so the rounds run it and the variants
in turns.  Writes the JSON to --out, prints one line per variant, and the
last line is the card's name and power limit.  Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke

# name -> -D values of the shade; "16x16_mb6" is the package's default
VARIANTS = {
    "16x16_mb6": (),
    "16x16_mb4": ("SHADE_MIN_BLOCKS=4",),
    "16x16_mb5": ("SHADE_MIN_BLOCKS=5",),
    "16x16_mb7": ("SHADE_MIN_BLOCKS=7",),
    "32x8_mb6": ("SHADE_TILE_W=32", "SHADE_TILE_H=8"),
}
# name -> -D values of the chain; "chain_mb4" is the package's default
CHAIN_VARIANTS = {
    "chain_mb4": (),
    "chain_mb5": ("CHAIN_MIN_BLOCKS=5",),
    "chain_t16": ("CHAIN_TILE_H=16",),
}


def _load(path, launcher):
    lib = ctypes.CDLL(str(path))
    getattr(lib, launcher).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _time(name, fn, check, rows, key, what):
    """Check fn's result, then time it as called and on the device alone."""
    chip_smoke.check(check(fn()), f"tile sweep {name}: not the plain version's bits")
    ms_min, ms = chip_smoke.cuda_ms(fn)
    dev_min, dev_ms = chip_smoke.cuda_ms(fn, hold=True)
    rows[key] = dict(ms=ms, ms_min=ms_min, device_ms=dev_ms, device_ms_min=dev_min)
    print(f"{name} {what}: bit-equal to the plain version; {ms:.4f} ms median, {ms_min:.4f} "
          f"min as called; device {dev_ms:.4f} median, {dev_min:.4f} min (5 x 20 launches); "
          f"card {chip_smoke.nvidia_smi()}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--out", default="chiprun_out/tile_sweep.json")
    args = parser.parse_args()
    chip_smoke.phase_card()
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import SUNTEMPLE_1080P
    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build, sampling
    from vulkan_pbr_renderer_tpu_torch.shade import bloom, lighting, shadow, taa

    builds = {name: ("lighting", d, None) for name, d in VARIANTS.items()}
    if args.parent:
        builds = {"parent": ("lighting_parent", (), Path(args.parent)
                             / "vulkan_pbr_renderer_tpu_torch" / "csrc" / "lighting.cu"),
                  **builds}
    builds.update({name: ("post", d, None) for name, d in CHAIN_VARIANTS.items()})
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(lambda b: cuda_build.build(*b), builds.values())))
    libs, rows = {}, {}
    library, post_library = shadow.library, bloom._library
    for name, (path, seconds, log) in built.items():
        chain = name in CHAIN_VARIANTS
        libs[name] = _load(path, "bloom_down_chain_launch" if chain else "shade_launch")
        if chain:
            bloom._library = lambda lib=libs[name]: lib
            regs, blocks, threads = bloom.chain_occupancy()
            occ = dict(registers=regs, blocks_per_sm=blocks, threads=threads)
        else:
            libs[name].shade_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            shadow.library = lambda lib=libs[name]: lib
            occ = (lighting.shade_occupancy() if hasattr(libs[name], "shade_occupancy")
                   else None)
        ptxas = chip_smoke._ptxas_entry(log, "bloom_down_chain" if chain else "shade_kernel")
        rows[name] = {"defines": list(builds[name][1]), "ptxas": ptxas, "occupancy": occ}
        print(f"{name}: {' '.join(builds[name][1]) or 'defaults'}: built in {seconds:.1f} s; "
              f"ptxas {ptxas}; occupancy {occ}", flush=True)
    # the frames below launch the package's own kernels
    shadow.library, bloom._library = library, post_library
    bloom._chain_launcher.cache_clear()

    cfg = SUNTEMPLE_1080P
    scene = build_scene(suntemple.build_parts(chip_smoke.SCENE_DETAIL), suntemple.materials(),
                        texture_size=chip_smoke.TEXTURE_SIZE, device="cuda")
    r = Renderer(cfg, scene, device="cuda")
    cams = [make_camera(*suntemple.camera_path(i / (chip_smoke.N_FRAMES - 1)), cfg,
                        device="cuda") for i in range(2)]
    shade_args, shade_kw = chip_smoke.capture_slice_calls(r, cams)["shade"]
    want = lighting.shade_plain(*shade_args, **shade_kw)
    sky = float((~shade_args[0].coverage).float().mean())
    post_in = chip_smoke.capture_post_call(r, cams)
    hdr = taa.taa_resolve_plain(*post_in, cfg.taa_blend, cfg.taa_velocity_rejection,
                                catmull_history=cfg.taa_catmull_history,
                                full_rgb_catmull=cfg.taa_full_rgb_catmull)
    passes = cfg.bloom_pass_count
    atlas, offs = bloom.new_atlas(cfg.height, cfg.width, passes, hdr.device)
    plain_chain = chip_smoke._down_plain_chain(hdr, passes)
    plain_atlas = sampling.pack_mip_atlas(plain_chain).to(torch.bfloat16)

    def shade():
        return lighting.shade(*shade_args, **shade_kw)

    def chain(n):
        return lambda: bloom.bloom_down_chain(hdr, n, atlas, offs)

    def chain_same(got):
        return (all(bool(torch.equal(g, w)) for g, w in zip(got, plain_chain))
                and bool(torch.equal(atlas.view(torch.int16), plain_atlas.view(torch.int16))))

    names = list(builds)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            if name in CHAIN_VARIANTS:
                bloom._library = lambda lib=libs[name]: lib
                bloom._chain_launcher.cache_clear()
                _time(name, chain(passes), chain_same, rows[name], f"round{rnd}",
                      f"round {rnd}, {passes} levels")
                for n in range(1, passes):
                    _time(name, chain(n), lambda got, n=n: all(
                        bool(torch.equal(g, w)) for g, w in zip(got, plain_chain[:n])),
                          rows[name], f"levels{n}_round{rnd}", f"round {rnd}, levels 1-{n}")
            else:
                shadow.library = lambda lib=libs[name]: lib
                _time(name, shade, lambda got: bool(torch.equal(got, want)), rows[name],
                      f"round{rnd}", f"round {rnd}")
    shadow.library, bloom._library = library, post_library
    bloom._chain_launcher.cache_clear()
    result = {"card": chip_smoke.nvidia_smi(), "shape": list(want.shape[:2]),
              "uncovered_share": sky, "variants": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
