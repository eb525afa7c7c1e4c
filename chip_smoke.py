#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. card: torch / CUDA versions and the card's name and power limit;
  2. build: compile the port's CUDA kernels from csrc/ (build/torch_kernels/),
     one nvcc per source, all started together;
  3. each visibility kernel against its plain PyTorch version on the card:
     ids exactly equal, depth within atol=1e-6, on three random triangle sets
     (and, for the rowblock kernel, a case whose segments overflow
     tile_capacity) and on 64 sampled tiles of the real camera and sun passes
     (the 8 deepest among them); kernel and plain times at both pass shapes;
  4. the paths, each on the 638,700-triangle SunTemple stand-in at 1920x1088
     with a 2048^2 shadow map, through Renderer.render, the sun moving on
     frame 5, every launch count set to 0 just before the path and read just
     after:
       A  SUNTEMPLE_1080P (GI on, folded kernel K1), 8 frames;
       B  SUNTEMPLE_1080P_ROWBLOCK (GI on, rowblock kernel K2), 8 frames;
       no-GI  SUNTEMPLE_1080P_NO_GI (K1), 3 frames;
     checking the images, the lightgrid, when voxelize ran, the overflow
     counters and each kernel's launch count; frame 0's camera pass through
     both kernels (ids that differ); then small 160x96 frames rendered on the
     card against the same frames through the plain CPU path (SSIM), GI off
     and GI on through both kernels;
  5. the summary lines; the last line is the JSON status object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SCENE_DETAIL, TEXTURE_SIZE, N_TRIS = 4.5, 256, 638_700
N_FRAMES, SUN, SUN_MOVED, SUN_MOVE_FRAME = 8, (50.0, 30.0), (55.0, 30.0), 5
N_FRAMES_NO_GI = 3
KERNELS = ("vis_folded", "vis_rowblock")
N_SAMPLED_TILES = 64
DEPTH_ATOL = 1e-6


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms of fn() over reps runs, after one warm-up run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 1 + 2


def phase_card():
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(f"card: {nvidia_smi()}", flush=True)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from vulkan_pbr_renderer_tpu_torch.gpu import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(cuda_build.build, KERNELS))
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (path, seconds, log) in zip(KERNELS, built):
        print(f"build: {name} -> {path.name} in {seconds:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        cuda_build.load_library(name)


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1, 1, (n, 1, 2))
    verts = center + rng.uniform(-0.4, 0.4, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).repeat(3, 1)
    return np.concatenate([verts, z, np.ones((n, 3, 1))], -1).astype(np.float32)


def _crossing_tris(n, seed):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-2, 2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32).repeat(3, 1)
    w = rng.uniform(-0.5, 1.5, (n, 3, 1)).astype(np.float32)
    return np.concatenate([verts * np.abs(w), z * np.abs(w), w], -1)


def _compare(d_k, i_k, d_p, i_p, what):
    """ids exactly equal, depth within DEPTH_ATOL; returns max |depth diff|."""
    d_k, i_k, d_p, i_p = (t.cpu().numpy() for t in (d_k, i_k, d_p, i_p))
    bad = int((i_k != i_p).sum())
    check(bad == 0, f"{what}: {bad} ids differ from the plain version")
    check((np.isinf(d_k) == np.isinf(d_p)).all(), f"{what}: coverage differs")
    fin = np.isfinite(d_k)
    err = float(np.abs(d_k[fin] - d_p[fin]).max()) if fin.any() else 0.0
    check(err <= DEPTH_ATOL, f"{what}: depth error {err} > {DEPTH_ATOL}")
    return err


def phase_kernel_random(dev):
    """The three triangle sets of tests/test_raster_pallas.py."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility_v2, xla_raster

    cases = [("random600_seed11", _random_tris(600, 11), 128, 96),
             ("crossing40_seed21", _crossing_tris(40, 21), 160, 96),
             ("random300_seed1", _random_tris(300, 1), 256, 160)]
    err = 0.0
    for name, clip, w, h in cases:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        bins = binning.bin_triangles(s, w, h, 32, pair_capacity=8 * clip.shape[0])
        d_k, i_k = visibility_v2.vis_folded_tiles(bins.starts, bins.pair_data, bins.tiles_x)
        d_p, i_p = visibility_v2.vis_folded_plain(bins.starts, bins.pair_data, bins.tiles_x)
        err = max(err, _compare(d_k, i_k, d_p, i_p, f"{name} (segment plain)"))
        d_b, i_b = xla_raster.rasterize_vis(s, w, h)
        d_u = visibility_v2.unfold_tiles(d_k, bins.tiles_y, bins.tiles_x, h, w)
        i_u = visibility_v2.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
        err = max(err, _compare(d_u, i_u, d_b, i_b, f"{name} (whole-screen plain)"))
        print(f"kernel vs plain: {name} {w}x{h} ok", flush=True)
    return err


def phase_rowblock_random(dev):
    """K2 on the three triangle sets of tests/test_raster_pallas.py and on a
    set whose segments overflow tile_capacity (the capacity cut in force)."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup, visibility, xla_raster

    cases = [("random600_seed11", _random_tris(600, 11), 128, 96, 4096, 128),
             ("crossing40_seed21", _crossing_tris(40, 21), 160, 96, 4096, 128),
             ("random300_seed1", _random_tris(300, 1), 256, 160, 4096, 128),
             ("random300_seed1_cap64", _random_tris(300, 1), 256, 160, 64, 16)]
    err = 0.0
    for name, clip, w, h, cap, chunk in cases:
        s = setup.setup_triangles(torch.from_numpy(clip).to(dev), w, h, cull="none")
        bins = binning.bin_triangles(s, w, h, 32, 8 * clip.shape[0], chunk, fmt="wide16",
                                     tile_w=128)
        d_k, i_k = visibility.vis_rowblock_tiles(bins.starts, bins.pair_data, bins.tiles_x,
                                                 cap, chunk)
        d_p, i_p = visibility.vis_rowblock_plain(bins.starts, bins.pair_data, bins.tiles_x,
                                                 cap, chunk)
        err = max(err, _compare(d_k, i_k, d_p, i_p, f"rowblock {name} (segment plain)"))
        max_seg = int(bins.max_segment)
        if max_seg <= cap:
            d_b, i_b = xla_raster.rasterize_vis(s, w, h)
            d_u = visibility.unfold_tiles(d_k, bins.tiles_y, bins.tiles_x, h, w)
            i_u = visibility.unfold_tiles(i_k, bins.tiles_y, bins.tiles_x, h, w)
            err = max(err, _compare(d_u, i_u, d_b, i_b,
                                    f"rowblock {name} (whole-screen plain)"))
        else:
            print(f"  {name}: deepest segment {max_seg} > tile_capacity {cap}, "
                  "the capacity cut is in force", flush=True)
        print(f"rowblock kernel vs plain: {name} {w}x{h} ok", flush=True)
    return err


def _pass_bins(scene, mat, size, cull, cfg, jitter=None):
    """Bins of one real raster pass in the format of cfg.raster_kernel."""
    from vulkan_pbr_renderer_tpu_torch.raster import binning, setup

    tri_pos = scene.tri_attr[:, :9].reshape(-1, 3, 3)
    s = setup.setup_triangles(setup.transform_to_clip(tri_pos, mat, jitter),
                              size[0], size[1], cull=cull)
    cap = cfg.pair_capacity_factor * scene.num_tris
    if cfg.raster_kernel == "rowblock":
        return binning.bin_triangles(s, size[0], size[1], cfg.tile_h, cap, cfg.tri_chunk,
                                     fmt="wide16", tile_w=cfg.tile_w)
    return binning.bin_triangles(s, size[0], size[1], 32, cap, cfg.tri_chunk)


def phase_kernel_real(renderer, cam, sun_angle):
    """64 sampled tiles (the 8 deepest among them) of the real camera and sun
    passes through the kernel of renderer.cfg.raster_kernel, and the
    kernel's time against the plain version's at both shapes."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import frame_inputs
    from vulkan_pbr_renderer_tpu_torch.raster import visibility, visibility_v2

    cfg, scene = renderer.cfg, renderer.scene
    if cfg.raster_kernel == "rowblock":
        def kernel(b):
            return visibility.vis_rowblock_tiles(b.starts, b.pair_data, b.tiles_x,
                                                 cfg.tile_capacity, cfg.tri_chunk)

        def plain(b, tiles=None):
            return visibility.vis_rowblock_plain(b.starts, b.pair_data, b.tiles_x,
                                                 cfg.tile_capacity, cfg.tri_chunk, tiles=tiles)
    else:
        def kernel(b):
            return visibility_v2.vis_folded_tiles(b.starts, b.pair_data, b.tiles_x)

        def plain(b, tiles=None):
            return visibility_v2.vis_folded_plain(b.starts, b.pair_data, b.tiles_x,
                                                  tiles=tiles)
    fi = frame_inputs(renderer.state, cam, sun_angle, cfg)
    passes = {
        "camera": _pass_bins(scene, cam.clip_from_world, (cfg.width, cfg.height),
                             "back", cfg, fi.jitter),
        "sun": _pass_bins(scene, fi.sun_from_world, (cfg.shadow_map_size,) * 2,
                          "none", cfg),
    }
    rng = np.random.default_rng(0)
    out, err = {}, 0.0
    for name, bins in passes.items():
        seg = (bins.starts[1:] - bins.starts[:-1]).cpu().numpy()
        deepest = np.argsort(seg)[-8:]
        rest = rng.choice(np.setdiff1d(np.arange(seg.size), deepest),
                          N_SAMPLED_TILES - deepest.size, replace=False)
        tiles = torch.as_tensor(np.concatenate([deepest, rest]), device=bins.starts.device)
        d_k, i_k = kernel(bins)
        d_p, i_p = plain(bins, tiles)
        err = max(err, _compare(d_k[tiles], i_k[tiles], d_p, i_p,
                                f"{cfg.raster_kernel} {name} pass tiles"))
        ms = cuda_ms(lambda: kernel(bins), reps=20)
        plain_ms = cuda_ms(lambda: plain(bins), reps=2)
        out[name] = dict(ms=ms, plain_ms=plain_ms, tiles=int(seg.size),
                         pairs=int(bins.total_pairs), max_segment=int(seg.max()))
        print(f"{cfg.raster_kernel} kernel vs plain: {name} pass {N_SAMPLED_TILES} tiles "
              f"ok; {seg.size} tiles, {int(bins.total_pairs)} pairs, deepest segment "
              f"{int(seg.max())}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return out, err


# ---------------------------------------------------------------------------
# phase 4: the main path


def _ssim(a, b):
    """Mean SSIM (Gaussian 11x11, sigma 1.5) as in the reference package's
    utils/image.ssim, for [H,W,3] images in [0,1]."""
    x = np.arange(11) - 5
    k = np.exp(-x * x / (2 * 1.5 ** 2))
    k /= k.sum()

    def blur(img):
        pad = np.pad(img, ((5, 5), (5, 5), (0, 0)), mode="reflect")
        rows = sum(k[i] * pad[i:i + img.shape[0]] for i in range(11))
        return sum(k[i] * rows[:, i:i + img.shape[1]] for i in range(11))

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ma, mb = blur(a), blur(b)
    saa, sbb, sab = blur(a * a) - ma * ma, blur(b * b) - mb * mb, blur(a * b) - ma * mb
    return float(np.mean((2 * ma * mb + c1) * (2 * sab + c2)
                         / ((ma * ma + mb * mb + c1) * (saa + sbb + c2))))


def phase_small_frame_vs_cpu():
    """160x96 plane + cube frames through the kernels on the card against the
    same frames through the plain path on the CPU: GI off (K1), and GI on
    (lightgrid 16) through K1 and through K2."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import procedural
    from vulkan_pbr_renderer_tpu_torch.assets.scene import MaterialDesc, build_scene
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

    base = RenderConfig(width=160, height=96, shadow_map_size=128, prefiltered_env_size=16,
                        prefiltered_env_min_size=8, prefilter_samples=256, brdf_lut_size=16,
                        brdf_lut_samples=256, bloom_pass_count=3, light_shaft_steps=4,
                        lightgrid_size=16, lightgrid_extent=10.0)
    scene = build_scene([procedural.make_plane((0, 0, 0), (12, 12), 2, 0),
                         procedural.make_cube((0, 0, 1.0), (2, 2, 2), 0)],
                        [MaterialDesc(orm_factor=(1.0, 0.5, 0.0))], texture_size=16)
    cam = make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), base)
    variants = [("GI off, folded", base.replace(enable_gi=False)),
                ("GI on, folded", base),
                ("GI on, rowblock", base.replace(raster_kernel="rowblock"))]
    out = {}
    for name, cfg in variants:
        imgs = {}
        for dev in ("cpu", "cuda"):
            r = Renderer(cfg, scene, device=dev)
            for i in range(3):
                img = r.render(cam, sun_angle=(40.0, 120.0 if i < 2 else 125.0))
            imgs[dev] = img.cpu().numpy()
        s = _ssim(imgs["cuda"], imgs["cpu"])
        check(s >= 0.995, f"small frame ({name}): card vs CPU SSIM {s} < 0.995")
        print(f"small frame 160x96 ({name}): card vs CPU plain path SSIM {s:.6f}",
              flush=True)
        out[name] = s
    return out


def _check_images(imgs, cfg, what):
    for i, img in enumerate(imgs):
        check(tuple(img.shape) == (cfg.height, cfg.width, 3), f"{what} frame {i} shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{what} frame {i} has non-finite values")
        lo, hi, sd = float(img.min()), float(img.max()), float(img.std())
        check(0.0 <= lo and hi <= 1.0, f"{what} frame {i} outside [0,1]: [{lo}, {hi}]")
        check(sd > 1e-3, f"{what} frame {i} is constant (std {sd})")


def run_path(name, cfg, scene, n_frames, check_kernel):
    """Drive one path through Renderer.render with every launch count set to
    0 just before it and read just after.  With check_kernel, first hold the
    path's kernel against its plain version on frame 0's real passes (those
    launches fall before the counted run).  Returns (stats, real-pass
    kernel stats or None)."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import Renderer, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.raster import visibility, visibility_v2

    t0 = time.perf_counter()
    r = Renderer(cfg, scene, device="cuda")
    torch.cuda.synchronize()
    print(f"path {name}: renderer + IBL bake on the card {time.perf_counter() - t0:.1f} s",
          flush=True)
    cams = [make_camera(*suntemple.camera_path(i / (N_FRAMES - 1)), cfg, device="cuda")
            for i in range(n_frames)]
    suns = [SUN_MOVED if i >= SUN_MOVE_FRAME else SUN for i in range(n_frames)]
    real = phase_kernel_real(r, cams[0], SUN) if check_kernel else None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    visibility_v2.vis_folded_tiles.launches = 0
    visibility.vis_rowblock_tiles.launches = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_frames + 1)]
    imgs, voxelized, grid_sums = [], [], []
    events[0].record()
    for i in range(n_frames):
        before = r.state.voxelize_count
        imgs.append(r.render(cams[i], suns[i]))
        events[i + 1].record()
        voxelized.append(r.state.voxelize_count - before)
        grid_sums.append(r.state.lightgrid.abs().sum())
    torch.cuda.synchronize()
    launches = {"vis_folded": visibility_v2.vis_folded_tiles.launches,
                "vis_rowblock": visibility.vis_rowblock_tiles.launches}
    frame_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_frames)]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # camera pass every frame + sun pass on frame 0 and when the sun moved
    expected = n_frames + sum(1 for i in range(n_frames) if i == 0 or suns[i] != suns[i - 1])
    used = "vis_rowblock" if cfg.raster_kernel == "rowblock" else "vis_folded"
    for k, n in launches.items():
        want = expected if k == used else 0
        check(n == want, f"path {name}: {k} launched {n} times, expected {want}")
    _check_images(imgs, cfg, f"path {name}")
    if cfg.enable_gi:
        want_vox = [1 if i == 0 or suns[i] != suns[i - 1] else 0 for i in range(n_frames)]
        check(voxelized == want_vox, f"path {name}: voxelize ran {voxelized}, expected {want_vox}")
        check(all(float(g) > 0.0 for g in grid_sums), f"path {name}: lightgrid is zero")
    ok, msg = r.check_overflow()
    check(ok, f"path {name}: {msg}")
    print(f"path {name}: {n_frames} frames {cfg.width}x{cfg.height}, shadow "
          f"{cfg.shadow_map_size}^2, GI {'on' if cfg.enable_gi else 'off'}, "
          f"raster {cfg.raster_kernel}; launches {launches}; voxelize on frames "
          f"{[i for i, v in enumerate(voxelized) if v]}; {msg}", flush=True)
    print(f"path {name}: frame ms (CUDA events): " + " ".join(f"{t:.2f}" for t in frame_ms),
          flush=True)
    steady = [t for i, t in enumerate(frame_ms) if i > 0 and suns[i] == suns[i - 1]]
    med = float(np.median(steady))
    print(f"path {name}: steady frames (no sun redraw) median {med:.2f} ms; peak memory "
          f"{peak_gib:.2f} GiB; card {nvidia_smi()}", flush=True)
    return dict(launches=launches[used], frame_ms=frame_ms, steady_median_ms=med,
                peak_gib=peak_gib, kernel=used), real


def phase_k1_k2_ids(scene, cfg_a, cfg_b):
    """Frame 0's camera pass through K1 and K2 (outside the counted paths):
    the number of pixels whose ids differ.  Both keep the nearest depth and,
    on equal depths, the smallest id, so 0 is expected."""
    from vulkan_pbr_renderer_tpu_torch.app.renderer import _rasterize, make_camera
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.utils import noise

    cam = make_camera(*suntemple.camera_path(0.0), cfg_a, device="cuda")
    jitter = torch.as_tensor(noise.taa_jitter(0, cfg_a.width, cfg_a.height), device="cuda")
    _, d_a, i_a, _ = _rasterize(scene, cam.clip_from_world, cfg_a.width, cfg_a.height, cfg_a,
                                jitter=jitter)
    _, d_b, i_b, _ = _rasterize(scene, cam.clip_from_world, cfg_b.width, cfg_b.height, cfg_b,
                                jitter=jitter)
    diff = int((i_a != i_b).sum())
    covered = int((i_a >= 0).sum())
    print(f"frame 0 camera pass: {diff} of {covered} covered pixels have ids that differ "
          "between K2 and K1", flush=True)
    return diff


def phase_paths():
    from vulkan_pbr_renderer_tpu_torch.assets import suntemple
    from vulkan_pbr_renderer_tpu_torch.assets.scene import build_scene
    from vulkan_pbr_renderer_tpu_torch.config import (SUNTEMPLE_1080P, SUNTEMPLE_1080P_NO_GI,
                                                      SUNTEMPLE_1080P_ROWBLOCK)

    t0 = time.perf_counter()
    scene = build_scene(suntemple.build_parts(SCENE_DETAIL), suntemple.materials(),
                        texture_size=TEXTURE_SIZE, device="cuda")
    print(f"scene: {scene.num_tris} triangles, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(scene.num_tris == N_TRIS, f"expected {N_TRIS} triangles, got {scene.num_tris}")

    paths, real = {}, {}
    for name, cfg, n in (("A", SUNTEMPLE_1080P, N_FRAMES),
                         ("B", SUNTEMPLE_1080P_ROWBLOCK, N_FRAMES),
                         ("no-GI", SUNTEMPLE_1080P_NO_GI, N_FRAMES_NO_GI)):
        stats, kernel_real = run_path(name, cfg, scene, n, check_kernel=name != "no-GI")
        paths[name] = stats
        if kernel_real is not None:
            real[stats["kernel"]] = kernel_real
        torch.cuda.empty_cache()
    diff = phase_k1_k2_ids(scene, SUNTEMPLE_1080P, SUNTEMPLE_1080P_ROWBLOCK)
    return paths, real, diff


def main():
    phase_card()
    phase_build()
    err = {"vis_folded": phase_kernel_random("cuda"),
           "vis_rowblock": phase_rowblock_random("cuda")}
    paths, real, id_diff = phase_paths()
    ssim = phase_small_frame_vs_cpu()
    sources = {"vis_folded": ("vulkan_pbr_renderer_tpu_torch/csrc/vis_folded.cu",
                              "vulkan_pbr_renderer_tpu/raster/visibility_v2.py:55", "A"),
               "vis_rowblock": ("vulkan_pbr_renderer_tpu_torch/csrc/vis_rowblock.cu",
                                "vulkan_pbr_renderer_tpu/raster/visibility.py:42", "B")}
    kernels = []
    for name, (source, replaces, path) in sources.items():
        stats, err_real = real[name]
        cam_t, sun_t = stats["camera"], stats["sun"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[path]["launches"], "max_abs_err": max(err[name], err_real),
            "ms": cam_t["ms"], "plain_ms": cam_t["plain_ms"],
            "shape": "camera pass 1920x1088", "path": path,
            "sun_pass_ms": sun_t["ms"], "sun_pass_plain_ms": sun_t["plain_ms"]})
    print(json.dumps({"kernels": kernels, "paths": {
        k: {"steady_median_ms": v["steady_median_ms"], "peak_gib": v["peak_gib"]}
        for k, v in paths.items()}, "k1_k2_id_diff_frame0": id_diff,
        "small_frame_ssim": ssim}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
