"""Headless renderer CLI — the counterpart of the reference's main.cpp (and of
vulkan_pbr_renderer_tpu/app/headless.py).

Instead of a Win32 window + vsync present loop, frames follow a scripted
camera path and are written as PNGs (or just timed in --bench mode).  The
scenes: triangle, cube, spheres, cerberus, suntemple.  Frames render on the
card; --device cpu asks for the CPU (small frames only).

Usage:
  python -m vulkan_pbr_renderer_tpu_torch.app.headless --scene suntemple \
      --frames 60 --width 1920 --height 1088 --out frames
  python -m vulkan_pbr_renderer_tpu_torch.app.headless --scene suntemple --bench
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import RenderConfig
from ..utils import image as imglib

# The reference's resource mount: the absolute path root/reference/resources
# under the filesystem root, OUTSIDE the checkout, the same one the JAX
# package reads.  It is absent on most machines; there `spheres` renders flat
# factors and `cerberus` raises FileNotFoundError.  Nothing else of the port
# reads outside its checkout.
RESOURCE_DIR = os.path.join(os.sep, "root", "reference", "resources")


def build_scene_by_name(name, detail=1.0, texture_size=256, device="cuda"):
    """The named scene on `device` (the card unless the caller asks for the
    CPU; raises without one)."""
    from ..assets import MaterialDesc, build_scene, procedural, suntemple

    if name == "triangle":
        # triangle.cpp parity spirit: an emissive quad; double-sided so the
        # fixed back-face culling of the main pass cannot hide it
        part = procedural.make_plane((0, 2.0, 1.0), (2, 2), 1, 0)
        part.normals = -part.normals
        part.indices = np.concatenate([part.indices, part.indices[:, ::-1]])
        mats = [MaterialDesc(emissive_factor=(0.1, 0.3, 0.8),
                             base_color_factor=(0, 0, 0, 1))]
        return build_scene([part], mats, texture_size=16, device=device)
    if name == "cube":
        mats = [MaterialDesc(base_color=procedural.checker_texture(128, 8),
                             orm_factor=(1.0, 0.6, 0.0))]
        parts = [procedural.make_plane((0, 0, 0), (20, 20), 2, 0, uv_scale=8),
                 procedural.make_cube((0, 0, 1.0), (2, 2, 2), 0)]
        return build_scene(parts, mats, texture_size=texture_size, device=device)
    if name == "spheres":
        # MetalRoughSpheres config (main.cpp spheres demo): roughness x
        # metallic grid under the sun, textured with the real
        # MetalRoughSpheres Albedo/Normal/ORM TGAs when the resource mount is
        # present, flat factors otherwise.
        tex = {}
        res_dir = RESOURCE_DIR
        if os.path.exists(f"{res_dir}/MetalRoughSpheres_Albedo.tga"):
            from ..assets import tga

            def _load(name_):
                img = np.asarray(
                    tga.read_tga(f"{res_dir}/MetalRoughSpheres_{name_}.tga"),
                    np.float32,
                )
                return img / 255.0 if img.max() > 1.5 else img

            # Albedo multiplies the per-sphere tint; Normal adds surface
            # detail.  The ORM map is NOT applied: it encodes the reference
            # model's whole rough x metal grid in one texture, which here is
            # expressed by the per-sphere orm factors instead.
            tex = dict(base_color=_load("Albedo"), normal=_load("Normal"))
        mats, parts = [], []
        for i, rough in enumerate(np.linspace(0.05, 1.0, 6)):
            for j, metal in enumerate([0.0, 1.0]):
                mats.append(MaterialDesc(
                    base_color_factor=(0.8, 0.3, 0.3, 1.0) if metal < 0.5
                    else (0.9, 0.75, 0.4, 1.0),
                    orm_factor=(1.0, float(rough), float(metal)), **tex))
                parts.append(procedural.make_uv_sphere(
                    (-7.5 + 3.0 * i, 0, 1.2 + 3.0 * j), 1.2, 24, 48, len(mats) - 1))
        parts.append(procedural.make_plane((0, 0, -0.2), (30, 12), 2, len(mats)))
        mats.append(MaterialDesc(base_color_factor=(0.5, 0.5, 0.5, 1.0)))
        return build_scene(parts, mats, texture_size=texture_size, device=device)
    if name == "cerberus":
        from ..assets import gltf

        parts, mats = gltf.load_glb(os.path.join(RESOURCE_DIR, "Cerberus.glb"))
        # the Cerberus texture set is stripped from the mount; give the gun a
        # plausible gunmetal material so the IBL response is visible
        mats[0].base_color_factor = (0.35, 0.33, 0.32, 1.0)
        mats[0].orm_factor = (1.0, 0.45, 1.0)
        return build_scene(parts, mats, texture_size=texture_size, device=device)
    if name == "suntemple":
        parts = suntemple.build_parts(detail=detail)
        return build_scene(parts, suntemple.materials(), texture_size=texture_size,
                           device=device)
    raise ValueError(f"unknown scene {name!r}")


def camera_for(name, t, cfg, device="cuda"):
    from ..assets import suntemple
    from .renderer import make_camera

    if name == "suntemple":
        pos, tgt = suntemple.camera_path(t)
        return make_camera(pos, tgt, cfg, device=device)
    if name == "spheres":
        return make_camera((14 * np.sin(t * 0.8), -14 * np.cos(t * 0.8), 4.0),
                           (0.0, 0.0, 1.5), cfg, device=device)
    if name == "cerberus":
        a = t * 2.0 * np.pi
        return make_camera((9 * np.sin(a), -9 * np.cos(a), 2.0), (0.0, 0.0, 0.0), cfg,
                           device=device)
    return make_camera((5 * np.sin(t), -6 * np.cos(t * 0.7), 3.0), (0.0, 0.0, 1.0), cfg,
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="suntemple")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--detail", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--sun", type=float, nargs=2, default=(35.0, 80.0))
    ap.add_argument("--no-gi", action="store_true")
    ap.add_argument("--visualize-lightgrid", action="store_true")
    ap.add_argument("--raster", default="auto", choices=["auto", "xla", "pallas"])
    ap.add_argument("--texture-size", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..device import init_devices
    from .renderer import Renderer

    dev = init_devices(device=args.device)  # retries transient init failures
    cfg = RenderConfig(width=args.width, height=args.height)
    if args.no_gi:
        cfg = cfg.replace(enable_gi=False)
    if args.visualize_lightgrid:
        cfg = cfg.replace(visualize_lightgrid=True)
    scene = build_scene_by_name(args.scene, args.detail, args.texture_size, device=dev)
    print(f"scene {args.scene}: {scene.num_tris} tris")
    r = Renderer(cfg, scene, device=dev, raster_backend=args.raster)

    times = []
    for i in range(args.frames):
        t = i / max(args.frames - 1, 1)
        cam = camera_for(args.scene, t, cfg, device=dev)
        t0 = time.perf_counter()
        img = r.render(cam, sun_angle=tuple(args.sun))
        np_img = img.cpu().numpy()  # the copy to the host waits for the frame
        times.append(time.perf_counter() - t0)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            imglib.write_png(os.path.join(args.out, f"frame_{i:04d}.png"), np_img)
        print(f"frame {i}: {times[-1]*1000:.1f} ms")

    ok, msg = r.check_overflow()
    if not ok:
        print(f"WARNING: {msg}")

    if args.bench and len(times) > 2:
        p50 = float(np.median(times[1:]) * 1000)
        print(json.dumps({
            "metric": f"{args.scene}_{args.width}x{args.height}_frame_ms_p50",
            "value": round(p50, 2), "unit": "ms",
            "vs_baseline": round(16.6 / p50, 3),   # the reference's 60 Hz frame
        }))


if __name__ == "__main__":
    main()
