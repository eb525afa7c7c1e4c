#!/usr/bin/env python3
"""Probe of the port's CPU arithmetic across intra-op threads: a fresh
process makes its first call of an op with several threads, then the same
call with one thread, and the script counts the runs in which the two
differ.  It found that on the CPU torch.sqrt (MKL's vector math) can return
one thread's chunk of its first parallel call at ~12-bit accuracy, and
so can exp, log, log2, sin and cos; the plain versions now take their
square roots from utils/math3d.py's sqrt and those functions through its
cpu_serial.

Run from the repository root (CPU only, no card, no jax):

    python3 cpu_threads_probe.py --what NAME [--routed] [--runs 200] [--procs 6]
                                 [--threads 4]

  - one PyTorch function on 272x480x3 uniform values of its domain:
    sqrt, exp, log, log2, pow (x ** (1/2.2), the tonemap's gamma), sin,
    cos, tanh, acos, vector_norm (math3d.normalize's norm over the last
    axis of 3); with --routed, through the port's repair (math3d.sqrt for
    sqrt, math3d.cpu_serial for the others);
  - a plain version of the port on seed-made inputs:
    taa: shade/taa.py's taa_resolve_plain, bilinear history, at 272x480
      with velocities of sigma 0.2 uv (tests/test_torch_taa_shafts.py's
      inputs);
    taa_unrepaired: the same with torch.sqrt in place of math3d.sqrt;
    post: app/renderer.py's post_stack at 272x480 (TAA, the bloom down
      and up chains, the tonemap's pow), the plain versions
      tests/test_torch_post.py runs;
    lanes: shade/gi_modes.py's gi_lane_inputs_plain (sqrt, acos, sin,
      cos, the norms) at 272x480, every lane;
    sweep: shade/gi.py's sweep_lightgrid_u8 on a 64^3 grid, 30% occupied
      (the sweep and quantize_grid_u8's sqrt).
--procs fresh processes run at once; their load is part of the probe.
Prints a line per run that differs (how many values, which of the first
axis's rows, the largest relative difference) and a summary line.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

H, W = 272, 480
# name -> (PyTorch function, the uniform inputs' range)
FUNCTIONS = {
    "sqrt": ("sqrt", (0.0, 4.0)), "exp": ("exp", (-4.0, 4.0)), "log": ("log", (0.01, 4.0)),
    "log2": ("log2", (0.01, 4.0)), "pow": ("pow", (0.0, 4.0)), "sin": ("sin", (-7.0, 7.0)),
    "cos": ("cos", (-7.0, 7.0)), "tanh": ("tanh", (-4.0, 4.0)),
    "acos": ("arccos", (-1.0, 1.0)), "vector_norm": ("vector_norm", (-4.0, 4.0))}
PLAIN = ("taa", "taa_unrepaired", "post", "lanes", "sweep")


def _function_call(what, rng, routed):
    import numpy as np
    import torch

    name, (lo, hi) = FUNCTIONS[what]
    x = torch.from_numpy(rng.uniform(lo, hi, (H, W, 3)).astype(np.float32))
    if name == "pow":
        return lambda: torch.pow(x, 1.0 / 2.2)
    if name == "vector_norm":
        return lambda: torch.linalg.vector_norm(x, dim=-1)
    fn = getattr(torch, name)
    if routed:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from vulkan_pbr_renderer_tpu_torch.utils import math3d as m3

        return (lambda: m3.sqrt(x)) if name == "sqrt" else (lambda: m3.cpu_serial(fn, x))
    return lambda: fn(x)


def _taa_inputs(rng):
    import numpy as np
    import torch

    vel = rng.normal(0, 0.2, (H, W, 2)).astype(np.float32)
    return [torch.from_numpy(a) for a in (
        rng.uniform(0, 4, (H, W, 3)).astype(np.float32),
        rng.uniform(0, 1, (H, W)).astype(np.float32), vel,
        rng.normal(0, 0.2, (H, W, 2)).astype(np.float32),
        rng.uniform(0, 4, (H, W, 3)).astype(np.float32))]


def _plain_call(what, rng):
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vulkan_pbr_renderer_tpu_torch.utils import math3d as m3

    if what in ("taa", "taa_unrepaired"):
        from vulkan_pbr_renderer_tpu_torch.shade import taa

        if what == "taa_unrepaired":
            m3.sqrt = torch.sqrt
        ins = _taa_inputs(rng)
        return lambda: taa.taa_resolve_plain(*ins, catmull_history=False)
    if what == "post":
        from vulkan_pbr_renderer_tpu_torch.app import renderer
        from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

        cfg = RenderConfig(width=W, height=H)
        hdr, depth, vel, vel_prev, history = _taa_inputs(rng)
        state = renderer.init_frame_state(cfg, "cpu")
        state.frame_idx, state.taa_history, state.velocity_prev = 1, history, vel_prev
        return lambda: renderer.post_stack(hdr, depth, vel, state, cfg)
    if what == "lanes":
        from vulkan_pbr_renderer_tpu_torch.shade import gi_modes

        n = rng.normal(0, 1, (H, W, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        ins = [torch.from_numpy(a) for a in (
            n, rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
            rng.uniform(0.2, 0.999, (H, W)).astype(np.float32),
            (np.eye(4) + rng.normal(0, 0.1, (4, 4))).astype(np.float32),
            (np.eye(4) + rng.normal(0, 0.1, (4, 4))).astype(np.float32),
            rng.uniform(-2, 2, 3).astype(np.float32))]
        return lambda: gi_modes.gi_lane_inputs_plain(*ins, 1, 7.0)
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    g = rng.uniform(0, 3, (64, 64, 64, 4)).astype(np.float32)
    g[..., 3] = rng.random((64, 64, 64)) < 0.3
    grid = torch.from_numpy(g)
    return lambda: gi.sweep_lightgrid_u8(grid, 1, (1.0, 1.2, 2.0), 0.5, 0.35)


def _flat(out):
    """The call's output as one flat numpy array per dtype."""
    import numpy as np
    import torch

    ts = [t for t in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(t)]
    f32 = [t.reshape(-1).float().numpy() for t in ts if t.dtype != torch.uint8]
    u8 = [t.reshape(-1).numpy() for t in ts if t.dtype == torch.uint8]
    return (np.concatenate(f32) if f32 else np.zeros(0, np.float32),
            np.concatenate(u8) if u8 else np.zeros(0, np.uint8))


def child(what, threads, routed):
    """One fresh process: the first call with `threads` threads, then one."""
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    rng = np.random.default_rng(5)
    call = (_function_call(what, rng, routed) if what in FUNCTIONS
            else _plain_call(what, rng))
    first = _flat(call())
    torch.set_num_threads(1)
    again = _flat(call())
    differ = first[0].view(np.int32) != again[0].view(np.int32)
    n_u8 = int((first[1] != again[1]).sum())
    idx = np.nonzero(differ)[0]
    rel = np.abs(first[0][differ].astype(np.float64) / again[0][differ] - 1.0)
    print(int(differ.sum()) + n_u8,
          f"flat f32 indices {idx.min()}-{idx.max()}, relative difference up to {rel.max():.3g}; "
          f"{n_u8} u8 values" if len(idx) or n_u8 else "")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--what", choices=tuple(FUNCTIONS) + PLAIN, default="sqrt")
    parser.add_argument("--routed", action="store_true")
    parser.add_argument("--runs", type=int, default=200)
    parser.add_argument("--procs", type=int, default=6)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.what, args.threads, args.routed)
        return

    def run(i):
        out = subprocess.run([sys.executable, __file__, "--child", "--what", args.what,
                              "--threads", str(args.threads)] + ["--routed"] * args.routed,
                             capture_output=True, text=True, check=True, timeout=600)
        return i, out.stdout.strip()

    hits = 0
    with ThreadPoolExecutor(args.procs) as pool:
        for i, line in pool.map(run, range(args.runs)):
            if not line.startswith("0"):
                hits += 1
                print(f"run {i}: {line.replace(' ', ' values differ, ', 1)}", flush=True)
    print(f"{args.what}{' routed' * args.routed}: {hits} of {args.runs} fresh processes "
          f"({args.threads} threads, "
          f"{args.procs} at once) differ from one thread's call", flush=True)


if __name__ == "__main__":
    main()
