#!/usr/bin/env python3
"""Probe of the port's CPU arithmetic across intra-op threads: a fresh
process makes its first call of an op with several threads, then the same
call with one thread, and the script counts the runs in which the two
differ.  It found that on the CPU torch.sqrt (MKL's vector math) can return
one thread's chunk of its first parallel call at ~12-bit accuracy.

Run from the repository root (CPU only, no card, no jax):

    python3 cpu_threads_probe.py --what sqrt|taa|taa_unrepaired
                                 [--runs 200] [--procs 6] [--threads 4]

  - sqrt: torch.sqrt on 272x480x3 uniform values in [0, 4);
  - taa: shade/taa.py's taa_resolve_plain, bilinear history, at 272x480
    with velocities of sigma 0.2 uv (tests/test_torch_taa_shafts.py's
    inputs);
  - taa_unrepaired: the same with torch.sqrt in place of taa._sqrt.
--procs fresh processes run at once; their load is part of the probe.
Prints a line per run that differs (how many values, which rows, the
largest relative difference) and a summary line.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

H, W = 272, 480


def child(what, threads):
    """One fresh process: the first call with `threads` threads, then one."""
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    rng = np.random.default_rng(5)
    if what == "sqrt":
        x = torch.from_numpy(rng.uniform(0, 4, (H, W, 3)).astype(np.float32))

        def call():
            return torch.sqrt(x).numpy().copy()
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from vulkan_pbr_renderer_tpu_torch.shade import taa

        if what == "taa_unrepaired":
            taa._sqrt = torch.sqrt
        vel = rng.normal(0, 0.2, (H, W, 2)).astype(np.float32)
        ins = [torch.from_numpy(a) for a in (
            rng.uniform(0, 4, (H, W, 3)).astype(np.float32),
            rng.uniform(0, 1, (H, W)).astype(np.float32), vel,
            rng.normal(0, 0.2, (H, W, 2)).astype(np.float32),
            rng.uniform(0, 4, (H, W, 3)).astype(np.float32))]

        def call():
            return taa.taa_resolve_plain(*ins, catmull_history=False).numpy().copy()
    first = call()
    torch.set_num_threads(1)
    again = call()
    differ = first.view(np.int32) != again.view(np.int32)
    rows = np.nonzero(differ.reshape(H, -1).any(1))[0]
    rel = np.abs(first[differ].astype(np.float64) / again[differ] - 1.0)
    print(int(differ.sum()), f"rows {rows.min()}-{rows.max()}, relative difference up to "
          f"{rel.max():.3g}" if len(rows) else "")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--what", choices=("sqrt", "taa", "taa_unrepaired"), default="sqrt")
    parser.add_argument("--runs", type=int, default=200)
    parser.add_argument("--procs", type=int, default=6)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.what, args.threads)
        return

    def run(i):
        out = subprocess.run([sys.executable, __file__, "--child", "--what", args.what,
                              "--threads", str(args.threads)], capture_output=True, text=True,
                             check=True, timeout=600)
        return i, out.stdout.strip()

    hits = 0
    with ThreadPoolExecutor(args.procs) as pool:
        for i, line in pool.map(run, range(args.runs)):
            if not line.startswith("0"):
                hits += 1
                print(f"run {i}: {line.replace(' ', ' values differ, ', 1)}", flush=True)
    print(f"{args.what}: {hits} of {args.runs} fresh processes ({args.threads} threads, "
          f"{args.procs} at once) differ from one thread's call", flush=True)


if __name__ == "__main__":
    main()
