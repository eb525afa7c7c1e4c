#!/usr/bin/env python3
"""Probe of torch.profiler's lost device events on one GPU.

Run from the repository root:

    python3 profiler_probe.py [SECONDS]      (default 240)

For SECONDS it alternates two kinds of profiler session around the same
work (a device sleep, an elementwise chain and its sum: four kernels, a
device sleep): one that launches at once and stops at once, and one that
idles pass_profile.PADS_S[0] on the host at each end, as the first
try of pass_profile.device_events does; a 4096^3 matmul runs between sessions.
Each session whose device events are not both sleeps and the work between
them is printed with its order of events ("S" a sleep, "k" another
kernel), and so is every 50th; the last line counts the sessions that
lost events, per kind.  Fails without a card.
"""

from __future__ import annotations

import sys
import time

import torch

import pass_profile

CUDA = torch.autograd.DeviceType.CUDA
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def session(x, pad):
    """The device events of one session, in time order ("S" a sleep)."""
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        time.sleep(pad)
        torch.cuda._sleep(1000)
        (x * 2 + 1).sum()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(pad)
    dev = sorted((e for e in prof.events() if e.device_type == CUDA),
                 key=lambda e: e.time_range.start)
    return "".join("S" if pass_profile.SENTINEL in e.name else "k" for e in dev)


def main():
    if not torch.cuda.is_available():
        sys.exit("profiler_probe.py: no CUDA device")
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 240.0
    x = torch.rand(1 << 22, device="cuda")
    want = session(x, pass_profile.PADS_S[0])
    lost = {0.0: 0, pass_profile.PADS_S[0]: 0}
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for pad in lost:
            got = session(x, pad)
            lost[pad] += got != want
            if got != want or n % 50 == 0:
                print(f"t={time.perf_counter() - t0:7.1f} s session {n} pad {pad} s: "
                      f"{got or '(nothing)'} (whole: {want})", flush=True)
        torch.randn(4096, 4096, device="cuda") @ torch.randn(4096, 4096, device="cuda")
        torch.cuda.synchronize()
        n += 1
    print(f"sessions that lost device events, by host pad: {lost} of {n} each; card "
          f"{pass_profile.chip_smoke.nvidia_smi()}", flush=True)


if __name__ == "__main__":
    main()
