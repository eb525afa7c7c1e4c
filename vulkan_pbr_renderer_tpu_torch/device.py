"""Device resolution and f32 precision policy (counterpart of gpu/device.py).

Geometry math (vertex transforms, matrix inverses) must run at true f32:
reduced-precision matmuls quantize clip-space positions into garbage depth —
the same reason the JAX package forces "highest" matmul precision.  TF32 is
therefore off for both cuBLAS matmuls and cuDNN.
"""

from __future__ import annotations

import time

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for but absent
    (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


def init_devices(retries: int = 3, delay_s: float = 2.0, device="cuda") -> torch.device:
    """First contact with the device, retried on transient runtime-init
    failures (CUDA context creation can fail at startup the way Vulkan
    device creation can; the reference only ever asserts,
    gpu_vulkan.c:387-392 — we retry, then surface).  Returns the
    torch.device.  Used by the headless/preview entry points; safe to call
    again once initialized.  Never carries on on the CPU: "cpu" is the
    caller's explicit choice."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    last = None
    for attempt in range(retries):
        try:
            resolve_device(dev)
            torch.cuda.init()
            torch.cuda.get_device_properties(dev)
            return dev
        except RuntimeError as e:  # init failures surface as RuntimeError
            last = e
            if attempt + 1 < retries:
                time.sleep(delay_s * (attempt + 1))
    raise RuntimeError(
        f"device init failed after {retries} attempts: {last}"
    ) from last
