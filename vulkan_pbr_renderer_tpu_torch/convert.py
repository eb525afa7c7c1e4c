"""Carry the JAX package's scene, IBL tables and temporal state into the port.

Each function takes plain numpy arrays (e.g. `np.asarray` of the JAX
arrays), so a test or a tool can give both packages the same inputs without
this package importing jax.  Each puts its tensors on `device`: the card
unless the caller asks for the CPU (raises without one).
"""

from __future__ import annotations

import numpy as np
import torch

from .app.renderer import FrameState
from .assets.scene import Scene
from .device import resolve_device
from .gpu import sampling


def _t(a, device, dtype=None):
    return torch.from_numpy(np.array(a, dtype)).to(resolve_device(device))   # a private copy


def scene_from_numpy(d, device="cuda") -> Scene:
    """Scene from a mapping of the JAX Scene's fields as numpy arrays (only
    the fields the port reads are used)."""
    return Scene(
        tex_packed=_t(d["tex_packed"], device, np.uint8),
        tex_scale=_t(d["tex_scale"], device, np.float32),
        tri_attr=_t(d["tri_attr"], device, np.float32),
        mat_id=_t(d["mat_id"], device, np.int32),
        tri_alpha=_t(d["tri_alpha"], device, np.float32),
    )


def bakes_from_numpy(prefiltered_env_raw, brdf_lut, device="cuda"):
    """(window-packed f16 prefiltered env, brdf LUT) from the JAX Renderer's
    `prefiltered_env_raw` [6,S,Wa,3] and `brdf_lut` [L,L,2]."""
    raw = _t(prefiltered_env_raw, device, np.float32)
    return (sampling.pack_cube_mip_atlas_window(raw, raw.shape[1]),
            _t(brdf_lut, device, np.float32))


def state_from_numpy(d, device="cuda") -> FrameState:
    """FrameState from a mapping of the JAX FrameState's fields as numpy
    arrays."""
    sun_prev = np.asarray(d["sun_angle_prev"], np.float32)
    return FrameState(
        lightgrid=_t(d["lightgrid"], device, np.float32),
        gi_cache=_t(d["gi_cache"], device, np.float32),
        sun_depth=_t(d["sun_depth"], device, np.float32),
        taa_history=_t(d["taa_history"], device, np.float32),
        velocity_prev=_t(d["velocity_prev"], device, np.float32),
        # bf16 -> f32 -> bf16 is exact
        prev_pyramid=_t(d["prev_pyramid"], device, np.float32).to(torch.bfloat16),
        clip_from_world_prev=_t(d["clip_from_world_prev"], device, np.float32),
        raster_overflow=_t(d["raster_overflow"], device, np.int32),
        frame_idx=int(np.asarray(d["frame_idx"])),
        sun_angle_prev=(None if not np.all(np.isfinite(sun_prev))
                        else tuple(float(a) for a in sun_prev)),
    )
