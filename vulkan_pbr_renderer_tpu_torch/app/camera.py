"""FPS camera — host-side port of src/utils/camera.h (counterpart of
vulkan_pbr_renderer_tpu/app/camera.py).

Pitch/yaw orientation built exactly like the reference (camera.h:56-65:
ori = yaw_about_Z * (pitch - pi/2)_about_X, so pitch 0 looks at +Y with Z up),
WASD+QE movement with Shift x3 / Ctrl x0.1 (camera.h:67-92), and the lazy
0.2-lerp smoothing (camera.h:95-96).  Matrices follow camera.h:102-120 via
utils.math3d.  The state is numpy f32 on the host; the quaternion and matrix
products run in f32 on the CPU, and only matrices() puts tensors on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..utils import math3d as m3


def _f32(x):
    return torch.from_numpy(np.array(x, np.float32))


@dataclasses.dataclass
class FpsCamera:
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    pitch: float = 0.0
    yaw: float = 0.0
    lazy_pos: np.ndarray | None = None
    lazy_ori: np.ndarray | None = None

    def orientation(self):
        pitch_rot = m3.quat_from_axis_angle(_f32([1.0, 0.0, 0.0]), _f32(self.pitch - np.pi / 2))
        yaw_rot = m3.quat_from_axis_angle(_f32([0.0, 0.0, 1.0]), _f32(self.yaw))
        return m3.quat_normalize(m3.quat_mul(yaw_rot, pitch_rot))

    def update(self, dt, move=(0.0, 0.0, 0.0), mouse=(0.0, 0.0),
               speed=2.0, mouse_speed=0.002, shift=False, ctrl=False):
        """move = (forward, right, up) in {-1,0,1}; mouse = raw deltas."""
        self.yaw += -mouse_speed * mouse[0]
        self.pitch += -mouse_speed * mouse[1]
        ori = self.orientation()
        world_from_view = m3.quat_to_mat4(ori).numpy()
        fwd = world_from_view[:3, 2]
        right = world_from_view[:3, 0]
        v = speed * (3.0 if shift else 1.0) * (0.1 if ctrl else 1.0) * dt
        self.pos = self.pos + fwd * (move[0] * v) + right * (move[1] * v)
        self.pos = self.pos + np.array([0, 0, move[2] * v], np.float32)

        if self.lazy_pos is None:
            self.lazy_pos = self.pos.copy()
            self.lazy_ori = ori.numpy()
        else:
            self.lazy_pos = self.lazy_pos + (self.pos - self.lazy_pos) * 0.2
            self.lazy_ori = m3.quat_slerp(_f32(self.lazy_ori), ori, 0.2).numpy()

    def matrices(self, cfg, device="cuda"):
        """Returns a renderer.CameraState on `device` (the card unless the
        caller asks for the CPU; raises without one) using the lazy-smoothed
        transform."""
        from .renderer import CameraState

        device = resolve_device(device)
        ori = _f32(self.lazy_ori) if self.lazy_ori is not None else self.orientation()
        pos = _f32(self.lazy_pos if self.lazy_pos is not None else self.pos)
        world_from_view = m3.translate(pos) @ m3.quat_to_mat4(ori)
        view_from_world = m3.inverse(world_from_view)
        clip_from_view = m3.perspective_lh_zo(
            np.deg2rad(cfg.fov_y_deg), cfg.aspect, cfg.z_near, cfg.z_far
        )
        clip_from_world = clip_from_view @ view_from_world
        return CameraState(
            clip_from_world=clip_from_world,
            clip_from_view=clip_from_view,
            world_from_clip=m3.inverse(clip_from_world),
            view_from_clip=m3.inverse(clip_from_view),
            view_from_world=view_from_world,
            world_from_view=world_from_view,
            position=pos,
        ).to(device)
