"""Interactive camera controller: the reference's InputSystem fly camera
(input_system.cpp:49-103 keyboard WASD+QE, :104-148 mouse look), with the
host math of capsaicin_tpu/viewer/input.py: the same speeds, sensitivity
and pitch/yaw construction of forward/right/up from a fixed world up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

MOVEMENT_SPEED = 0.1525  # units per millisecond (input_system.cpp:53)
MOUSE_SENSITIVITY = 0.01525  # degrees per pixel per ms (input_system.cpp:112)


def _host(x) -> np.ndarray:
    """A camera leaf (a tensor on any device, or an array) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, np.float64)


@dataclass
class CameraRig:
    """Mutable pose on the host; converted from and to a Camera at the edges."""

    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, -3.6]))
    forward: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    right: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    yaw: float = 0.0  # degrees
    pitch: float = 0.0

    @classmethod
    def from_camera(cls, camera) -> "CameraRig":
        rig = cls(position=_host(camera.position), forward=_host(camera.forward),
                  right=_host(camera.right), up=_host(camera.up))
        f = rig.forward
        rig.yaw = math.degrees(math.atan2(f[0], f[2]))
        rig.pitch = math.degrees(math.asin(max(-1.0, min(1.0, -f[1]))))
        return rig

    def handle_keys(self, keys: Iterable[str], dt_ms: float):
        """WASD + QE movement, dt in milliseconds (input_system.cpp:49-103)."""
        move = np.zeros(3)
        k = set(keys)
        step = MOVEMENT_SPEED * dt_ms
        if "a" in k:
            move -= self.right * step
        if "d" in k:
            move += self.right * step
        if "s" in k:
            move -= self.forward * step
        if "w" in k:
            move += self.forward * step
        if "q" in k:
            move -= self.up * step
        if "e" in k:
            move += self.up * step
        self.position = self.position + move

    def handle_mouse(self, dx: float, dy: float, dt_ms: float):
        """Left-drag look (input_system.cpp:104-148): accumulate yaw and
        pitch in degrees and rebuild the basis from a fixed world up."""
        self.yaw += dx * MOUSE_SENSITIVITY * dt_ms
        self.pitch += dy * MOUSE_SENSITIVITY * dt_ms
        if abs(self.yaw) >= 360.0:
            self.yaw = 0.0
        if abs(self.pitch) >= 360.0:
            self.pitch = 0.0
        self._rebuild_basis()

    def _rebuild_basis(self):
        """XMMatrixRotationRollPitchYaw applied to +z, then right and up
        from the world up (input_system.cpp:126-146)."""
        cp = math.cos(math.radians(self.pitch))
        sp = math.sin(math.radians(self.pitch))
        cy = math.cos(math.radians(self.yaw))
        sy = math.sin(math.radians(self.yaw))
        # (0,0,1) rotated by pitch about x, then by yaw about y
        forward = np.array([sy * cp, -sp, cy * cp])
        forward /= np.linalg.norm(forward)
        # right = normalize(-cross(forward, up)): DirectXMath's left-handed cross
        right = -np.cross(forward, np.array([0.0, 1.0, 0.0]))
        n = np.linalg.norm(right)
        if n > 1e-9:
            right /= n
        up = np.cross(forward, right)
        self.forward, self.right, self.up = forward, right, up

    def to_camera(self, focal_length: float, sensor_w: float, aspect: float, device="cpu"):
        """The pose as the port's Camera of float32 tensors on `device`."""
        from ..ops.camera import Camera

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return Camera(
            position=t(self.position), right=t(self.right), forward=t(self.forward),
            up=t(self.up), focal_length=t(focal_length),
            sensor_size=t([sensor_w, sensor_w * aspect]),
            znear=t(0.0), focus_distance=t(0.0), aperture=t(0.0),
        )
