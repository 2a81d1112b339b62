"""Camera poses on the host, as float32 numpy leaves in the field order of
the program's and the reference's Camera (position, right, forward, up,
focal_length, sensor_size, znear, focus_distance, aperture), and the fly
camera's mouse look: a frozen copy of capsaicin_tpu_torch/viewer/input.py
(input_system.cpp:104-148; 0.01525 degrees a pixel a millisecond)."""

from __future__ import annotations

import math

import numpy as np

MOUSE_SENSITIVITY = 0.01525  # degrees per pixel per ms (input_system.cpp:112)
FIELDS = ("position", "right", "forward", "up", "focal_length", "sensor_size", "znear",
          "focus_distance", "aperture")


def preset(name: str, width: int, height: int) -> dict:
    """The preset pose of a procedural scene with its sensor fitted to the
    aspect (scene/procedural.py's camera_preset and make_camera)."""
    focal = 0.016
    if name == "cornell":
        pose = dict(position=[0.0, 1.0, -3.6], right=[1.0, 0.0, 0.0], forward=[0.0, 0.0, 1.0],
                    up=[0.0, 1.0, 0.0])
        focal = 0.040
    elif name == "colonnade":
        f = np.array([0.85, -0.22, 0.48])
        f = f / np.linalg.norm(f)
        r = np.cross(np.array([0.0, 1.0, 0.0]), f)
        r /= np.linalg.norm(r)
        pose = dict(position=[-17.5, 6.0, -7.5], right=r.astype(np.float32),
                    forward=f.astype(np.float32), up=np.cross(f, r).astype(np.float32))
    else:
        raise ValueError(f"unknown camera preset {name!r}")
    cam = {k: np.asarray(v, np.float32) for k, v in pose.items()}
    cam.update(focal_length=np.float32(focal),
               sensor_size=np.array([0.036, 0.036 * (height / width)], np.float32),
               znear=np.float32(0.0), focus_distance=np.float32(0.0), aperture=np.float32(0.0))
    return cam


def yaw_pitch(cam: dict):
    """The pose's yaw and pitch in degrees (CameraRig.from_camera)."""
    f = np.asarray(cam["forward"], np.float64)
    return (math.degrees(math.atan2(f[0], f[2])),
            math.degrees(math.asin(max(-1.0, min(1.0, -f[1])))))


def look(cam: dict, yaw: float, pitch: float) -> dict:
    """`cam` with its basis rebuilt from yaw and pitch in degrees and the
    world up (CameraRig._rebuild_basis)."""
    cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
    cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
    forward = np.array([sy * cp, -sp, cy * cp])
    forward /= np.linalg.norm(forward)
    right = -np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    return dict(cam, forward=forward.astype(np.float32), right=right.astype(np.float32),
                up=up.astype(np.float32))


def as_camera(cam: dict, camera_type, device="cpu"):
    """The pose as `camera_type` (a Camera named tuple) of float32 tensors."""
    import torch

    return camera_type(*[torch.as_tensor(np.asarray(cam[k], np.float32), device=device)
                         for k in FIELDS])
