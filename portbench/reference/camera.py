"""Physical pinhole camera: primary ray generation and reprojection. The
torch counterpart of capsaicin_tpu/ops/camera.py (camera.h of the
reference)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import mathops as m
from . import sampling


class Camera(NamedTuple):
    """Camera of float32 tensors; mirrors CameraData (data_payload.h:7-19)."""

    position: torch.Tensor  # [3]
    right: torch.Tensor  # [3]
    forward: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    focal_length: torch.Tensor  # 0-d
    sensor_size: torch.Tensor  # [2] (width, height) in meters
    znear: torch.Tensor = torch.tensor(0.0)
    focus_distance: torch.Tensor = torch.tensor(0.0)
    aperture: torch.Tensor = torch.tensor(0.0)


def pixel_grid(width: int, height: int, device=None, row0: int = 0):
    """Integer pixel coordinates [H,W,2] = (x, y) of the image rows
    [row0, row0 + height) (a row block of a mesh session)."""
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], -1)


def create_primary_rays(camera: Camera, xy, dims, frame_count: int):
    """Primary rays for pixels xy; camera.h:39-63.

    xy: [...,2] int pixel coords; dims: (W, H). Returns (origin, direction),
    each [...,3]."""
    s = sampling.sample2d_halton23(frame_count, xy.device)
    dim = m.const(dims, xy.device)
    img_sample = (xy.float() + s) / dim
    c_sample = (img_sample - 0.5) * camera.sensor_size
    direction = m.normalize(
        camera.focal_length * camera.forward
        + c_sample[..., 0:1] * camera.right
        + c_sample[..., 1:2] * camera.up
    )
    origin = camera.position.expand(direction.shape)
    return origin, direction


def calculate_image_plane_uv(camera: Camera, position):
    """Project a world position onto the image plane -> uv in [0,1];
    camera.h:8-37."""
    d = m.normalize(position - camera.position)
    n = m.normalize(camera.forward)
    p = camera.position + n * camera.focal_length
    t = m.dot(n, p - camera.position) / m.dot(n.expand(d.shape), d)
    ip = camera.position + t[..., None] * d
    ipd = ip - p
    u = m.dot(ipd, camera.right) / (0.5 * camera.sensor_size[0])
    v = m.dot(ipd, camera.up) / (0.5 * camera.sensor_size[1])
    return 0.5 * torch.stack([u, v], -1) + 0.5


def reconstruct_world_position(camera: Camera, uv, depth):
    """uv in [0,1] + camera-distance depth -> world position; camera.h:65-80."""
    c_sample = (uv - 0.5) * camera.sensor_size
    d = m.normalize(
        camera.focal_length * camera.forward
        + c_sample[..., 0:1] * camera.right
        + c_sample[..., 1:2] * camera.up
    )
    return camera.position + depth[..., None] * d
