"""Sampler library: the torch counterpart of capsaicin_tpu/ops/sampling.py
(sampling.h of the reference renderer).

Frame counters are host integers, so the per-frame phases (Halton index,
blue-noise sub-tile, golden-ratio rotation) are computed on the host and
cost no device synchronisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import mathops as m

PI = 3.141592653589793

GOLDEN = 0.61803398875

# Halton (2,3) 8-entry subpixel jitter table (sampling.h:139-152).
HALTON23 = np.array(
    [
        [0.5, 1.0 / 3.0],
        [0.25, 2.0 / 3.0],
        [0.75, 1.0 / 9.0],
        [0.125, 4.0 / 9.0],
        [0.625, 7.0 / 9.0],
        [0.375, 2.0 / 9.0],
        [0.875, 5.0 / 9.0],
        [0.0625, 8.0 / 9.0],
    ],
    dtype=np.float32,
)


def sample2d_halton23(frame_count: int, device=None):
    """Per-frame subpixel jitter [2]; sampling.h:139-152."""
    table = m.const(HALTON23.tolist(), device or "cpu")  # uploaded once per device
    return table[int(frame_count) % 8]


def _golden_rotation(count: int) -> float:
    """GOLDEN * (count // 16), rounded as float32 arithmetic rounds it."""
    return float(np.float32(GOLDEN) * np.float32(count // 16))


def bluenoise4x4_field(noise, width: int, height: int, count: int,
                       stride: int = 1, offset=(0, 0)):
    """sample2d_bluenoise4x4 (sampling.h:14-24) for the whole pixel grid
    xy[y, x] = (stride*x + offset[0], stride*y + offset[1]).

    The table index is affine in the pixel coordinate, so the field is a
    rolled, strided subsample of the [256,256,2] noise table tiled over
    the grid: a roll and a tile, with no per-pixel gather."""
    count = int(count)
    px = (count % 16) % 4
    py = (count % 16) // 4
    ox, oy = offset
    step = 4 * stride
    period = 256 // math.gcd(step, 256)
    shift_y = 4 * int(oy) + py
    shift_x = 4 * int(ox) + px
    rolled = torch.roll(noise, shifts=(-shift_y, -shift_x), dims=(0, 1))
    tile = rolled[::step, ::step][:period, :period]
    ry = -(-height // period)
    rx = -(-width // period)
    field = tile.repeat(ry, rx, 1)[:height, :width]
    return torch.remainder(field + _golden_rotation(count), 1.0)


def ortho_vector(n):
    """A vector orthogonal to n; sampling.h:92-110."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(nx)
    kz = torch.sqrt(ny * ny + nz * nz)
    kz = torch.where(kz == 0.0, 1.0, kz)
    p_a = torch.stack([zero, -nz / kz, ny / kz], -1)
    kx = torch.sqrt(nx * nx + ny * ny)
    kx = torch.where(kx == 0.0, 1.0, kx)
    p_b = torch.stack([ny / kx, -nx / kx, zero], -1)
    return torch.where((nz.abs() > 0.0)[..., None], p_a, p_b)


def map_to_hemisphere(s, n, e: float):
    """Cosine-power hemisphere mapping about n; sampling.h:112-132."""
    u = ortho_vector(n)
    v = m.cross(u, n)
    u = m.cross(n, v)
    r1 = s[..., 0]
    r2 = s[..., 1]
    sin_psi = torch.sin(2.0 * PI * r1)
    cos_psi = torch.cos(2.0 * PI * r1)
    cos_theta = torch.pow(1.0 - r2, 1.0 / (e + 1.0))
    sin_theta = torch.sqrt((1.0 - cos_theta * cos_theta).clamp_min(0.0))
    d = (
        u * (sin_theta * cos_psi)[..., None]
        + v * (sin_theta * sin_psi)[..., None]
        + n * cos_theta[..., None]
    )
    return m.normalize(d)
