"""Color space conversions and color-AABB clipping: the torch counterpart of
capsaicin_tpu/ops/color.py (color_space.h and aabb.h of the reference)."""

from __future__ import annotations

import torch

from .mathops import luminance, max_component


def rgb_to_ycocg(c):
    """color_space.h:8-16."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack(
        [r / 4.0 + g / 2.0 + b / 4.0, r / 2.0 - b / 2.0, -r / 4.0 + g / 2.0 - b / 4.0],
        -1,
    )


def ycocg_to_rgb(c):
    """color_space.h:18-25 (clamped to [0,1])."""
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], -1).clamp(0.0, 1.0)


def simple_tonemap(v):
    """v / (1 + luma(v)); color_space.h:27-30."""
    return v / (1.0 + luminance(v))[..., None]


def invert_simple_tonemap(v):
    """v / (1 - luma(v)); color_space.h:32-35."""
    return v / (1.0 - luminance(v))[..., None]


def clip_to_aabb(pmin, pmax, p):
    """Clip color p toward the AABB center; aabb.h:25-34."""
    c = 0.5 * (pmin + pmax)
    radius = 0.5 * (pmax - pmin)
    dc = p - c
    max_extent = max_component((dc / (radius + 1e-5)).abs())
    clipped = c + dc / max_extent[..., None]
    return torch.where((max_extent > 1.0)[..., None], clipped, p)
