"""Image resampling helpers: the torch counterpart of the parts of
capsaicin_tpu/ops/resample.py that the frame uses (utils.h of the
reference). Images are [H,W,C]; u is horizontal (x / width)."""

from __future__ import annotations

import torch

from .mathops import const


def uv_to_xy(uv, dims):
    """UV -> continuous pixel coords, clamped to dim-1; utils.h:5-9. dims=(W,H)."""
    w, h = dims
    return torch.minimum(uv * const((w, h), uv.device), const((w - 1, h - 1), uv.device))


def _gather_pixels(img, ix, iy):
    """img: [H,W,C]; ix, iy: [...] integer -> [...,C], indices clamped."""
    h, w = img.shape[0], img.shape[1]
    ix = ix.clamp(0, w - 1).long()
    iy = iy.clamp(0, h - 1).long()
    flat = img.reshape(h * w, *img.shape[2:])
    return flat[iy * w + ix]
