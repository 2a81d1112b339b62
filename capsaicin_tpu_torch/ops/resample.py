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


def pixel_index(x, lo: int, hi: int):
    """Float pixel coordinates -> int64 indices clamped to [lo, hi]. Clamping
    before the conversion keeps far-off (and NaN) coordinates defined."""
    return torch.nan_to_num(x, nan=float(lo)).clamp(lo, hi).long()


def _gather_pixels(img, ix, iy):
    """img: [H,W,C]; ix, iy: [...] integer -> [...,C], indices clamped."""
    h, w = img.shape[0], img.shape[1]
    ix = ix.clamp(0, w - 1).long()
    iy = iy.clamp(0, h - 1).long()
    flat = img.reshape(h * w, *img.shape[2:])
    return flat[iy * w + ix]


def sample_bilinear(img, uv, dims):
    """Bilinear fetch at UV, edge-clamped; utils.h:19-36. dims=(W,H)."""
    xy = uv_to_xy(uv, dims) - 0.5
    fl = torch.floor(xy)
    ix = fl[..., 0].long()
    iy = fl[..., 1].long()
    wx = (xy - fl)[..., 0:1]
    wy = (xy - fl)[..., 1:2]
    top = _gather_pixels(img, ix, iy) * (1.0 - wx) + _gather_pixels(img, ix + 1, iy) * wx
    bot = _gather_pixels(img, ix, iy + 1) * (1.0 - wx) + _gather_pixels(img, ix + 1, iy + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _up(a, axis: int):
    """upsample2x_bilinear along one axis: each output 0.25/0.75 of two
    neighbours (edge-clamped), the last two a 0.5/0.5 blend."""
    n = a.shape[axis]
    prev = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)], axis)
    even = 0.25 * prev + 0.75 * a
    odd = 0.75 * a + 0.25 * nxt
    shape = list(a.shape)
    shape[axis] = 2 * n
    out = torch.stack([even, odd], axis + 1).reshape(shape)
    i0 = max(n - 2, 0)  # n == 1 degenerates to the single texel
    edge = 0.5 * (a.narrow(axis, i0, 1) + a.narrow(axis, n - 1, 1))
    return torch.cat([out.narrow(axis, 0, 2 * n - 2), edge, edge], axis)


def upsample2x_bilinear(img):
    """[h,w,C] -> [2h,2w,C]: exactly sample_bilinear(img, identity uv of
    the doubled grid, (w,h)), including uv_to_xy's upper clamp, which makes
    the last two output rows and columns a 0.5/0.5 blend of the last two
    inputs. The UPSCALE2X current-color fetch of the SVGF accumulate pass
    (temporal_accumulation.hlsl:228-232), whose sample position is always
    the identity map: each output is 0.25/0.75 of two neighbours per axis."""
    return _up(_up(img, 0), 1)


def upsample2x_block(ext, bottom: bool):
    """upsample2x_bilinear's rows of one row block: ext [r+2,w,C] is the
    block's r rows with one halo row above and below (edge-clamped at the
    image's top and bottom); returns its [2r,2w,C]. `bottom`: the block
    holds the image's last row, where the last two output rows are the
    0.5/0.5 blend of the image's last two rows (at no other block's end)."""
    out = _up(ext, 0).narrow(0, 2, 2 * ext.shape[0] - 4)
    if bottom:
        edge = 0.5 * (ext.narrow(0, ext.shape[0] - 3, 1) + ext.narrow(0, ext.shape[0] - 2, 1))
        out = torch.cat([out.narrow(0, 0, out.shape[0] - 2), edge, edge], 0)
    return _up(out, 1)
