"""Small device-side math library: the torch counterpart of
capsaicin_tpu/ops/mathops.py (math_functions.h and eaw_edge_stopping.h of
the reference renderer).

Vector quantities use a trailing axis of size 3 (or 2), so every function
works over any batch of pixels or rays.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _const(shape: tuple, flat: tuple, device: str) -> torch.Tensor:
    return torch.tensor(flat, dtype=torch.float32, device=device).reshape(shape)


def const(values, device) -> torch.Tensor:
    """A small float32 constant on `device`, uploaded once and then reused,
    so the frame issues no host-to-device copy (which waits for the
    device) for it. The tensor is shared: never write to it."""
    arr = np.asarray(values, dtype=np.float64)
    return _const(arr.shape, tuple(arr.ravel().tolist()), str(torch.device(device)))


def sum_last(x, keepdim: bool = False):
    """Sum over the (short) trailing axis, left to right. A reduction
    kernel adds in another order on the GPU than on the CPU, and the last
    ulp of a ray direction moves hits, shadow tests and reprojection tests
    on curved geometry; adding the components in a fixed order gives both
    devices the same bits."""
    parts = x.unbind(-1)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.unsqueeze(-1) if keepdim else out


def dot(a, b):
    """Batched dot product over the trailing axis."""
    return sum_last(a * b)


def normalize(v):
    """Normalize over the trailing axis."""
    return v / torch.sqrt(sum_last(v * v, keepdim=True))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def luminance(rgb):
    """Rec.601 luma; math_functions.h:24-27."""
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def max_component(v):
    return v.amax(-1)


def _sign(v):
    """+1 where v >= 0, else -1 (HLSL's `v >= 0 ? 1 : -1`)."""
    return torch.where(v >= 0.0, 1.0, -1.0)


def oct_encode(n):
    """Unit vector [...,3] -> [...,2] in [0,1]; math_functions.h:31-59."""
    n = n / sum_last(n.abs(), keepdim=True)
    xy = n[..., :2]
    wrapped = (1.0 - xy.flip(-1).abs()) * _sign(xy)
    xy = torch.where(n[..., 2:3] >= 0.0, xy, wrapped)
    return xy * 0.5 + 0.5


def oct_decode(f):
    """[...,2] in [0,1] -> unit vector [...,3]."""
    f = f * 2.0 - 1.0
    z = 1.0 - f[..., 0].abs() - f[..., 1].abs()
    t = (-z).clamp(0.0, 1.0)[..., None]
    xy = f + torch.where(f >= 0.0, -t, t)
    return normalize(torch.cat([xy, z[..., None]], -1))


def cubic(x, b: float, c: float):
    """Mitchell-Netravali cubic weight; math_functions.h:61-77."""
    x = x.abs()
    x2 = x * x
    x3 = x2 * x
    y1 = (12.0 - 9.0 * b - 6.0 * c) * x3 + (-18.0 + 12.0 * b + 6.0 * c) * x2 + (6.0 - 2.0 * b)
    y2 = (-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2 + (-12.0 * b - 48.0 * c) * x + (
        8.0 * b + 24.0 * c
    )
    y = torch.where(x < 1.0, y1, torch.where(x <= 2.0, y2, 0.0))
    return y / 6.0


# --- Edge stopping weights (eaw_edge_stopping.h) -----------------------------


def normal_weight(n0, n1, s):
    """pow(max(dot(n0,n1),0), s); eaw_edge_stopping.h:4-7."""
    return torch.pow(dot(n0, n1).clamp_min(0.0), s)


def depth_weight(dc, dp, s):
    """exp(-|dc-dp|/s), guarded for s == 0; eaw_edge_stopping.h:9-13."""
    s = torch.as_tensor(s, dtype=dc.dtype, device=dc.device)
    zero = s == 0.0
    t = torch.where(zero, 0.0, (dc - dp).abs() / torch.where(zero, 1.0, s))
    return torch.exp(-t)


def luma_weight(lc, lp, s):
    """exp(-|lc-lp|/s); eaw_edge_stopping.h:15-19."""
    return torch.exp(-(lc - lp).abs() / s)
