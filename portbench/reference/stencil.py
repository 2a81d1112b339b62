"""The edge-aware stencils in plain torch, float32: the spatial gather,
the EAW chain's disocclusion blur and its a-trous stages, as a frozen copy
of capsaicin_tpu_torch/ops/stencil.py's plain versions. Buffers are
[H,W,C], channels last; a tap is valid inside the image where its depth
is at least 1e-5 (the image is zero-padded, so a pad tap fails the depth
test).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import mathops as m

EPS = 1e-8
FIREFLY_CLAMP = 10.0
SPATIAL_VARIANCE_THRESHOLD = 8.0
_EAW_KW = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # eaw_blur.hlsl:76
GATHER_REACH = 3



def _edge_weights(geo, tap_geo, s_normal, s_depth_r):
    """normal_weight * depth_weight (eaw_edge_stopping.h:4-13)."""
    return (m.normal_weight(geo[..., :3], tap_geo[..., :3], s_normal)
            * m.depth_weight(geo[..., 3], tap_geo[..., 3], s_depth_r))


def _clamped(color4):
    return torch.cat([color4[..., :3].clamp_max(FIREFLY_CLAMP), color4[..., 3:]], -1)


def _taps(x, reach: int):
    """x zero-padded by `reach` on both image axes, and a function giving
    the tap at offset (dx, dy) as an [H,W,C] view."""
    h, w = x.shape[:2]
    xp = F.pad(x, (0, 0, reach, reach, reach, reach))
    return lambda dx, dy: xp[reach + dy: reach + dy + h, reach + dx: reach + dx + w]


def eaw_disocclusion_plain(color4, geo, moments, s_normal, s_depth, s_luma):
    """The plain version of K3 (eaw_blur.hlsl BlurDisocclusion)."""
    dtype = color4.dtype
    col = _clamped(color4.float())
    geo, moments = geo.float(), moments.float()
    rgb, cv = col[..., :3], col[..., 3]
    cd = geo[..., 3]
    hist_len = moments[..., 2]
    cl = m.luminance(rgb)
    s_d_base = cd * s_depth
    col_tap, geo_tap, mom_tap = _taps(col, 3), _taps(geo, 3), _taps(moments, 3)
    acc_c = torch.zeros_like(rgb)
    acc_m = torch.zeros_like(moments[..., :2])
    tw = torch.zeros_like(cd)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            ct, gt, mt = col_tap(dx, dy), geo_tap(dx, dy), mom_tap(dx, dy)
            w = _edge_weights(geo, gt, s_normal, s_d_base * math.sqrt(dx * dx + dy * dy))
            lw = m.luma_weight(cl, m.luminance(ct), s_luma)
            w_full = torch.where(gt[..., 3] >= 1e-5, w * lw, 0.0)
            acc_c = acc_c + w_full[..., None] * ct[..., :3]
            acc_m = acc_m + w_full[..., None] * mt[..., :2]
            tw = tw + w_full
    low = (tw < EPS)[..., None]
    inv = 1.0 / tw.clamp_min(EPS)[..., None]
    f_c = torch.where(low, rgb, acc_c * inv)
    f_m = torch.where(low, 0.0, acc_m * inv)
    boost = SPATIAL_VARIANCE_THRESHOLD / hist_len.clamp_min(1e-5)
    f_v = boost * (f_m[..., 1] - f_m[..., 0] * f_m[..., 0]).abs()
    passthrough = (cd < 1e-5) | (hist_len >= SPATIAL_VARIANCE_THRESHOLD)
    out_c = torch.where(passthrough[..., None], rgb, f_c)
    out_v = torch.where(passthrough, cv, f_v)
    return torch.cat([out_c, out_v[..., None]], -1).to(dtype)


def eaw_stage_plain(color4, geo, stride: int, use_variance: bool, s_normal, s_depth, s_luma):
    """The plain version of K4 (eaw_blur.hlsl Blur at one stride)."""
    dtype = color4.dtype
    col = _clamped(color4.float())
    geo = geo.float()
    rgb, cv = col[..., :3], col[..., 3]
    cd = geo[..., 3]
    cl = m.luminance(rgb)
    s_l_eff = s_luma * torch.sqrt((cv + EPS).clamp_min(0.0))
    s_d_base = cd * float(stride) * s_depth
    col_tap, geo_tap = _taps(col, 2 * stride), _taps(geo, 2 * stride)
    acc_c = torch.zeros_like(rgb)
    acc_v = torch.zeros_like(cv)
    tw = torch.zeros_like(cv)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            ct, gt = col_tap(dx * stride, dy * stride), geo_tap(dx * stride, dy * stride)
            w = _edge_weights(geo, gt, s_normal, s_d_base * math.sqrt(dx * dx + dy * dy))
            valid = gt[..., 3] >= 1e-5
            if use_variance:
                lw = m.luma_weight(cl, m.luminance(ct), s_l_eff)
                hw = _EAW_KW[abs(dx)] * _EAW_KW[abs(dy)]
                w_full = torch.where(valid, w * hw * lw, 0.0)
                hw_w = hw * w
                acc_v = acc_v + torch.where(valid, hw_w * hw_w * lw * lw, 0.0) * ct[..., 3]
            else:
                w_full = torch.where(valid, w, 0.0)
            acc_c = acc_c + w_full[..., None] * ct[..., :3]
            tw = tw + w_full
    low = tw < EPS
    inv = 1.0 / tw.clamp_min(EPS)
    out_c = torch.where(low[..., None], rgb, acc_c * inv[..., None])
    out_v = torch.where(low, cv, acc_v * inv * inv if use_variance else acc_v)
    background = cd < 1e-5
    out_c = torch.where(background[..., None], rgb, out_c)
    out_v = torch.where(background, cv, out_v)
    return torch.cat([out_c, out_v[..., None]], -1).to(dtype)


def spatial_gather_plain(indirect, geo, s_normal, s_depth, s_luma):
    """The plain version of K5 (spatial_gather.hlsl as
    pallas_stencil._gather_kernel computes it: the tap sum times
    1/max(tw, EPS), taps in dy-then-dx order)."""
    dtype = indirect.dtype
    col, geo = indirect.float(), geo.float()
    cd = geo[..., 3]
    cl = m.luminance(col)
    s_d_base = cd * s_depth
    col_tap, geo_tap = _taps(col, 3), _taps(geo, 3)
    acc = torch.zeros_like(col)
    tw = torch.zeros_like(cd)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            ct, gt = col_tap(dx, dy), geo_tap(dx, dy)
            w = _edge_weights(geo, gt, s_normal, s_d_base * math.sqrt(dx * dx + dy * dy))
            lw = m.luma_weight(cl, m.luminance(ct), s_luma)
            w_full = torch.where(gt[..., 3] >= 1e-5, w * lw, 0.0)
            acc = acc + w_full[..., None] * ct
            tw = tw + w_full
    inv = 1.0 / tw.clamp_min(EPS)[..., None]
    out = torch.where((tw < EPS)[..., None], col, acc * inv)
    return torch.where((cd < 1e-5)[..., None], col, out).to(dtype)


def pack_geo(nd_normal, nd_depth):
    """Decoded normals [H,W,3] and depth [H,W] -> geo [H,W,4]."""
    return torch.cat([nd_normal, nd_depth[..., None]], -1)


def chain_strides(options):
    return (1, 3, 5, 7) if options.eaw5 else (1, 3)


def denoise_chain(color4, nd_normal, nd_depth, moments4, settings, options):
    """The EAW chain (raytracing_system.cpp:1437-1539): the disocclusion
    blur, then a-trous stages at strides 1, 3, 5, 7 (1, 3 without eaw5),
    in float32. -> [H,W,4]."""
    geo = pack_geo(nd_normal, nd_depth)
    moments = torch.cat([moments4[..., 0:2], moments4[..., 3:4]], -1)
    sig = (settings.eaw_normal_sigma, settings.eaw_depth_sigma, settings.eaw_luma_sigma)
    out = eaw_disocclusion_plain(color4, geo, moments, *sig)
    for stride in chain_strides(options):
        out = eaw_stage_plain(out, geo, stride, options.use_variance, *sig)
    return out
