"""Edge-aware stencil filters of the EAW denoise chain: the disocclusion
blur (kernel K3, `csrc/eaw_disocclusion.cu`) and one a-trous stage
(kernel K4, `csrc/eaw_stage.cu`). The torch counterpart of the chain in
capsaicin_tpu/ops/pallas_stencil.py.

Buffers are [H,W,C] float32 with channels last: color4 (r, g, b,
variance), geo (decoded normal xyz, depth), moments (m1, m2, history
length). A tap is valid where it lies inside the image and its depth is at
least 1e-5. The plain versions zero-pad the image, so a pad tap has depth 0
and the depth test alone excludes it; the kernels test the bounds
explicitly. Both compute what the planar TPU layout computes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import kernels as K
from . import mathops as m

EPS = 1e-8
FIREFLY_CLAMP = 10.0
SPATIAL_VARIANCE_THRESHOLD = 8.0
_EAW_KW = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # eaw_blur.hlsl:76

K3 = K.register(K.Kernel(
    "eaw_disocclusion", "eaw_disocclusion",
    [K.vp, K.vp, K.vp, K.vp, K.i32, K.i32, K.f32, K.f32, K.f32],
    source="capsaicin_tpu_torch/csrc/eaw_disocclusion.cu",
    replaces="capsaicin_tpu/ops/pallas_stencil.py:265",
))
K4 = K.register(K.Kernel(
    "eaw_stage", "eaw_stage",
    [K.vp, K.vp, K.vp, K.i32, K.i32, K.i32, K.i32, K.f32, K.f32, K.f32],
    source="capsaicin_tpu_torch/csrc/eaw_stage.cu",
    replaces="capsaicin_tpu/ops/pallas_stencil.py:218",
))


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
    col = _clamped(color4)
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
    return torch.cat([out_c, out_v[..., None]], -1)


def eaw_stage_plain(color4, geo, stride: int, use_variance: bool, s_normal, s_depth, s_luma):
    """The plain version of K4 (eaw_blur.hlsl Blur at one stride)."""
    col = _clamped(color4)
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
    return torch.cat([out_c, out_v[..., None]], -1)


def _check_image(x, name, channels, h, w, dev):
    K.check_cuda(x, name, torch.float32, (h, w, channels), dev)
    if channels == 4 and x.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned for float4 reads")


def eaw_disocclusion(color4, geo, moments, s_normal, s_depth, s_luma):
    """K3 on CUDA tensors, its plain version on CPU tensors.
    color4 [H,W,4], geo [H,W,4], moments [H,W,3] -> [H,W,4]."""
    if K.on_cpu(color4):
        return eaw_disocclusion_plain(color4, geo, moments, s_normal, s_depth, s_luma)
    dev = color4.device
    h, w = color4.shape[:2]
    _check_image(color4, "color4", 4, h, w, dev)
    _check_image(geo, "geo", 4, h, w, dev)
    _check_image(moments, "moments", 3, h, w, dev)
    out = torch.empty_like(color4)
    K3.launch(dev, K.ptr(color4), K.ptr(geo), K.ptr(moments), K.ptr(out), h, w,
              float(s_normal), float(s_depth), float(s_luma))
    return out


def eaw_stage(color4, geo, stride: int, use_variance: bool, s_normal, s_depth, s_luma):
    """K4 on CUDA tensors, its plain version on CPU tensors.
    color4 [H,W,4], geo [H,W,4] -> [H,W,4]."""
    if K.on_cpu(color4):
        return eaw_stage_plain(color4, geo, stride, use_variance, s_normal, s_depth, s_luma)
    dev = color4.device
    h, w = color4.shape[:2]
    _check_image(color4, "color4", 4, h, w, dev)
    _check_image(geo, "geo", 4, h, w, dev)
    out = torch.empty_like(color4)
    K4.launch(dev, K.ptr(color4), K.ptr(geo), K.ptr(out), h, w, int(stride),
              int(bool(use_variance)), float(s_normal), float(s_depth), float(s_luma))
    return out


def chain_strides(options):
    return (1, 3, 5, 7) if options.eaw5 else (1, 3)


def denoise_chain(color4, nd_normal, nd_depth, moments4, settings, options):
    """The EAW chain (raytracing_system.cpp:1437-1539): the disocclusion
    blur, then a-trous stages at strides 1, 3, 5, 7 (1, 3 without eaw5).
    color4 [H,W,4], nd_normal [H,W,3] decoded normals, nd_depth [H,W],
    moments4 [H,W,4] (m1, m2, 0, history length) -> [H,W,4]."""
    if options.eaw_fused != "0" or options.eaw_bf16:
        raise NotImplementedError(
            "eaw_fused/eaw_bf16 variants are not ported yet (ROADMAP B2)")
    geo = torch.cat([nd_normal, nd_depth[..., None]], -1).contiguous()
    moments = torch.cat([moments4[..., 0:2], moments4[..., 3:4]], -1)
    sig = (settings.eaw_normal_sigma, settings.eaw_depth_sigma, settings.eaw_luma_sigma)
    out = eaw_disocclusion(color4.contiguous(), geo, moments, *sig)
    for s in chain_strides(options):
        out = eaw_stage(out, geo, s, options.use_variance, *sig)
    return out
