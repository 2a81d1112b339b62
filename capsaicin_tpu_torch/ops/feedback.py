"""GBUFFER_FEEDBACK fetch (kernel K12, `csrc/feedback_fetch.cu`): the
bounce loop's lookup of the previous frame's combined colour and depth at
each bounce hit. The torch counterpart of the inline jnp fetch of
capsaicin_tpu/render/passes.py:308-377; it replaces no Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from . import camera as cam
from . import mathops as m
from . import resample

K12 = K.register(K.Kernel(
    "feedback_fetch", "feedback_fetch",
    [K.vp, K.i32, K.vp, K.vp, K.vp, K.vp, K.vp, K.vp, K.vp, K.vp, K.i32, K.i32, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/feedback_fetch.cu",
    replaces="none: the inline jnp fetch, capsaicin_tpu/render/passes.py:308",
))
BLOCK = 256  # threads a block, FEEDBACK_BLOCK in the source


def feedback_fetch_plain(p, prev_camera, combined_history, prev_depth, width, height):
    """The plain version of K12. GBUFFER_FEEDBACK: the previous frame's
    combined color at the bounce hit's reprojection (bilinear), and whether
    the hit was disoccluded there (rt_indirect.hlsl:110-135). The history
    and depth are rounded to float16 first: the reference keeps its
    combined history in an RGBA16F texture, so the values it re-reads are
    fp16-quantized too."""
    prev_uv = cam.calculate_image_plane_uv(prev_camera, p)
    offscreen = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(-1)
    prev_xy = resample.uv_to_xy(prev_uv, (width, height))
    fb = torch.cat([combined_history[..., :3], prev_depth[..., None]], -1)
    fb = fb.half().float().reshape(height * width, 4)

    xy0 = prev_xy - 0.5
    fl = torch.floor(xy0)
    # uv_to_xy bounds prev_xy by dim-1, so the corner index is at most
    # dim-2 and the +1 corner stays inside; only the -1 clamp needs care:
    # there the +1 weight is zero (edge-clamped bilinear, utils.h:19-36)
    bx = resample.pixel_index(fl[:, 0], -1, width - 1)
    by = resample.pixel_index(fl[:, 1], -1, height - 1)
    wx = torch.where(bx < 0, 0.0, xy0[:, 0] - fl[:, 0])[:, None]
    wy = torch.where(by < 0, 0.0, xy0[:, 1] - fl[:, 1])[:, None]
    bxc = bx.clamp_min(0)
    byc = by.clamp_min(0)
    x1 = (bxc + 1) % width
    y1 = (byc + 1) % height
    c00 = fb[byc * width + bxc]
    c10 = fb[byc * width + x1]
    c01 = fb[y1 * width + bxc]
    c11 = fb[y1 * width + x1]
    top = c00 * (1.0 - wx) + c10 * wx
    bot = c01 * (1.0 - wx) + c11 * wx
    hist = (top * (1.0 - wy) + bot * wy)[:, :3]

    # the point fetch (rt_indirect.hlsl:125) is one of the bilinear corners
    pl = torch.floor(prev_xy)
    di = resample.pixel_index(pl[:, 0], 0, width - 1) - bxc
    dj = resample.pixel_index(pl[:, 1], 0, height - 1) - byc
    prev_d = torch.where(
        dj == 0,
        torch.where(di == 0, c00[:, 3], c10[:, 3]),
        torch.where(di == 0, c01[:, 3], c11[:, 3]),
    )
    cur_d = torch.sqrt(m.dot(p - prev_camera.position, p - prev_camera.position))
    disocc = offscreen | ((prev_d - cur_d).abs() / cur_d.clamp_min(1e-20) > 0.05)
    return hist, disocc


def feedback_fetch(p, prev_camera, combined_history, prev_depth, width, height):
    """(p [N,3] bounce hits, the previous camera, its frame's combined
    colour [H,W,3] and depth [H,W], all float32) -> (hist [N,3] float32,
    disocc [N] bool), for every lane: the caller masks dead ones. K12 on
    CUDA tensors, bit-equal to its plain version there; the plain version
    on CPU tensors."""
    if K.on_cpu(p):
        return feedback_fetch_plain(p, prev_camera, combined_history, prev_depth, width, height)
    dev = p.device
    n = p.shape[0] if p.dim() else 0
    p = p.contiguous()
    color = combined_history.contiguous()
    depth = prev_depth.contiguous()
    K.check_cuda(p, "p", torch.float32, (n, 3), dev)
    K.check_cuda(color, "combined_history", torch.float32, (height, width, 3), dev)
    K.check_cuda(depth, "prev_depth", torch.float32, (height, width), dev)
    leaves = []
    for name, size in (("position", 3), ("right", 3), ("forward", 3), ("up", 3),
                       ("focal_length", 1), ("sensor_size", 2)):
        leaf = getattr(prev_camera, name).contiguous().reshape(-1)
        K.check_cuda(leaf, f"prev_camera.{name}", torch.float32, (size,), dev)
        leaves.append(leaf)
    hist = torch.empty((n, 3), dtype=torch.float32, device=dev)
    disocc = torch.empty(n, dtype=torch.bool, device=dev)
    K12.launch(dev, K.ptr(p), n, *[K.ptr(x) for x in leaves], K.ptr(color), K.ptr(depth),
               width, height, K.ptr(hist), K.ptr(disocc))
    return hist, disocc


def kernel_info(device_index: int = 0) -> dict:
    """K12's build on a card (cudaFuncGetAttributes and the occupancy API):
    registers and local (spilled) bytes a thread, shared bytes a block,
    resident blocks and warps an SM, SMs."""
    out = (ctypes.c_int * 5)()
    err = K.call("feedback_fetch_info", [ctypes.POINTER(ctypes.c_int), K.i32], out, device_index)
    if err != 0:
        raise RuntimeError(f"feedback_fetch_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "ctas_per_sm", "sms"), out))
    info["warps_per_sm"] = info["ctas_per_sm"] * BLOCK // 32
    return info
