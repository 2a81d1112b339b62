"""Edge-aware stencil filters: the spatial gather (kernel K5,
`csrc/spatial_gather.cu`) and the EAW denoise chain's disocclusion blur
(K3, `csrc/eaw_disocclusion.cu`), single a-trous stage (K4,
`csrc/eaw_stage.cu`) and fused pair of stages (K6, `csrc/eaw_pair.cu`).
The torch counterpart of capsaicin_tpu/ops/pallas_stencil.py.

Buffers are [H,W,C] with channels last: color4 (r, g, b, variance), geo
(decoded normal xyz, depth), moments (m1, m2, history length), the
gather's indirect (r, g, b). A tap is valid where it lies inside the image
and its depth is at least 1e-5. The plain versions zero-pad the image, so
a pad tap has depth 0 and the depth test alone excludes it; K3, K4 and K5
stage zeros for pixels outside the image and K6 reads zeros there, and
they rely on that too. All compute what the planar TPU layout computes.

K3, K4 and K5 take their launch plan from `disocc_plan`, `stage_plan` and
`gather_plan`: a block owns a tile of outputs (for K4, of one phase's
sub-lattice of the stride) and stages the tile and its reach into shared
memory. K6 takes its plan from `pair_plan`: a block owns a tile of
outputs and computes stage A over the region its stage-B taps reach into
shared memory.

Storage is float32, or bfloat16 under `eaw_bf16` (the TPU package's bf16
planar storage): arithmetic is float32 either way, and every kernel and
plain version returns its result in the storage type of its first input,
rounded to nearest-even. The rounding points are the TPU package's: the
inputs are rounded once when a chain packs them, every kernel's output is
rounded, the intermediate stage inside K6 is not, and the chain's result is
widened to float32 at the end.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .. import kernels as K
from . import mathops as m

EPS = 1e-8
FIREFLY_CLAMP = 10.0
SPATIAL_VARIANCE_THRESHOLD = 8.0
_EAW_KW = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # eaw_blur.hlsl:76
# K3's, K4's and K5's tiles: outputs a block (columns, rows), outputs a
# thread (one above the other), the reach in taps (K3_* in
# csrc/eaw_disocclusion.cu, K4_* in csrc/eaw_stage.cu, K5_* in
# csrc/spatial_gather.cu)
DISOCC_TILE, DISOCC_ROWS, DISOCC_REACH = (32, 8), 2, 3
STAGE_TILE, STAGE_ROWS, STAGE_REACH = (32, 16), 2, 2
GATHER_TILE, GATHER_ROWS, GATHER_REACH = (32, 8), 2, 3
TAP_SMEM_LIMIT = 48 * 1024  # K3-K5's dynamic shared memory a block, without an opt-in
# K6 (csrc/eaw_pair.cu): threads a block (K6_THREADS), outputs a thread
# (K6_ROWS, one stride apart in a column), the reach in taps (K6_R); its
# region of stage A in shared memory, 20 B a pixel (the clamped colour and
# variance, the luminance), under PAIR_SHARED_BUDGET (the opt-in above 48
# KB; the card's limit a block is 227 KB, and what is left of the SM's 256
# KB serves stage A's taps as L1)
PAIR_THREADS, PAIR_ROWS, PAIR_REACH = 1024, 2, 2
PAIR_BYTES_PER_PIXEL = 20
PAIR_SHARED_BUDGET = 176 * 1024

K3 = K.register(K.Kernel(
    "eaw_disocclusion", "eaw_disocclusion",
    [K.vp, K.vp, K.vp, K.vp, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.i32, K.i32],
    source="capsaicin_tpu_torch/csrc/eaw_disocclusion.cu",
    replaces="capsaicin_tpu/ops/pallas_stencil.py:265",
))
K4 = K.register(K.Kernel(
    "eaw_stage", "eaw_stage",
    [K.vp, K.vp, K.vp, K.i32, K.i32, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.i32, K.i32],
    source="capsaicin_tpu_torch/csrc/eaw_stage.cu",
    replaces="capsaicin_tpu/ops/pallas_stencil.py:218",
))
K5 = K.register(K.Kernel(
    "spatial_gather", "spatial_gather",
    [K.vp, K.vp, K.vp, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.i32, K.i32],
    source="capsaicin_tpu_torch/csrc/spatial_gather.cu",
    replaces="capsaicin_tpu/ops/pallas_stencil.py:345",
))
K6 = K.register(K.Kernel(
    "eaw_pair", "eaw_pair",
    [K.vp, K.vp, K.vp, K.i32, K.i32, K.i32, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.i32,
     K.i32, K.i32, K.i32],
    source="capsaicin_tpu_torch/csrc/eaw_pair.cu",
    replaces="capsaicin_tpu/ops/pallas_stencil.py:231",
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


def disocc_variance_scale(moments):
    """8 / hist_len times the largest |m2| + m1^2 among a pixel's 7x7 taps:
    the size of the terms whose difference is K3's variance (8 / hist_len *
    |m2 - m1^2| of the blurred moments). Weights off by a relative d move the
    variance by at most about 6 d times this, however much the difference
    cancels; K3's approximate tap is held to 1e-3 of it (chip_smoke.py,
    tests/test_torch_cuda.py). moments [H,W,3] -> [H,W] float32."""
    m = moments.float()
    terms = (m[..., 1].abs() + m[..., 0] * m[..., 0])[None, None]
    local = F.max_pool2d(terms, 7, stride=1, padding=3)[0, 0]
    return SPATIAL_VARIANCE_THRESHOLD / m[..., 2].clamp_min(1e-5) * local


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


def eaw_pair_plain(color4, geo, stride_a: int, stride_b: int, use_variance: bool,
                   s_normal, s_depth, s_luma):
    """The plain version of K6: two plain stages, the intermediate kept in
    float32 (not rounded to the storage type)."""
    mid = eaw_stage_plain(color4.float(), geo, stride_a, use_variance, s_normal, s_depth, s_luma)
    return eaw_stage_plain(mid, geo, stride_b, use_variance, s_normal, s_depth,
                           s_luma).to(color4.dtype)


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


@dataclasses.dataclass(frozen=True)
class TapPlan:
    """The launch of K4 or K5 on an [h, w] image: `grid` blocks of `block`
    threads, block b taking phase b % stride**2 (px, py) = (phase % stride,
    phase // stride) and tile t = b // stride**2 of that phase's lattice
    (the pixels px + stride * i, py + stride * j), whose lattice origin is
    ((t % tiles_x) * tile[0], (t // tiles_x) * tile[1]); it stages the
    `staged` lattice pixels from the origin minus `reach` and computes
    `rows` outputs a thread, one above the other (thread (tx, ty): lattice
    rows rows * ty + q). `shared_bytes` is its dynamic shared memory."""

    grid: int
    block: tuple
    tiles_x: int
    tiles_y: int
    stride: int
    tile: tuple
    rows: int
    reach: int
    staged: tuple
    shared_bytes: int


def _tap_plan(h, w, stride, tile, rows, reach, bytes_staged):
    lx, ly = -(-w // stride), -(-h // stride)  # phase (0, 0)'s lattice, the largest
    tiles_x, tiles_y = -(-lx // tile[0]), -(-ly // tile[1])
    staged = (tile[0] + 2 * reach, tile[1] + 2 * reach)
    return TapPlan(grid=stride * stride * tiles_x * tiles_y if h > 0 and w > 0 else 0,
                   block=(tile[0], tile[1] // rows), tiles_x=tiles_x, tiles_y=tiles_y,
                   stride=stride, tile=tile, rows=rows, reach=reach, staged=staged,
                   shared_bytes=staged[0] * staged[1] * bytes_staged)


@functools.lru_cache(maxsize=64)
def stage_plan(h: int, w: int, stride: int, dtype=torch.float32) -> TapPlan:
    """K4's launch at `stride`: per staged pixel the float32 colour and geo
    (16 B each) and the luminance (4 B), and under bf16 the raw pixels that
    cp.async lands (8 B each). The same bytes at every stride."""
    if stride < 1:
        raise ValueError(f"eaw_stage: stride {stride} out of range")
    return _tap_plan(h, w, stride, STAGE_TILE, STAGE_ROWS, STAGE_REACH,
                     36 + (16 if dtype == torch.bfloat16 else 0))


@functools.lru_cache(maxsize=64)
def disocc_plan(h: int, w: int, dtype=torch.float32) -> TapPlan:
    """K3's launch (stride 1): per staged pixel the float32 clamped colour
    with its luminance and geo (16 B each) and the moments m1, m2 (8 B), and
    under bf16 the raw geo (8 B)."""
    return _tap_plan(h, w, 1, DISOCC_TILE, DISOCC_ROWS, DISOCC_REACH,
                     40 + (8 if dtype == torch.bfloat16 else 0))


@functools.lru_cache(maxsize=64)
def gather_plan(h: int, w: int, dtype=torch.float32) -> TapPlan:
    """K5's launch (stride 1): per staged pixel the float32 indirect with
    its luminance and geo (16 B each), and under bf16 the raw geo (8 B)."""
    return _tap_plan(h, w, 1, GATHER_TILE, GATHER_ROWS, GATHER_REACH,
                     32 + (8 if dtype == torch.bfloat16 else 0))


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """The launch of K6 on an [h, w] image at strides (stride_a,
    stride_b): `grid` blocks of `threads`, block b owning the outputs
    [x0, x0 + tile[0]) x [y0, y0 + tile[1]) with x0 = (b % tiles_x) *
    tile[0], y0 = (b // tiles_x) * tile[1] (those in the image), and
    computing stage A over the region [x0 - 2 stride_b, x0 + tile[0] + 2
    stride_b) x (the same in y), `region` pixels, into `shared_bytes` of
    dynamic shared memory. Each stage runs `items` (stage A, stage B)
    items of PAIR_ROWS outputs (`pair_items`)."""

    grid: int
    threads: int
    tiles_x: int
    tiles_y: int
    tile: tuple
    region: tuple
    strides: tuple
    items: tuple
    shared_bytes: int


def pair_items(stride: int, nx: int, ny: int) -> int:
    """The items of one of K6's passes over an nx x ny rectangle at
    `stride` (k6_pass in csrc/eaw_pair.cu): for each of the stride**2
    phases, ceil(nx / stride) lattice columns times the pairs of its
    ceil(ny / stride) lattice rows."""
    lx, ly = -(-nx // stride), -(-ny // stride)
    return stride * stride * lx * (-(-ly // 2))


@functools.lru_cache(maxsize=64)
def pair_plan(h: int, w: int, stride_a: int, stride_b: int, sms: int) -> PairPlan:
    """K6's launch on a card of `sms` SMs: the output tile (multiples of 4
    from 4 to 128 on each axis) whose region fits PAIR_SHARED_BUDGET bytes
    and which takes the fewest rounds of items a thread, counting a wave
    of one block on each SM; ties to the larger tile. The region is
    float32 in either storage type. Raises ValueError where no tile fits
    (stride_b above 22) or a stride is below 1."""
    if min(stride_a, stride_b) < 1:
        raise ValueError(f"eaw_pair: strides ({stride_a}, {stride_b}) out of range")
    best = None
    for tx in range(4, 129, 4):
        for ty in range(4, 129, 4):
            nx, ny = tx + 4 * stride_b, ty + 4 * stride_b
            if nx * ny * PAIR_BYTES_PER_PIXEL > PAIR_SHARED_BUDGET:
                continue
            items = (pair_items(stride_a, nx, ny), pair_items(stride_b, tx, ty))
            blocks = -(-w // tx) * -(-h // ty)
            cost = (-(-blocks // sms) * sum(-(-n // PAIR_THREADS) for n in items), -tx * ty)
            if best is None or cost < best[0]:
                best = (cost, tx, ty, nx, ny, items)
    if best is None:
        raise ValueError(f"eaw_pair: stride_b {stride_b}: no tile's region fits "
                         f"{PAIR_SHARED_BUDGET} B of shared memory")
    _, tx, ty, nx, ny, items = best
    tiles_x, tiles_y = -(-w // tx), -(-h // ty)
    return PairPlan(grid=tiles_x * tiles_y if h > 0 and w > 0 else 0, threads=PAIR_THREADS,
                    tiles_x=tiles_x, tiles_y=tiles_y, tile=(tx, ty), region=(nx, ny),
                    strides=(stride_a, stride_b), items=items,
                    shared_bytes=nx * ny * PAIR_BYTES_PER_PIXEL)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of card `device_index` (K6's plan counts its waves)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _checked(plan: TapPlan, name: str) -> TapPlan:
    if plan.shared_bytes > TAP_SMEM_LIMIT:
        raise ValueError(f"{name}: {plan.shared_bytes} B of shared memory a block, above "
                         f"{TAP_SMEM_LIMIT}")
    return plan


def kernel_info(name: str, dtype=torch.float32, device_index: int = 0) -> dict:
    """K3's ("eaw_disocclusion"), K4's ("eaw_stage", the instance with the
    variance, as the chain runs it), K5's ("spatial_gather") or K6's
    ("eaw_pair", with the variance, at its 1080p plan for the pair (5, 7))
    build on a card, from cudaFuncGetAttributes and the occupancy API at its
    plan's shared memory: registers a thread, local (spilled) bytes a
    thread, static and dynamic shared bytes a block, resident blocks and
    warps an SM, SMs."""
    out = (ctypes.c_int * 6)()
    bf16 = int(dtype == torch.bfloat16)
    threads = None
    if name in ("eaw_stage", "eaw_pair"):
        if name == "eaw_stage":
            plan = stage_plan(1, 1, 1, dtype)
        else:
            plan = pair_plan(1080, 1920, 5, 7, sm_count(device_index))
            threads = plan.threads
        err = K.call(f"{name}_info", [K.i32, K.i32, K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                     bf16, 1, plan.shared_bytes, out, device_index)
    else:
        plan = (disocc_plan if name == "eaw_disocclusion" else gather_plan)(1, 1, dtype)
        err = K.call(f"{name}_info", [K.i32, K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                     bf16, plan.shared_bytes, out, device_index)
    if err != 0:
        raise RuntimeError(f"{name}_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "dynamic_shared_bytes",
                     "ctas_per_sm", "sms"), out))
    threads = threads or plan.block[0] * plan.block[1]
    info["warps_per_sm"] = info["ctas_per_sm"] * threads // 32
    return info


def _storage(x) -> torch.dtype:
    if x.dtype not in K.STORAGE_SUFFIX:
        raise ValueError(f"stencil storage must be float32 or bfloat16, got {x.dtype}")
    return x.dtype


def _check_image(x, name, channels, h, w, dev, dtype):
    # four-channel pixels are read in one load of 4 values
    align = 4 * x.element_size() if channels == 4 else 1
    K.check_cuda(x, name, dtype, (h, w, channels), dev, align=align)


def eaw_disocclusion(color4, geo, moments, s_normal, s_depth, s_luma):
    """K3 on CUDA tensors, its plain version on CPU tensors.
    color4 [H,W,4], geo [H,W,4], moments [H,W,3], all of one storage type
    -> [H,W,4] in that type. Any H and W."""
    if K.on_cpu(color4):
        return eaw_disocclusion_plain(color4, geo, moments, s_normal, s_depth, s_luma)
    dev, dt = color4.device, _storage(color4)
    h, w = color4.shape[:2]
    _check_image(color4, "color4", 4, h, w, dev, dt)
    _check_image(geo, "geo", 4, h, w, dev, dt)
    _check_image(moments, "moments", 3, h, w, dev, dt)
    plan = _checked(disocc_plan(h, w, dt), "eaw_disocclusion")
    out = torch.empty_like(color4)
    K3.launch(dev, K.ptr(color4), K.ptr(geo), K.ptr(moments), K.ptr(out), h, w,
              float(s_normal), float(s_depth), float(s_luma), plan.grid, plan.tiles_x,
              plan.shared_bytes, storage=dt)
    return out


def eaw_stage(color4, geo, stride: int, use_variance: bool, s_normal, s_depth, s_luma):
    """K4 on CUDA tensors, its plain version on CPU tensors.
    color4 [H,W,4], geo [H,W,4], of one storage type -> [H,W,4] in that type."""
    if K.on_cpu(color4):
        return eaw_stage_plain(color4, geo, stride, use_variance, s_normal, s_depth, s_luma)
    dev, dt = color4.device, _storage(color4)
    h, w = color4.shape[:2]
    _check_image(color4, "color4", 4, h, w, dev, dt)
    _check_image(geo, "geo", 4, h, w, dev, dt)
    plan = _checked(stage_plan(h, w, int(stride), dt), "eaw_stage")
    out = torch.empty_like(color4)
    K4.launch(dev, K.ptr(color4), K.ptr(geo), K.ptr(out), h, w, int(stride),
              int(bool(use_variance)), float(s_normal), float(s_depth), float(s_luma),
              plan.grid, plan.tiles_x, plan.shared_bytes, storage=dt)
    return out


def eaw_pair(color4, geo, stride_a: int, stride_b: int, use_variance: bool,
             s_normal, s_depth, s_luma):
    """K6 on CUDA tensors, its plain version on CPU tensors: the stage at
    stride_a, then the stage at stride_b on its output.
    color4 [H,W,4], geo [H,W,4], of one storage type -> [H,W,4] in that type.
    Any H and W; raises ValueError where `pair_plan` refuses the strides."""
    if K.on_cpu(color4):
        return eaw_pair_plain(color4, geo, stride_a, stride_b, use_variance,
                              s_normal, s_depth, s_luma)
    dev, dt = color4.device, _storage(color4)
    h, w = color4.shape[:2]
    _check_image(color4, "color4", 4, h, w, dev, dt)
    _check_image(geo, "geo", 4, h, w, dev, dt)
    plan = pair_plan(h, w, int(stride_a), int(stride_b), sm_count(dev.index))
    out = torch.empty_like(color4)
    K6.launch(dev, K.ptr(color4), K.ptr(geo), K.ptr(out), h, w, int(stride_a), int(stride_b),
              int(bool(use_variance)), float(s_normal), float(s_depth), float(s_luma),
              plan.grid, plan.tile[0], plan.tile[1], plan.tiles_x, plan.shared_bytes,
              storage=dt)
    return out


def spatial_gather(indirect, geo, s_normal, s_depth, s_luma):
    """K5 on CUDA tensors, its plain version on CPU tensors.
    indirect [H,W,3], geo [H,W,4], of one storage type -> [H,W,3] in that
    type. Any H and W."""
    if K.on_cpu(indirect):
        return spatial_gather_plain(indirect, geo, s_normal, s_depth, s_luma)
    dev, dt = indirect.device, _storage(indirect)
    h, w = indirect.shape[:2]
    _check_image(indirect, "indirect", 3, h, w, dev, dt)
    _check_image(geo, "geo", 4, h, w, dev, dt)
    plan = _checked(gather_plan(h, w, dt), "spatial_gather")
    out = torch.empty_like(indirect)
    K5.launch(dev, K.ptr(indirect), K.ptr(geo), K.ptr(out), h, w,
              float(s_normal), float(s_depth), float(s_luma), plan.grid, plan.tiles_x,
              plan.shared_bytes, storage=dt)
    return out


def storage_dtype(options) -> torch.dtype:
    """The stencils' storage type: bfloat16 under eaw_bf16, else float32."""
    return torch.bfloat16 if options.eaw_bf16 else torch.float32


def pack_geo(nd_normal, nd_depth, dtype=torch.float32):
    """Decoded normals [H,W,3] and depth [H,W] -> geo [H,W,4] in `dtype`."""
    return torch.cat([nd_normal, nd_depth[..., None]], -1).to(dtype).contiguous()


def chain_strides(options):
    return (1, 3, 5, 7) if options.eaw5 else (1, 3)


def chain_reach(options) -> int:
    """Rows of the chain's input that one output depends on, above and
    below: K3's reach and each stage's 2 * stride (a K6 pair reaches as far
    as its two stages)."""
    return DISOCC_REACH + sum(2 * s for s in chain_strides(options))


def chain_groups(options):
    """The chain's a-trous stages in order, as groups of one stride (a K4
    launch) or two (a K6 launch), as pallas_stencil.denoise_chain groups
    them: eaw_fused "1" fuses (1, 3) and (5, 7); "13" fuses (1, 3) and runs
    5 and 7 alone; without eaw5 only (1, 3) is left to fuse."""
    strides = chain_strides(options)
    if options.eaw_fused == "0":
        return [(s,) for s in strides]
    groups = [(1, 3)]
    if options.eaw5:
        groups += [(5, 7)] if options.eaw_fused == "1" else [(5,), (7,)]
    return groups


def denoise_chain(color4, nd_normal, nd_depth, moments4, settings, options):
    """The EAW chain (raytracing_system.cpp:1437-1539): the disocclusion
    blur, then a-trous stages at strides 1, 3, 5, 7 (1, 3 without eaw5),
    grouped as `chain_groups` says, in the storage type of `storage_dtype`.
    color4 [H,W,4], nd_normal [H,W,3] decoded normals, nd_depth [H,W],
    moments4 [H,W,4] (m1, m2, 0, history length) -> [H,W,4] float32."""
    dt = storage_dtype(options)
    geo = pack_geo(nd_normal, nd_depth, dt)
    moments = torch.cat([moments4[..., 0:2], moments4[..., 3:4]], -1).to(dt).contiguous()
    sig = (settings.eaw_normal_sigma, settings.eaw_depth_sigma, settings.eaw_luma_sigma)
    out = eaw_disocclusion(color4.to(dt).contiguous(), geo, moments, *sig)
    for group in chain_groups(options):
        if len(group) == 2:
            out = eaw_pair(out, geo, *group, options.use_variance, *sig)
        else:
            out = eaw_stage(out, geo, group[0], options.use_variance, *sig)
    return out.float()
