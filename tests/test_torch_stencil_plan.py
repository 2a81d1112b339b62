"""K3's, K4's and K5's tap and launch plans, on the CPU.

(a) A float32 model of the tap as the kernels compute it (csrc/eaw_tap.cuh:
one log2 and one exp2 of a summed exponent, the reciprocals hoisted per
pixel, hw as its log2, the variance summed with w_full^2, sums as fused
multiply-adds in dy-then-dx order, staged pixels outside the image zero and
an invalid tap's luminance +inf) against the plain versions
`eaw_stage_plain`, `spatial_gather_plain` and `eaw_disocclusion_plain`,
rtol 1e-3 and atol 1e-4 as the kernels are held on the card, on random
32x48 inputs and on the edge cases of the reference: ndot <= 0, s_normal =
0, equal luminances, an all-background image, depth 0 on the border; and
for K3 (its moments a third staged array, the variance 8 / hist_len *
|m2 - m1^2|) every history at least 8 (every pixel passes through,
exactly) and zero normals (tw = 0: the colour passes, the variance is 0).

(b) `disocc_plan`, `stage_plan` and `gather_plan`: every output pixel is computed by
exactly one thread, every tap of a pixel lies in its block's staged tile,
and the shared memory stays under the limit, at [1080,1920], [540,960],
[67,129], [5,3], [1,1] and the mesh session's halo-extended [206,1920]
and [78,64], and strides 1, 3, 5, 7; the tiles match the constants of the
CUDA sources.

(c) K6 (csrc/eaw_pair.cu): a model of the pair as the kernel computes it
(stage A with K4's tap over the region, its output kept in float32 and
clamped, then stage B with the same tap on it; the tiling changes no
value, since each output reads the region's stage-A values at its taps
only) against `eaw_pair_plain` at rtol 1e-3 / atol 1e-4 in float32 and
within the bf16 bars (max 2e-2, mean 1e-3) in bf16, at (1, 3), (5, 7) and
stride_b 9; `pair_plan`: each region pixel is computed once by stage A,
each output once by stage B, every stage-B tap lies in the region, at
the same shapes, for cards of 132, 114
and 1 SMs; the plan refuses what the kernel cannot take; its constants
match the CUDA source."""

import math
import os
import re

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch.ops import mathops as m
from capsaicin_tpu_torch.ops import stencil
from capsaicin_tpu_torch.render.settings import default_settings
from torch_threads import share_cores

share_cores()

H, W = 32, 48
TOL = dict(rtol=1e-3, atol=1e-4)
LOG2E = 1.4426950408889634
INV_L_MIN = 1e-30
CSRC = os.path.join(os.path.dirname(stencil.__file__), os.pardir, "csrc")


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (a.double() * b.double() + torch.as_tensor(c).double()).float()


def _pad(x, reach, value=0.0):
    return torch.nn.functional.pad(x.movedim(-1, 0), (reach, reach, reach, reach),
                                   value=value).movedim(0, -1)


def _tap_model(col, geo, lum, vlog, taps, reach_px, s_normal, inv_d, inv_l, hw_log2):
    """The kernels' tap sum over `taps` [(dx, dy, offset_x, offset_y)] of
    staged values `col` [H,W,C], geo, luminance `lum` (None: no luma term)
    and additive validity `vlog` (None: none); inv_d and inv_l per pixel.
    Returns (acc of w * col[..., :-1], acc of w^2 * col[..., -1], tw)."""
    h, w = geo.shape[:2]
    cp, gp = _pad(col, reach_px), _pad(geo, reach_px)
    lp = None if lum is None else _pad(lum[..., None], reach_px, math.inf)[..., 0]
    vp = None if vlog is None else _pad(vlog[..., None], reach_px, -math.inf)[..., 0]
    nfloor = 1.0 if s_normal == 0 else 0.0
    acc = torch.zeros(h, w, col.shape[-1] - 1)
    acc_v = torch.zeros(h, w)
    tw = torch.zeros(h, w)
    n, d = geo[..., :3], geo[..., 3]
    cl = None if lum is None else lum
    for dx, dy, ox, oy in taps:
        sl = (slice(reach_px + oy, reach_px + oy + h), slice(reach_px + ox, reach_px + ox + w))
        tc, tg = cp[sl], gp[sl]
        ndot = _fma(n[..., 2], tg[..., 2], _fma(n[..., 1], tg[..., 1], n[..., 0] * tg[..., 0]))
        e = _fma(torch.full_like(ndot, s_normal), torch.log2(ndot.clamp_min(nfloor)),
                 hw_log2(dx, dy))
        if dx or dy:
            rinv = np.float32(1.0 / math.sqrt(dx * dx + dy * dy))
            e = _fma(-(d - tg[..., 3]).abs(), inv_d * float(rinv), e)
        if lp is not None:
            e = _fma(-(cl - lp[sl]).abs(), inv_l, e)
        if vp is not None:
            e = e + vp[sl]
        wt = torch.exp2(e)
        acc = _fma(wt[..., None], tc[..., :-1], acc)
        tw = tw + wt
        acc_v = _fma(wt * wt, tc[..., -1], acc_v)
    return acc, acc_v, tw


def stage_model(color4, geo, stride, use_variance, s_normal, s_depth, s_luma):
    """K4 as csrc/eaw_stage.cu computes it, in float32 torch."""
    rgb = color4[..., :3].clamp_max(stencil.FIREFLY_CLAMP)
    cv = color4[..., 3]
    valid = geo[..., 3] >= 1e-5
    lum = torch.where(valid, m.luminance(rgb), math.inf)
    s_d_base = geo[..., 3] * float(stride) * s_depth
    inv_d = torch.where(s_d_base == 0, 0.0, LOG2E / torch.where(s_d_base == 0, 1.0, s_d_base))
    s_l_eff = s_luma * torch.sqrt((cv + stencil.EPS).clamp_min(0.0))
    inv_l = (LOG2E / s_l_eff).clamp_min(INV_L_MIN)
    kw = [0.0, math.log2(2.0 / 3.0), math.log2(1.0 / 6.0)]
    taps = [(dx, dy, dx * stride, dy * stride) for dy in range(-2, 3) for dx in range(-2, 3)]
    col = torch.cat([rgb, cv[..., None]], -1)
    acc, acc_v, tw = _tap_model(
        col, geo, lum if use_variance else None,
        None if use_variance else torch.where(valid, 0.0, -math.inf), taps, 2 * stride,
        s_normal, inv_d, inv_l,
        (lambda dx, dy: kw[abs(dx)] + kw[abs(dy)]) if use_variance else (lambda dx, dy: 0.0))
    live = valid & ~(tw < stencil.EPS)
    inv = 1.0 / tw.clamp_min(stencil.EPS)
    out_v = acc_v * inv * inv if use_variance else torch.zeros_like(cv)
    return torch.where(live[..., None], torch.cat([acc * inv[..., None], out_v[..., None]], -1),
                       torch.cat([rgb, cv[..., None]], -1))


def gather_model(indirect, geo, s_normal, s_depth, s_luma):
    """K5 as csrc/spatial_gather.cu computes it, in float32 torch."""
    valid = geo[..., 3] >= 1e-5
    lum = torch.where(valid, m.luminance(indirect), math.inf)
    s_d_base = geo[..., 3] * s_depth
    inv_d = torch.where(s_d_base == 0, 0.0, LOG2E / torch.where(s_d_base == 0, 1.0, s_d_base))
    inv_l = torch.tensor(LOG2E / s_luma, dtype=torch.float32).clamp_min(INV_L_MIN)
    taps = [(dx, dy, dx, dy) for dy in range(-3, 4) for dx in range(-3, 4)]
    col = torch.cat([indirect, torch.zeros_like(lum)[..., None]], -1)
    acc, _, tw = _tap_model(col, geo, lum, None, taps, 3, s_normal, inv_d, inv_l,
                            lambda dx, dy: 0.0)
    live = valid & ~(tw < stencil.EPS)
    inv = 1.0 / tw.clamp_min(stencil.EPS)
    return torch.where(live[..., None], acc * inv[..., None], indirect)


def disocc_model(color4, geo, moments, s_normal, s_depth, s_luma):
    """K3 as csrc/eaw_disocclusion.cu computes it, in float32 torch."""
    rgb = color4[..., :3].clamp_max(stencil.FIREFLY_CLAMP)
    cv, hist = color4[..., 3], moments[..., 2]
    valid = geo[..., 3] >= 1e-5
    lum = torch.where(valid, m.luminance(rgb), math.inf)
    s_d_base = geo[..., 3] * s_depth
    inv_d = torch.where(s_d_base == 0, 0.0, LOG2E / torch.where(s_d_base == 0, 1.0, s_d_base))
    inv_l = torch.tensor(LOG2E / s_luma, dtype=torch.float32).clamp_min(INV_L_MIN)
    taps = [(dx, dy, dx, dy) for dy in range(-3, 4) for dx in range(-3, 4)]
    col = torch.cat([rgb, moments[..., :2], torch.zeros_like(cv)[..., None]], -1)
    acc, _, tw = _tap_model(col, geo, lum, None, taps, 3, s_normal, inv_d, inv_l,
                            lambda dx, dy: 0.0)
    live = ~(geo[..., 3] < 1e-5) & ~(hist >= stencil.SPATIAL_VARIANCE_THRESHOLD)
    low = tw < stencil.EPS
    inv = 1.0 / tw.clamp_min(stencil.EPS)
    f_m = torch.where(low[..., None], 0.0, acc[..., 3:] * inv[..., None])
    boost = stencil.SPATIAL_VARIANCE_THRESHOLD / hist.clamp_min(1e-5)
    f_v = boost * (f_m[..., 1] - f_m[..., 0] * f_m[..., 0]).abs()
    out_c = torch.where((live & ~low)[..., None], acc[..., :3] * inv[..., None], rgb)
    return torch.cat([out_c, torch.where(live, f_v, cv)[..., None]], -1)


def _inputs(case, seed=7):
    rng = np.random.default_rng(seed)
    color4 = rng.random((H, W, 4), dtype=np.float32) * 2.0
    color4[..., 3] *= 0.1
    color4[3, 5, :3] = 40.0  # a firefly above the clamp
    n = rng.normal(size=(H, W, 3)).astype(np.float32)  # many taps with ndot <= 0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = (rng.random((H, W), dtype=np.float32) * 20.0 + 1.0).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    if case == "equal_luma":
        color4[:, :, :3] = 0.5  # every luminance equal
        n[:] = n[0, 0]  # and every ndot 1, so every weight is near 1
    if case == "background":
        depth[:] = 0.0
    if case == "border0":
        depth[[0, -1], :] = 0.0
        depth[:, [0, -1]] = 0.0
    geo = np.concatenate([n, depth[..., None]], -1)
    return torch.from_numpy(color4), torch.from_numpy(geo)


def _sigmas(kind, case):
    s = default_settings()
    sig = ((s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma) if kind == "eaw"
           else (s.gather_normal_sigma, s.gather_depth_sigma, s.gather_luma_sigma))
    return (0.0,) + sig[1:] if case == "s_normal0" else sig


STAGE_CASES = [("random", 1, True), ("random", 3, True), ("random", 5, True),
               ("random", 7, True), ("random", 3, False), ("s_normal0", 1, True),
               ("s_normal0", 5, False), ("equal_luma", 1, True), ("background", 3, True),
               ("border0", 1, True), ("border0", 7, False)]


@pytest.mark.parametrize("case, stride, use_variance", STAGE_CASES,
                         ids=[f"{c}-s{s}-{'var' if v else 'novar'}" for c, s, v in STAGE_CASES])
def test_stage_tap_model_matches_plain(case, stride, use_variance):
    color4, geo = _inputs(case)
    sig = _sigmas("eaw", case)
    got = stage_model(color4, geo, stride, use_variance, *sig)
    want = stencil.eaw_stage_plain(color4, geo, stride, use_variance, *sig)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL)
    if case == "background":  # every pixel passes through, clamped
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["random", "s_normal0", "equal_luma", "background", "border0"])
def test_gather_tap_model_matches_plain(case):
    color4, geo = _inputs(case)
    indirect = color4[..., :3].contiguous()
    sig = _sigmas("gather", case)
    got = gather_model(indirect, geo, *sig)
    want = stencil.spatial_gather_plain(indirect, geo, *sig)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL)


def _moments(case, seed=11):
    """moments [H,W,3] (m1, m2 >= m1^2, history length): every history
    shorter than 8 (every valid pixel blurred), or with "hist8" at least 8
    (every pixel passes through)."""
    rng = np.random.default_rng(seed)
    m1 = rng.random((H, W), dtype=np.float32) * 2.0
    m2 = m1 * m1 + rng.random((H, W), dtype=np.float32) * 0.5
    hist = rng.integers(0, 8, (H, W)).astype(np.float32)
    if case == "hist8":
        hist += 8.0
    return torch.from_numpy(np.stack([m1, m2, hist], -1))


DISOCC_CASES = ["random", "s_normal0", "equal_luma", "background", "border0", "hist8", "tw0"]


@pytest.mark.parametrize("case", DISOCC_CASES)
def test_disocc_tap_model_matches_plain(case):
    color4, geo = _inputs(case)
    moments = _moments(case)
    if case == "tw0":  # a zero normal meets every tap at ndot 0: tw = 0
        geo[::3, ::2, :3] = 0.0
    sig = _sigmas("eaw", case)
    got = disocc_model(color4, geo, moments, *sig)
    want = stencil.eaw_disocclusion_plain(color4, geo, moments, *sig)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **TOL)
    if case in ("hist8", "background"):  # every pixel passes through, clamped
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if case == "tw0":
        zero = (geo[..., 3] >= 1e-5) & (geo[..., :3] == 0).all(-1)
        assert bool(zero.any())
        torch.testing.assert_close(got[zero], want[zero], rtol=0, atol=0)


# ---- (b) the launch plans -------------------------------------------------


def _plan_outputs(plan, h, w):
    """Every (block, thread, row) of `plan`, as the kernels index them:
    (pixel x, y, the block's staged lattice origin x, y, the phase px, py)
    of the threads' outputs inside the image."""
    s = plan.stride
    b = np.arange(plan.grid)
    phase, tile = b % (s * s), b // (s * s)
    px, py = phase % s, phase // s
    i0 = (tile % plan.tiles_x) * plan.tile[0]
    j0 = (tile // plan.tiles_x) * plan.tile[1]
    tx = np.arange(plan.block[0])
    ty = np.arange(plan.block[1])[:, None] * plan.rows + np.arange(plan.rows)[None, :]
    i = (i0[:, None, None] + tx[None, :, None]).repeat(ty.size, 2)  # [blocks, TX, TY]
    j = (j0[:, None, None] + ty.reshape(1, 1, -1)).repeat(plan.block[0], 1)
    x = px[:, None, None] + s * i
    y = py[:, None, None] + s * j
    inside = (x < w) & (y < h)
    sx = np.broadcast_to(px[:, None, None] + s * (i0[:, None, None] - plan.reach), x.shape)
    sy = np.broadcast_to(py[:, None, None] + s * (j0[:, None, None] - plan.reach), x.shape)
    return x[inside], y[inside], sx[inside], sy[inside]


# the last two: a mesh session's halo-extended blocks (136 + 2 * 35 rows of
# the 1080p frame on 8 devices; 8 + 2 * 35 rows of a 64x64 one)
PLAN_SHAPES = [(1080, 1920), (540, 960), (67, 129), (5, 3), (1, 1), (206, 1920), (78, 64)]


def _check_plan(plan, h, w):
    x, y, sx, sy = _plan_outputs(plan, h, w)
    count = np.bincount(y.astype(np.int64) * w + x, minlength=h * w)
    assert count.shape == (h * w,) and bool((count == 1).all()), "an output pixel not once"
    s, r = plan.stride, plan.reach
    for ox, oy in ((-r, -r), (r, r)):  # the footprint's corners; it is a rectangle
        ax, ay = (x + ox * s - sx), (y + oy * s - sy)
        assert bool(((ax % s == 0) & (ay % s == 0)).all())  # on the block's lattice
        assert bool(((ax // s >= 0) & (ax // s < plan.staged[0])).all())
        assert bool(((ay // s >= 0) & (ay // s < plan.staged[1])).all())
    assert plan.shared_bytes <= stencil.TAP_SMEM_LIMIT
    assert plan.block[0] == 32 and plan.block[0] * plan.block[1] <= 1024


@pytest.mark.parametrize("hw", PLAN_SHAPES, ids=[f"{h}x{w}" for h, w in PLAN_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stage_plan_covers_each_pixel_once(hw, dtype):
    h, w = hw
    for stride in (1, 3, 5, 7):
        plan = stencil.stage_plan(h, w, stride, dtype)
        assert plan.shared_bytes == stencil.stage_plan(8, 8, 1, dtype).shared_bytes
        _check_plan(plan, h, w)


@pytest.mark.parametrize("hw", PLAN_SHAPES, ids=[f"{h}x{w}" for h, w in PLAN_SHAPES])
def test_gather_plan_covers_each_pixel_once(hw):
    for dtype in (torch.float32, torch.bfloat16):
        _check_plan(stencil.gather_plan(*hw, dtype), *hw)


@pytest.mark.parametrize("hw", PLAN_SHAPES, ids=[f"{h}x{w}" for h, w in PLAN_SHAPES])
def test_disocc_plan_covers_each_pixel_once(hw):
    for dtype in (torch.float32, torch.bfloat16):
        _check_plan(stencil.disocc_plan(*hw, dtype), *hw)


def test_plans_refuse_what_the_kernels_cannot_take():
    assert stencil.stage_plan(0, 16, 3).grid == 0 and stencil.gather_plan(16, 0).grid == 0
    assert stencil.disocc_plan(0, 0).grid == 0
    with pytest.raises(ValueError):
        stencil.stage_plan(8, 8, 0)
    big = stencil.TapPlan(grid=1, block=(32, 8), tiles_x=1, tiles_y=1, stride=1, tile=(32, 16),
                          rows=2, reach=2, staged=(36, 20),
                          shared_bytes=stencil.TAP_SMEM_LIMIT + 1)
    with pytest.raises(ValueError, match="shared memory"):
        stencil._checked(big, "eaw_stage")


@pytest.mark.parametrize("src, prefix, tile, rows, reach", [
    ("eaw_disocclusion.cu", "K3", stencil.DISOCC_TILE, stencil.DISOCC_ROWS, stencil.DISOCC_REACH),
    ("eaw_stage.cu", "K4", stencil.STAGE_TILE, stencil.STAGE_ROWS, stencil.STAGE_REACH),
    ("spatial_gather.cu", "K5", stencil.GATHER_TILE, stencil.GATHER_ROWS, stencil.GATHER_REACH),
])
def test_plan_tiles_match_the_cuda_sources(src, prefix, tile, rows, reach):
    with open(os.path.join(CSRC, src)) as f:
        defs = dict(re.findall(rf"#define {prefix}_(\w+) (\d+)", f.read()))
    assert (int(defs["TX"]), int(defs["TY"])) == tile
    assert (int(defs["ROWS"]), int(defs["R"])) == (rows, reach)


# ---- (c) K6: the fused pair ------------------------------------------------


def pair_model(color4, geo, stride_a, stride_b, use_variance, s_normal, s_depth, s_luma):
    """K6 as csrc/eaw_pair.cu computes it: K4's tap in both stages, the
    intermediate in float32 (clamped where the kernel stores it), the
    result in the storage type of color4."""
    c, g = color4.float(), geo.float()
    mid = stage_model(c, g, stride_a, use_variance, s_normal, s_depth, s_luma)
    mid = torch.cat([mid[..., :3].clamp_max(stencil.FIREFLY_CLAMP), mid[..., 3:]], -1)
    out = stage_model(mid, g, stride_b, use_variance, s_normal, s_depth, s_luma)
    return out.to(color4.dtype)


PAIR_CASES = [("random", (1, 3), True, "f32"), ("random", (5, 7), True, "f32"),
              ("random", (5, 7), False, "f32"), ("random", (2, 9), True, "f32"),
              ("s_normal0", (1, 3), True, "f32"), ("border0", (5, 7), True, "f32"),
              ("background", (1, 3), True, "f32"), ("random", (1, 3), True, "bf16"),
              ("random", (5, 7), True, "bf16"), ("equal_luma", (5, 7), False, "bf16")]


@pytest.mark.parametrize("case, strides, use_variance, storage", PAIR_CASES,
                         ids=[f"{c}-{a}{b}-{'var' if v else 'novar'}-{t}"
                              for c, (a, b), v, t in PAIR_CASES])
def test_pair_model_matches_plain(case, strides, use_variance, storage):
    color4, geo = _inputs(case)
    if storage == "bf16":
        color4, geo = color4.bfloat16(), geo.bfloat16()
    sig = _sigmas("eaw", case)
    got = pair_model(color4, geo, *strides, use_variance, *sig)
    want = stencil.eaw_pair_plain(color4, geo, *strides, use_variance, *sig)
    assert got.dtype == want.dtype == color4.dtype
    assert bool(torch.isfinite(got.float()).all())
    if storage == "bf16":
        err = (got.float() - want.float()).abs()
        assert float(err.max()) <= 2e-2 and float(err.mean()) <= 1e-3
    else:
        torch.testing.assert_close(got, want, **TOL)
    if case == "background":  # every pixel passes through, clamped
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _pass_outputs(stride, nx, ny):
    """The first output (x, y) of every item of one of K6's passes over an
    nx x ny rectangle (k6_pass / k6_item), items outside it dropped."""
    lx = -(-nx // stride)
    per_phase = stencil.pair_items(stride, nx, ny) // (stride * stride)
    k = np.arange(stencil.pair_items(stride, nx, ny))
    ph, r = k // per_phase, k % per_phase
    x = ph % stride + stride * (r % lx)
    y = ph // stride + 2 * stride * (r // lx)
    keep = (x < nx) & (y < ny)
    return x[keep], y[keep]


def _check_pair_plan(plan, h, w):
    sa, sb = plan.strides
    (tx, ty), (nx, ny) = plan.tile, plan.region
    assert (nx, ny) == (tx + 4 * sb, ty + 4 * sb)
    assert plan.items == (stencil.pair_items(sa, nx, ny), stencil.pair_items(sb, tx, ty))
    assert plan.shared_bytes == nx * ny * stencil.PAIR_BYTES_PER_PIXEL
    assert plan.shared_bytes <= stencil.PAIR_SHARED_BUDGET
    assert plan.threads == stencil.PAIR_THREADS and plan.threads <= 1024
    # stage A: each region pixel once
    x, y = _pass_outputs(sa, nx, ny)
    xs = np.concatenate([x, x]), np.concatenate([y, y + sa])
    keep = xs[1] < ny
    count = np.bincount(xs[1][keep] * nx + xs[0][keep], minlength=nx * ny)
    assert count.shape == (nx * ny,) and bool((count == 1).all()), "a region pixel not once"
    # stage B: each output once over the blocks, its taps in the region
    x, y = _pass_outputs(sb, tx, ty)
    x, y = np.concatenate([x, x]), np.concatenate([y, y + sb])
    keep = y < ty
    x, y = x[keep], y[keep]
    for dy in (-2, 2):  # the taps' rows; their columns x + 2 sb + sb dx lie in [0, nx)
        assert bool(((y + 2 * sb + sb * dy >= 0) & (y + 2 * sb + sb * dy < ny)).all())
    assert plan.tiles_x == -(-w // tx) and plan.tiles_y == -(-h // ty)
    b = np.arange(plan.grid)
    gx = ((b % plan.tiles_x) * tx)[:, None] + x[None]
    gy = ((b // plan.tiles_x) * ty)[:, None] + y[None]
    inside = (gx < w) & (gy < h)
    count = np.bincount(gy[inside] * w + gx[inside], minlength=h * w)
    assert count.shape == (h * w,) and bool((count == 1).all()), "an output pixel not once"


@pytest.mark.parametrize("hw", PLAN_SHAPES, ids=[f"{h}x{w}" for h, w in PLAN_SHAPES])
def test_pair_plan_covers_each_pixel_once(hw):
    for strides in ((1, 3), (5, 7), (2, 9)):
        for sms in (132, 114, 1):  # an H100 SXM's SMs, an H100 PCIe's, one
            plan = stencil.pair_plan(*hw, *strides, sms)
            assert plan.grid == plan.tiles_x * plan.tiles_y
            _check_pair_plan(plan, *hw)


def test_pair_plan_refuses_what_the_kernel_cannot_take():
    assert stencil.pair_plan(0, 16, 1, 3, 132).grid == 0
    for strides in ((0, 3), (1, 0), (1, 23)):
        with pytest.raises(ValueError):
            stencil.pair_plan(64, 64, *strides, 132)
    big = stencil.pair_plan(1080, 1920, 1, 22, 132)  # the largest stride_b a tile fits
    assert big.shared_bytes <= stencil.PAIR_SHARED_BUDGET


def test_pair_constants_match_the_cuda_source():
    with open(os.path.join(CSRC, "eaw_pair.cu")) as f:
        defs = dict(re.findall(r"#define K6_(\w+) (\d+)", f.read()))
    assert (int(defs["THREADS"]), int(defs["ROWS"]), int(defs["R"])) == (
        stencil.PAIR_THREADS, stencil.PAIR_ROWS, stencil.PAIR_REACH)
