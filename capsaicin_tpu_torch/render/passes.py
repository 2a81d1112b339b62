"""The render passes of the frame (RaytracingSystem::Run,
raytracing_system.cpp:230-318): the torch counterpart of
capsaicin_tpu/render/passes.py.

Each pass is a function over [H,W,...] tensors, or over the flat [H*W,...]
pixel list where it traces rays. The gbuffers are typed tensors:
  geo gbuffer  : {"bary": [H,W,2] f32, "prim": [H,W] i32}, -1 = miss
  normal/depth : {"oct": [H,W,2] f32, "inst": [H,W] i32, "depth": [H,W] f32},
                 depth 0 flags background
Traversal comes in as two callables (render.traversal); shading reads the
[T,29] triangle attribute table (`shading.tri_attr_table`) in place of the
Scene. Frame counters are host integers.
"""

from __future__ import annotations

import torch

from ..ops import camera as cam
from ..ops import color as col
from ..ops import mathops as m
from ..ops import resample, sampling, stencil
from . import shading
from .settings import (
    OUTPUT_COMBINED,
    OUTPUT_DIRECT,
    OUTPUT_INDIRECT,
    OUTPUT_VARIANCE,
    RenderOptions,
    Settings,
)

MAX_HISTORY_LENGTH = 256.0  # temporal_accumulation.hlsl:218


# --------------------------------------------------------------------------
# helpers


def shift2d(img, dx: int, dy: int):
    """out[y, x] = img[y+dy, x+dx]; returns (shifted, valid mask [H,W])."""
    h, w = img.shape[:2]
    if dx == 0 and dy == 0:
        return img, torch.ones((h, w), dtype=torch.bool, device=img.device)
    rolled = torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
    ys = torch.arange(h, device=img.device)[:, None] + dy
    xs = torch.arange(w, device=img.device)[None, :] + dx
    return rolled, (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)


def shift2d_clamped(img, dx: int, dy: int):
    """out[y, x] = img[clamp(y+dy), clamp(x+dx)]: the edge-replicated tap."""
    if dx == 0 and dy == 0:
        return img
    h, w = img.shape[:2]
    ys = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def _flat(img):
    return img.reshape((-1,) + tuple(img.shape[2:]))


def _unflat(arr, h, w):
    return arr.reshape((h, w) + tuple(arr.shape[1:]))


def _index(x, lo: int, hi: int):
    """Float pixel coordinates -> int64 indices clamped to [lo, hi]. Clamping
    before the conversion keeps far-off (and NaN) coordinates defined."""
    return torch.nan_to_num(x, nan=float(lo)).clamp(lo, hi).long()


def _sky(device):
    return m.const(shading.SKY_COLOR, device)


# --------------------------------------------------------------------------
# Pass 1: primary visibility (rt_primary_visibility.hlsl)


def trace_primary(closest_fn, camera, width, height, frame_count: int):
    xy = cam.pixel_grid(width, height, camera.position.device)
    o, d = cam.create_primary_rays(camera, xy, (width, height), frame_count)
    hit = closest_fn(_flat(o), _flat(d), 0.0, 1e6)
    return {
        "bary": _unflat(torch.stack([hit["u"], hit["v"]], -1), height, width),
        "prim": _unflat(hit["prim"], height, width),
    }


# --------------------------------------------------------------------------
# Pass 2: direct lighting (rt_direct_lighting.hlsl)


def direct_lighting(table, any_fn, camera, gb, width, height, frame_count: int,
                    options: RenderOptions):
    miss = _flat(gb["prim"] < 0)
    bary = _flat(gb["bary"])
    hit = shading.fetch_hit_attributes(table, _flat(gb["prim"]), bary[:, 0], bary[:, 1])
    p, n = hit["p"], hit["n"]
    kd = shading.material_from_hit(hit, options.use_material_kd)
    black = (kd < 1e-5).all(-1)

    ldir, unshadowed = shading.direct_illumination_terms(p, n, kd, frame_count)
    # rays whose result is unused (primary miss, black albedo, facing away
    # from the light) get tmax < tmin, which the trace retires at once
    live = ~miss & ~black & (unshadowed > 0.0).any(-1)
    stmax = torch.where(live, shading.LIGHT_DISTANCE, -1.0)
    shadow_hit = any_fn(p, ldir, shading.SHADOW_TMIN, stmax)
    di = torch.where(shadow_hit[:, None], 0.0, unshadowed)

    depth = torch.sqrt(((camera.position - p) ** 2).sum(-1))
    invalid = miss | black
    direct = torch.where(miss[:, None], _sky(p.device), torch.where(black[:, None], 0.0, di))
    albedo = torch.where(miss[:, None], 1.0, torch.where(black[:, None], 0.0, kd))
    return (
        _unflat(direct, height, width),
        _unflat(albedo, height, width),
        {
            "oct": _unflat(torch.where(invalid[:, None], 0.0, m.oct_encode(n)), height, width),
            "inst": _unflat(torch.where(invalid, -1, hit["mesh"]), height, width),
            "depth": _unflat(torch.where(invalid, 0.0, depth), height, width),
        },
    )


# --------------------------------------------------------------------------
# Pass 3: indirect diffuse GI (rt_indirect.hlsl), a wavefront over all pixels


def _feedback_fetch(p, prev_camera, combined_history, prev_depth, width, height):
    """GBUFFER_FEEDBACK: the previous frame's combined color at the bounce
    hit's reprojection (bilinear), and whether the hit was disoccluded
    there (rt_indirect.hlsl:110-135). The history and depth are rounded to
    float16 first: the reference keeps its combined history in an RGBA16F
    texture, so the values it re-reads are fp16-quantized too."""
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
    bx = _index(fl[:, 0], -1, width - 1)
    by = _index(fl[:, 1], -1, height - 1)
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
    di = _index(pl[:, 0], 0, width - 1) - bxc
    dj = _index(pl[:, 1], 0, height - 1) - byc
    prev_d = torch.where(
        dj == 0,
        torch.where(di == 0, c00[:, 3], c10[:, 3]),
        torch.where(di == 0, c01[:, 3], c11[:, 3]),
    )
    cur_d = torch.sqrt(((p - prev_camera.position) ** 2).sum(-1))
    disocc = offscreen | ((prev_d - cur_d).abs() / cur_d.clamp_min(1e-20) > 0.05)
    return hist, disocc


def indirect_gi(table, closest_fn, any_fn, camera, prev_camera, gb, combined_history,
                prev_nd, noise, width, height, frame_count: int, options: RenderOptions,
                noise_frame=None):
    """The path loop of rt_indirect.hlsl:42-175 as a wavefront: all pixels
    advance through the bounces together, finished lanes masked. The last
    bounce's trace is never shaded in the reference and is skipped."""
    if options.lowres_indirect:
        raise NotImplementedError("lowres_indirect is not ported yet (ROADMAP A8)")
    if noise_frame is None:
        noise_frame = frame_count
    prim = _flat(gb["prim"])
    bary = _flat(gb["bary"])
    u, v = bary[:, 0], bary[:, 1]
    npix = prim.shape[0]
    color = torch.zeros((npix, 3), device=prim.device)
    throughput = torch.ones((npix, 3), device=prim.device)
    active = prim >= 0
    primary_miss = ~active
    sky = _sky(prim.device)

    for bounce in range(options.num_diffuse_bounces + 1):
        if bounce > 0:
            # lanes whose indirect ray missed: add sky, terminate
            miss_now = active & (prim < 0)
            color = torch.where(miss_now[:, None], color + throughput * sky, color)
            active = active & (prim >= 0)

        hit = shading.fetch_hit_attributes(table, prim, u, v)
        p, n = hit["p"], hit["n"]
        kd = shading.material_from_hit(hit, options.use_material_kd)
        active = active & ~(kd < 1e-5).all(-1)

        if bounce != 0:
            ldir, unshadowed = shading.direct_illumination_terms(p, n, kd, frame_count)
            if options.gbuffer_feedback:
                hist, disocc = _feedback_fetch(
                    p, prev_camera, combined_history, prev_nd["depth"], width, height)
                reuse = active & ~disocc
                color = torch.where(reuse[:, None], color + throughput * hist, color)
                active = active & disocc
            nee_live = active & (unshadowed > 0.0).any(-1)
            shadow_hit = any_fn(p, ldir, shading.SHADOW_TMIN,
                                torch.where(nee_live, shading.LIGHT_DISTANCE, -1.0))
            color = color + torch.where(
                (nee_live & ~shadow_hit)[:, None], throughput * unshadowed, 0.0)

        if bounce == options.num_diffuse_bounces:
            break

        s = sampling.bluenoise4x4_field(
            noise, width, height, noise_frame * 25 + bounce).reshape(-1, 2)
        d, brdf, pdf = shading.lambert_sample(s, n)
        active = active & (pdf >= 1e-5)
        tp_scale = brdf * m.dot(n, d).clamp_min(0.0) / pdf.clamp_min(1e-20)
        throughput = throughput * tp_scale[:, None]
        if bounce != 0:
            throughput = throughput * kd
        # inactive lanes trace with tmax < tmin: the trace retires them
        hit = closest_fn(p, d, 1e-4, torch.where(active, 1e5, -1.0))
        prim = torch.where(active, hit["prim"], -1)
        u, v = hit["u"], hit["v"]

    color = torch.where(primary_miss[:, None], 0.0, color)
    return _unflat(color, height, width)


# --------------------------------------------------------------------------
# Pass 4: spatial gather (spatial_gather.hlsl)


def spatial_gather(*args, **kwargs):
    raise NotImplementedError(
        "the spatial gather (gather=True) is not ported yet (ROADMAP B1)")


# --------------------------------------------------------------------------
# Shared temporal reprojection and history fetch (SVGF accumulate and TAA)


def _luma_combine(taps, base_w, offs, sl, luma_fn):
    """Sum of the taps' channels `sl`, weighted by base weight / (1 + luma)
    (ResampleBicubic, temporal_accumulation.hlsl:38-66)."""
    filtered = tw = None
    for val, wt, off in zip(taps, base_w, offs):
        w_full = torch.where(off, 0.0, wt * (1.0 / (1.0 + luma_fn(val))))
        contrib = w_full[..., None] * val[..., sl]
        filtered = contrib if filtered is None else filtered + contrib
        tw = w_full if tw is None else tw + w_full
    return torch.where((tw > 1e-5)[..., None], filtered / tw.clamp_min(1e-20)[..., None], 0.0)


def _moving_history(packed, prev_uv, prev_xy, width, height):
    """The history channels resampled at the reprojected position: the
    luma-weighted 3x3 bicubic of the reference over a 4x4 corner footprint
    (edge-clamped), and the point fetches of history length and closest
    depth."""
    nch = packed.shape[-1]
    flat = packed.reshape(height * width, nch)
    center_xy = resample.uv_to_xy(prev_uv, (width, height))
    xy0 = center_xy - 0.5
    fl = torch.floor(xy0)
    # coordinates beyond 4 px outside the image only ever read the border
    base_x = _index(fl[..., 0], -4, width + 4)
    base_y = _index(fl[..., 1], -4, height + 4)
    fx = (xy0[..., 0] - fl[..., 0])[..., None]
    fy = (xy0[..., 1] - fl[..., 1])[..., None]
    cols = {c: (base_x + c).clamp(0, width - 1) for c in (-1, 0, 1, 2)}
    rows = {c: (base_y + c).clamp(0, height - 1) * width for c in (-1, 0, 1, 2)}
    corners = {(ci, cj): flat[rows[cj] + cols[ci]] for cj in (-1, 0, 1, 2) for ci in (-1, 0, 1, 2)}

    taps, base_w, offs = [], [], []
    for j in (-1, 0, 1):
        for i in (-1, 0, 1):
            cur_x = center_xy[..., 0] + float(i)
            cur_y = center_xy[..., 1] + float(j)
            offs.append((cur_x < 0.0) | (cur_y < 0.0) | (cur_x >= width) | (cur_y >= height))
            top = corners[(i, j)] * (1.0 - fx) + corners[(i + 1, j)] * fx
            bot = corners[(i, j + 1)] * (1.0 - fx) + corners[(i + 1, j + 1)] * fx
            taps.append(top * (1.0 - fy) + bot * fy)
            # |cur - center| in float32, as the reference computes it
            base_w.append(m.cubic((cur_x - center_xy[..., 0]).abs(), 0.0, 0.5)
                          * m.cubic((cur_y - center_xy[..., 1]).abs(), 0.0, 0.5))

    history = _luma_combine(taps, base_w, offs, slice(0, 3), lambda t: m.luminance(t[..., 0:3]))
    # moments resampled like the reference's .xyz bicubic: luma of (m1, m2, 0)
    moments = _luma_combine(taps, base_w, offs, slice(3, 5),
                            lambda t: t[..., 3] * 0.299 + t[..., 4] * 0.587)
    taa_hist = _luma_combine(taps, base_w, offs, slice(7, 10), lambda t: m.luminance(t[..., 7:10]))

    # point fetches at floor(prev_xy): one of the 2x2 centre corners
    pl = torch.floor(prev_xy)
    di = _index(pl[..., 0], 0, width - 1) - base_x
    dj = _index(pl[..., 1], 0, height - 1) - base_y
    point = torch.zeros_like(corners[(0, 0)][..., 5:7])
    for cj in (0, 1):
        for ci in (0, 1):
            sel = ((di == ci) & (dj == cj))[..., None]
            point = torch.where(sel, corners[(ci, cj)][..., 5:7], point)
    return history, moments, point[..., 0], point[..., 1], taa_hist


def reproject_and_fetch_history(camera, prev_camera, nd, prev_nd, color_history,
                                moments_history, combined_history, width, height):
    """The reprojection shared by the Accumulate and TAA passes
    (temporal_accumulation.hlsl:243-258, :388-400) and the resampled
    histories:
      channels: color_history rgb (3) | moments m1 m2 (2) | history_len (1)
                | prev closest depth (1) | combined_history rgb (3)
    When the camera did not move the reprojection is the identity and the
    histories are read in place (the bicubic weights collapse to the
    centre tap). Both arms are computed and one is chosen on the device, so
    the choice costs no host synchronisation."""
    dev = nd["depth"].device
    wh = m.const((width, height), dev)
    this_uv = (cam.pixel_grid(width, height, dev).float() + 0.5) / wh
    depth = nd["depth"]

    hit_pos = cam.reconstruct_world_position(camera, this_uv, depth)
    prev_uv = cam.calculate_image_plane_uv(prev_camera, hit_pos)
    prev_xy = resample.uv_to_xy(prev_uv, (width, height))
    velocity = torch.sqrt((((prev_uv - this_uv) * wh) ** 2).sum(-1))
    offscreen = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(-1)

    packed = torch.cat(
        [
            color_history[..., :3],
            moments_history[..., :2],
            moments_history[..., 3:4],
            _closest_depth_3x3(prev_nd["depth"])[..., None],
            combined_history[..., :3],
        ],
        -1,
    )
    # static-camera test over non-background pixels, against the identity
    # mapping clamped like prev_xy; 0.01 px of roundtrip noise is snapped
    ident_xy = resample.uv_to_xy(this_uv, (width, height))
    drift = torch.where(depth > 1e-5, (prev_xy - ident_xy).abs().amax(-1), 0.0)
    is_static = drift.max() < 1e-2

    static = (packed[..., 0:3], packed[..., 3:5], packed[..., 5], packed[..., 6], packed[..., 7:10])
    moving = _moving_history(packed, prev_uv, prev_xy, width, height)
    history, moments, hist_len, prev_closest, taa_hist = (
        torch.where(is_static, s, mv) for s, mv in zip(static, moving))
    return {
        "this_uv": this_uv,
        "hit_pos": hit_pos,
        "prev_uv": prev_uv,
        "prev_xy": prev_xy,
        "velocity": velocity,
        "offscreen": offscreen,
        "history": history,
        "moments": moments,
        "hist_len": hist_len,
        "prev_closest": prev_closest,
        "taa_history": taa_hist,
    }


# --------------------------------------------------------------------------
# Pass 5: SVGF temporal accumulation (temporal_accumulation.hlsl Accumulate)


def _closest_depth_3x3(depth):
    """3x3 min of nonzero depths; temporal_accumulation.hlsl:179-205."""
    best = depth
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            d_tap, valid = shift2d(depth, dx, dy)
            best = torch.where(valid & (d_tap != 0.0) & (d_tap < best), d_tap, best)
    return best


def svgf_accumulate(color_in, nd, rep, prev_camera, width, height, frame_count: int,
                    alpha_setting: float, options: RenderOptions):
    """History and moments blend with the shared reprojection `rep`.
    Returns (color_history [H,W,4] rgb + variance,
             moments_history [H,W,4] m1, m2, 0, history length)."""
    if tuple(color_in.shape[:2]) != (height, width):
        raise NotImplementedError("lowres_indirect is not ported yet (ROADMAP A8)")
    color = color_in
    lum = m.luminance(color)
    fresh_moments = torch.stack([lum, lum * lum], -1)
    background = nd["depth"] < 1e-5

    cur_closest = torch.sqrt(((rep["hit_pos"] - prev_camera.position) ** 2).sum(-1))
    disocclusion = (
        rep["offscreen"]
        | (frame_count == 0)
        | ((rep["prev_closest"] - cur_closest).abs() / cur_closest.clamp_min(1e-20) > 0.05)
    )
    history_length = rep["hist_len"]
    alpha = (1.0 - 1.0 / (history_length + 1.0)).clamp_max(alpha_setting)
    alpha = torch.where(history_length < MAX_HISTORY_LENGTH, alpha, alpha_setting)[..., None]

    moments = fresh_moments * (1.0 - alpha) + rep["moments"] * alpha
    variance = (moments[..., 1] - moments[..., 0] ** 2).abs()
    blended = color * (1.0 - alpha) + rep["history"] * alpha

    reset = (background | disocclusion)[..., None]
    zero = torch.zeros_like(lum)[..., None]
    out_color = torch.where(reset, torch.cat([color, zero], -1),
                            torch.cat([blended, variance[..., None]], -1))
    out_moments = torch.where(
        reset,
        torch.cat([fresh_moments, zero, torch.ones_like(zero)], -1),
        torch.cat([moments, zero, (history_length + 1.0)[..., None]], -1),
    )
    return out_color, out_moments


# --------------------------------------------------------------------------
# Pass 6: EAW a-trous denoise chain (eaw_blur.hlsl), kernels K3 and K4


def denoise(color4, nd, moments4, settings: Settings, options: RenderOptions):
    """The EAW chain: disocclusion blur, then strides 1, 3 (and 5, 7 with
    eaw5); raytracing_system.cpp:1437-1539."""
    if not options.denoise:
        return color4
    return stencil.denoise_chain(
        color4, m.oct_decode(nd["oct"]), nd["depth"], moments4, settings, options)


# --------------------------------------------------------------------------
# Pass 7: combine (combine_illumination.hlsl)


def combine(direct, indirect4, albedo, output: int):
    indirect = indirect4[..., :3]
    if output == OUTPUT_COMBINED:
        return indirect * albedo + direct
    if output == OUTPUT_DIRECT:
        return direct
    if output == OUTPUT_INDIRECT:
        return indirect
    if output == OUTPUT_VARIANCE:
        return indirect4[..., 3:4].expand(indirect.shape)
    raise ValueError(f"unknown output mode {output}")


# --------------------------------------------------------------------------
# Pass 8: TAA (temporal_accumulation.hlsl TAA)


def _neighbourhood_aabb(color, scale):
    """5x5 YCoCg mean +- scale*sigma AABB; temporal_accumulation.hlsl:97-137."""
    tc = col.rgb_to_ycocg(col.simple_tonemap(color))
    m1 = torch.zeros_like(tc)
    m2 = torch.zeros_like(tc)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            # clamped (not skipped) taps, as the hlsl clamps
            t = shift2d_clamped(tc, dx, dy)
            m1 = m1 + t
            m2 = m2 + t * t
    m1 = m1 / 25.0
    m2 = m2 / 25.0
    dev = torch.sqrt((m2 - m1 * m1).abs()) * scale[..., None]
    return torch.minimum(m1 - dev, tc), torch.maximum(m1 + dev, tc)


def taa(combined, rep, nd, width, height, taa_feedback: float):
    background = nd["depth"] < 1e-5
    cur_sample = combined  # bilinear at the own texel centre is the identity
    is_static = rep["velocity"] < 1e-3
    alpha = torch.where(is_static, 0.98, 0.6).clamp_max(taa_feedback)[..., None]
    aabb_scale = torch.where(is_static, 5.0, 0.75)

    history = col.rgb_to_ycocg(col.simple_tonemap(rep["taa_history"]))
    color_tc = col.rgb_to_ycocg(col.simple_tonemap(cur_sample))
    pmin, pmax = _neighbourhood_aabb(combined, aabb_scale)
    history = col.clip_to_aabb(pmin, pmax, history)
    blended = col.invert_simple_tonemap(
        col.ycocg_to_rgb(color_tc * (1.0 - alpha) + history * alpha))
    return torch.where((background | rep["offscreen"])[..., None], cur_sample, blended)
