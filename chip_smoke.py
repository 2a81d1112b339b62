#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (capsaicin_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from csrc/, holds each (and its bf16-storage
instance) against its plain PyTorch version at the shapes of the 1080p
frame (the small-scene trace, K1, and the brute-force intersector, K8,
bit-equal on the frame's four ray sets), holds the BVH walk (K7), K8 and
the stream traversal (K10, with its count pass K11) to their plain
versions on the full colonnade's 1080p rays (K7 bit-equal to its walk's
plain versions, its bound counted from the ordered walk) and K10 to K7 on
all of them (K10 also at blocks of 8: 32,768 blocks), times K8 on the
colonnade's subsamples beside its bound, runs the walk microbenchmark (K9,
its out exactly the plain walk's at 40 and 4096 steps), renders the
Cornell box at 1920x1080 with default options through the session API and
checks that the frame went through every kernel, renders the other
configurations of bench.py the same way (the colonnade through the BVH
and through the stream at blocks of 32, 64 and 128), then holds small CUDA
renders against the CPU path. Every kernel's time stands beside its
bound: the largest of its bytes over 3.35 TB/s, its float32 operations
over 67 TFLOP/s (the H100 SXM's HBM rate and float32 rate) and its
special-function operations (lg2, ex2, rcp, sqrt) over 16 a clock on each
SM at the card's maximum SM clock; a time under 95% of it fails the run
(an any-hit trace's bound counts the triangle tests up to each ray's first
hit). It prints K1's and K3's to K11's registers, local and shared memory
and resident warps.

    python3 chip_smoke.py

Exits non-zero, printing no result, when CUDA is unavailable or any check
fails. The last line of its output is one JSON object naming the device.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

# the A/B tools' stencil inputs, frame-ray recorder and event timer serve here too
from capsaicin_tpu_torch.tools.stencil_times import stencil_inputs
from capsaicin_tpu_torch.tools.stream_times import cuda_ms, frame_rays

W, H = 1920, 1080
FRAMES = 8
SMALL = 64
SMALL_FRAMES = 3
RMSE_BAR = 1e-3  # BASELINE.json's accuracy bar
TOL = dict(rtol=1e-3, atol=1e-4)  # float32 kernels against their plain versions
BF16_MAX, BF16_MEAN = 2e-2, 1e-3  # bf16 storage: one rounding may flip by an ulp
SKY = (0.7, 0.7, 0.85)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12
MUFU_PER_SM_CLOCK = 16  # special-function results an SM a clock (Hopper)
# Operations counted per unit of work, for the bounds: a float32 add, mul,
# min, max or compare is one, a fused multiply-add two (as the 67 TFLOP/s
# count it), and a division, sqrt, powf or expf one where a row says no
# more.
OPS_BOX = 22  # slab test of one box: 6 sub, 6 mul, 6 min/max, 4 reductions
OPS_TRI = 45  # Moller-Trumbore: crosses, dots, one division
OPS_ATTR = 60  # K2: interpolation of P, N, UV and the normalisation
# A stencil tap as the card can do it (csrc/eaw_tap.cuh): the normal
# weight's exponent 7 (dot 5, clamp, scale), the depth term 3 and the luma
# term 3 (a difference and a multiply-add each), hw 1 (K4, K6), then 2 a
# channel summed (r, g, b; K3's two moments; the variance's w^2 3) and 1
# for the weight sum; MUFU: lg2 and ex2 a tap, and a pixel's reciprocals
# (inv_d, 1/tw; inv_l where it is per pixel) and sqrt (the variance's
# sigma). K6's taps are those of its two stages on every pixel (its
# recompute of stage A around each tile is its code's work, not its
# function's). K3's taps serve only the pixels it blurs (depth >= 1e-5,
# history shorter than 8); the rest pass through.
TAP_OPS = {"eaw_disocclusion": 24, "eaw_stage": 24, "spatial_gather": 20, "eaw_pair": 24}
MUFU_TAP = 2
MUFU_PIXEL = {"eaw_disocclusion": 2, "eaw_stage": 4, "spatial_gather": 2, "eaw_pair": 8}
OPS_MICROSTEP = 25  # K9: a box test and the step's arithmetic
# K10/K11: interval slab test of one block box against a sub-packet's
# bounds, counted as the least work that gives the plain version's answer
# for the boxes the stream build makes (faces ordered): per axis one
# interval product of [lo - o_hi, hi - o_lo] and the inverse-direction
# interval, 2 sub, 4 mul and, with the corners chosen by the signs of that
# interval, 2 min/max; 2 min and 2 max merge the axes; 3 compares (the
# first count was the plain version's 86: two products an axis, 46
# min/max). A count alone (K11) needs less where every axis of the
# sub-packet's inverse-direction interval straddles 0 and tcap0 >= 0: then
# tn <= 0 <= tf holds, and tf >= tmin_lo decides: 2 sub, 2 mul and a max
# an axis, 2 min, a compare. Where every ray of the sub-packet has one direction (i_lo ==
# i_hi on every axis: the directional light's shadow rays), each extreme is
# one product: 2 sub, 2 mul an axis, the merges and the compares, for K10's
# cull too (csrc/stream_count.cu does these counts).
OPS_IBOX = 31
OPS_IBOX_STRADDLE = 18
OPS_IBOX_POINT = 19
STREAM_BLOCKS = (32, 64, 128)  # K10's block sizes timed (bench.py:129-139)
STREAM_LARGE = 8  # the full colonnade at blocks of 8: 32,768 blocks
SUBSAMPLE = 65_536  # rays of the colonnade's sets the plain walk takes
SPATIAL_VARIANCE_THRESHOLD = 8.0  # K3 blurs a pixel whose history is shorter

# Per-frame launches of the flagship frame (gi1080, default options)
FLAGSHIP_LAUNCHES = {"static_trace": 4, "hit_attributes": 3, "spatial_gather": 1,
                     "eaw_disocclusion": 1, "eaw_stage": 4, "eaw_pair": 0}
# The other Cornell configurations of bench.py:113-160, as (name, size and
# options, frames timed, per-frame launches each fixes)
DIRECT512 = dict(width=512, height=512, options=dict(
    num_diffuse_bounces=0, output=1, taa=False, denoise=False, gather=False))
DIRECT512_LAUNCHES = dict(static_trace=2, hit_attributes=2, spatial_gather=0,
                          eaw_disocclusion=0, eaw_stage=0, eaw_pair=0)
PROGRESSIVE = dict(width=1024, height=1024, options=dict(lowres_indirect=True))
TEXTURED = dict(width=1024, height=1024, scene="textured")
CONFIGS = [
    ("direct512", DIRECT512, 8, DIRECT512_LAUNCHES),
    ("direct512_loop16", dict(DIRECT512, loop=16), 16, DIRECT512_LAUNCHES),
    ("gi1080x4", dict(width=W, height=H, options=dict(num_diffuse_bounces=4)), 8,
     dict(static_trace=10, hit_attributes=6, spatial_gather=1, eaw_stage=4, eaw_pair=0)),
    ("gi1080x4_spp64", dict(width=W, height=H, options=dict(num_diffuse_bounces=4, spp=64)), 4,
     dict(static_trace=514, hit_attributes=321, spatial_gather=1, eaw_stage=4)),
    ("progressive", PROGRESSIVE, 8,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("progressive_loop16", dict(PROGRESSIVE, loop=16), 16,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("textured", TEXTURED, 8,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("textured_loop16", dict(TEXTURED, loop=16), 16,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("textured_u32", dict(TEXTURED, atlas_u32=True), 8,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("gi1080_fp16hist", dict(width=W, height=H, options=dict(history_dtype="float16")), 8,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("gi1080_loop16", dict(width=W, height=H, loop=16), 16,
     dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_stage=4)),
    ("gi1080_eaw_fused1", dict(width=W, height=H, options=dict(eaw_fused="1")), 8,
     dict(eaw_disocclusion=1, eaw_stage=0, eaw_pair=2)),
    ("gi1080_eaw_fused13", dict(width=W, height=H, options=dict(eaw_fused="13")), 8,
     dict(eaw_disocclusion=1, eaw_stage=2, eaw_pair=1)),
    ("gi1080_eaw_bf16", dict(width=W, height=H, options=dict(eaw_bf16=True)), 8,
     dict(spatial_gather=1, eaw_disocclusion=1, eaw_stage=4, eaw_pair=0)),
]
COLONNADE = dict(width=W, height=H, scene="colonnade", traversal="bvh")
COLONNADE_LAUNCHES = dict(bvh_trace=4, hit_attributes=3, static_trace=0, brute_trace=0,
                          spatial_gather=1, eaw_disocclusion=1, eaw_stage=4)
CONFIGS += [
    # bench.py:123: the ~250k-triangle colonnade, 1 bounce, traversal="bvh"
    ("colonnade", COLONNADE, 8, COLONNADE_LAUNCHES),
    ("colonnade_nosort", dict(COLONNADE, options=dict(sort_bounce_rays=False)), 8,
     COLONNADE_LAUNCHES),
    ("gi1080_brute", dict(width=W, height=H, traversal="brute"), 8,
     dict(brute_trace=4, static_trace=0, bvh_trace=0, hit_attributes=3)),
]
COLONNADE_STREAM = dict(COLONNADE, traversal="stream")
STREAM_LAUNCHES = dict(stream_trace=4, stream_count=1, hit_attributes=3, bvh_trace=0,
                       static_trace=0, brute_trace=0)
CONFIGS += [
    # bench.py:129-139: the colonnade through the stream, blocks of 32, 64, 128
    ("colonnade_stream", COLONNADE_STREAM, 8, STREAM_LAUNCHES),
    ("colonnade_stream64", dict(COLONNADE_STREAM, stream_block_tris=64), 8, STREAM_LAUNCHES),
    ("colonnade_stream128", dict(COLONNADE_STREAM, stream_block_tris=128), 8, STREAM_LAUNCHES),
    # without the bounce-ray sort there is no balance, so no count pass
    ("colonnade_stream_nosort", dict(COLONNADE_STREAM, options=dict(sort_bounce_rays=False)), 8,
     dict(STREAM_LAUNCHES, stream_count=0)),
]
# The configuration (or phase) whose run is the path of a kernel not on the
# flagship's
PATH_OF = {"eaw_pair": "gi1080_eaw_fused1", "bvh_trace": "colonnade",
           "brute_trace": "gi1080_brute", "microstep": "microstep",
           "stream_trace": "colonnade_stream", "stream_count": "colonnade_stream"}


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)


@functools.lru_cache(maxsize=None)
def mufu_rate() -> tuple:
    """(special-function operations a second, SMs, maximum SM clock in MHz):
    SMs x 16 a clock x the card's maximum SM clock, as nvidia-smi reads it."""
    import torch

    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * MUFU_PER_SM_CLOCK * clock * 1e6, sms, clock


def bound(ops: float, nbytes: float, mufu: float = 0.0) -> dict:
    """The least time the card could take: the largest of the bytes over
    the HBM rate, the float32 operations over the float32 rate and the
    special-function operations over the MUFU rate (`bound_term` says
    which)."""
    t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "float32": ops / FP32_OPS_PER_S * 1e3,
         "mufu": mufu / mufu_rate()[0] * 1e3}
    term = max(t, key=t.get)
    return dict(bound_ms=t[term], bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, library_ms=None)


def timed(fn):
    """(fn(), its device time in ms) of one call, with no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def rays_per_frame(width, height, bounces, lowres=False, spp=1):
    """Rays traced per frame, counted as bench.py:102 counts them: primary
    and direct shadow at every pixel, and per bounce and per spp sample one
    bounce ray and one NEE shadow ray at the indirect resolution."""
    full = width * height
    half = full // 4 if lowres else full
    return 2 * full + 2 * half * bounces * spp


@functools.lru_cache(maxsize=None)
def host_scene(scene: str):
    """The numpy Scene of a name: "cornell", "textured", "colonnade" (the
    full ~250k triangles) or "colonnade20k" (colonnade(target_tris=20000))."""
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box, cornell_box_textured

    if scene == "textured":
        return build_scene(*cornell_box_textured())
    if scene == "colonnade":
        return build_scene(colonnade())
    if scene == "colonnade20k":
        return build_scene(colonnade(target_tris=20_000))
    return build_scene(cornell_box())


def make_session(width, height, device, options=None, scene="cornell", atlas_u32=False,
                 traversal="auto", stream_block_tris=None):
    """A session with the scene uploaded; its set_scene time (build and
    upload, synchronised) in `session.setup_s`."""
    import torch

    from capsaicin_tpu_torch.render.session import RenderSession
    from capsaicin_tpu_torch.render.settings import RenderOptions
    from capsaicin_tpu_torch.scene.procedural import make_camera
    from capsaicin_tpu_torch.scene.scene import quantize_atlas

    # the EAW variants are set, not taken from the environment's defaults
    options = {"eaw_fused": "0", "eaw_bf16": False, **(options or {})}
    session = RenderSession(width, height, options=RenderOptions(**options),
                            device=device, traversal=traversal,
                            stream_block_tris=stream_block_tris)
    session.set_camera(make_camera("colonnade" if scene.startswith("colonnade") else "cornell",
                                   width, height))
    host = host_scene(scene)
    t0 = time.perf_counter()
    session.set_scene(quantize_atlas(host) if atlas_u32 else host)
    if device == "cuda":
        torch.cuda.synchronize()
    session.setup_s = time.perf_counter() - t0
    return session


def check_image(img, shape, what, sky_corner=True):
    """Shape and finite pixels; the sky in the corner pixel where the
    camera sees it (the Cornell views), else an image that is not flat."""
    import numpy as np

    check(img.shape == shape, f"{what}: display shape {img.shape}")
    check(bool(np.isfinite(img).all()), f"{what}: display has non-finite pixels")
    if not sky_corner:
        check(float(img.std()) > 1e-2, f"{what}: a flat image")
        return
    sky = np.float32(SKY) ** (1.0 / 2.2)
    check(bool(np.abs(img[0, 0] - sky).max() < 1e-3),
          f"{what}: corner pixel {img[0, 0]} is not the sky {sky}")


def check_launches(launches, per_frame, frames, what):
    for name, n in per_frame.items():
        check(launches[name] == n * frames,
              f"{what}: {name} {launches[name]} launches, expected {n * frames}")


def hold_hits(what, got, want, hits_only=False):
    """Closest-hit results (t, u, v, prim) of two intersectors on the same
    rays: prim may differ only on edge rays (either result within 1e-5 of
    an edge) or equal-t rays (rtol 1e-4), on at most 1e-4 of the rays;
    t/u/v within 1e-5 where prim matches (t where both hit, with
    hits_only: the brute-force miss is 1e30, the others' tmax). Returns
    the max abs error."""
    import torch

    t, u, v, prim = got
    tw, uw, vw, pw = want
    n = prim.shape[0]
    edge = torch.zeros_like(prim, dtype=torch.bool)
    for pr, uu, vv in ((prim, u, v), (pw, uw, vw)):
        edge |= (pr >= 0) & ((uu < 1e-5) | (vv < 1e-5) | (1.0 - uu - vv < 1e-5))
    tie = (prim >= 0) & (pw >= 0) & ((t - tw).abs() <= 1e-4 * t.abs())
    diff = prim != pw
    n_diff = int(diff.sum())
    print(f"{what}: {n} rays, {int((pw >= 0).sum())} hits, {n_diff} prim mismatches "
          f"({int((diff & ~edge).sum())} off the edges, {int((diff & ~edge & ~tie).sum())} "
          f"off the edges and ties)")
    check(not bool((diff & ~edge & ~tie).any()), f"{what}: prim differs on a ray that is "
          "neither an edge nor an equal-t ray")
    check(n_diff <= 1e-4 * n, f"{what}: more than 1e-4 of rays differ in prim")
    same = ~diff & (prim >= 0) if hits_only else ~diff
    err = max(float((a - b)[same].abs().max()) if bool(same.any()) else 0.0
              for a, b in ((t, tw), (u, uw), (v, vw)))
    check(err <= 1e-5, f"{what}: t/u/v differ by {err} where prim matches")
    return err


def hold_any(what, got, want):
    n_diff = int((got != want).sum())
    print(f"{what}: {got.shape[0]} rays, {int(want.sum())} occluded, {n_diff} mismatches")
    check(n_diff <= 1e-4 * got.shape[0], f"{what}: more than 1e-4 of rays differ")


def bits(x):
    """A tensor's bits, so that equality is bit-equality (-0.0 is not 0.0)."""
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def compare_trace(session, report):
    """K1 on the four ray sets of a 1080p frame (the third after a reset:
    primary closest, direct shadow any-hit, bounce closest, NEE any-hit),
    bit-equal to its plain version on every ray, each set timed and bounded
    by the triangle tests it needs (closest: every live ray tests every
    triangle; any-hit: up to its first hit, `static.any_hit_tests`); K1's
    builds; K2 against its plain version on the primary hits; K8 bit-equal
    to its plain version on the four sets, bounded as K1, and its builds."""
    import torch

    from capsaicin_tpu_torch.ops import brute, lookup, static

    acc, table = session.accel, session.shade.table
    n_tris = acc.n_tris
    calls = frame_rays(session)
    check([c[0] for c in calls] == ["closest", "any", "closest", "any"],
          f"Cornell frame traces {[c[0] for c in calls]}")
    builds = {}
    for any_hit in (False, True):
        info = builds["any_hit" if any_hit else "closest"] = static.kernel_info(any_hit)
        print(f"static_trace {'any-hit' if any_hit else 'closest'} build: {info['registers']} "
              f"registers a thread, {info['local_bytes']} B local, {info['shared_bytes']} B static "
              f"shared memory a block, {info['ctas_per_sm']} blocks = {info['warps_per_sm']} warps "
              f"resident an SM")
        check(info["local_bytes"] == 0, f"K1 uses {info['local_bytes']} B of local memory")
    per_set, any_tests = {}, {}
    for name, (kind, o, d, tmin, tmax) in zip(("primary", "shadow", "bounce", "nee"), calls):
        any_hit = kind == "any"
        n = o.shape[0]
        got = static.static_trace(acc, o, d, tmin, tmax, any_hit)
        want = static.static_trace_plain(acc.tris, o, d, tmin, tmax, any_hit)
        if any_hit:
            mismatches = {"hit": int((got != (want[3] >= 0)).sum())}
        else:
            mismatches = {k: int((bits(a) != bits(b)).sum())
                          for k, a, b in zip("tuvp", got, want)}
        live = int((tmax > tmin).sum())
        tests = (any_tests.setdefault(name, static.any_hit_tests(acc.tris, o, d, tmin, tmax))
                 if any_hit else None)
        n_tests = float(tests.sum()) if any_hit else float(live * n_tris)
        # per ray: origin, direction, tmax in (28 B); t, u, v, prim (16 B) or the hit out
        entry = dict(rays=n, live=live, hits=int((want[3] >= 0).sum()),
                     tests_per_ray=n_tests / n, mismatches=mismatches,
                     ms=cuda_ms(lambda: static.static_trace(acc, o, d, tmin, tmax, any_hit), 20),
                     plain_ms=cuda_ms(lambda: static.static_trace_plain(acc.tris, o, d, tmin, tmax,
                                                                        any_hit), 3),
                     **bound(n_tests * OPS_TRI, n * (28 + (1 if any_hit else 16)) + n_tris * 36))
        per_set[name] = entry
        print(f"K1 {kind} ({name}): {n} rays ({live} live, {entry['hits']} hits), "
              f"{entry['tests_per_ray']:.2f} triangle tests a ray; mismatches against its plain "
              f"version {mismatches}; {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f} ms), "
              f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
        check(not any(mismatches.values()), f"K1 {kind} ({name}): differs from its plain version")
        check(entry["ms"] >= 0.95 * entry["bound_ms"],
              f"K1 {kind} ({name}): {entry['ms']} ms below 95% of its bound {entry['bound_ms']} ms")
    mean = lambda key: sum(e[key] for e in per_set.values()) / len(per_set)  # noqa: E731
    report["static_trace"] = dict(max_abs_err=0.0, ms=mean("ms"), plain_ms=mean("plain_ms"),
                                  bound_ms=mean("bound_ms"), bound_by=per_set["primary"]["bound_by"],
                                  library_ms=None, build=builds, per_set=per_set)

    # K2 on the primary hits
    _, o, d, tmin, tmax = calls[0]
    t, u, v, prim = static.static_trace(acc, o, d, tmin, tmax, False)
    n = prim.shape[0]
    got = lookup.hit_attributes(table, prim, u, v)
    want = lookup.hit_attributes_plain(table, prim, u, v)
    k2_err = 0.0
    for key in want:
        a, b = got[key].double(), want[key].double()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        k2_err = max(k2_err, float((a - b).abs().max()))
    k2_ms = cuda_ms(lambda: lookup.hit_attributes(table, prim, u, v), 20)
    k2_plain = cuda_ms(lambda: lookup.hit_attributes_plain(table, prim, u, v), 20)
    print(f"K2: max abs err {k2_err:.3g} against the plain version; {k2_ms:.4f} ms (plain "
          f"{k2_plain:.4f} ms)")
    # per ray: prim, u, v in (12 B); P, N, UV, kd, texture and mesh id out (52 B)
    report["hit_attributes"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                                    **bound(n * OPS_ATTR, n * 64 + table.numel() * 4))

    # K8 on the same four sets and triangles (the brute-force packing is
    # K1's), bit-equal to its plain version; its any-hit stops at the first
    # hit in index order, as K1's does, so its bound is K1's: the tests the
    # rays need
    k8_builds = {}
    for any_hit in (False, True):
        info = k8_builds["any_hit" if any_hit else "closest"] = brute.kernel_info(any_hit, n_tris)
        print(f"brute_trace {'any-hit' if any_hit else 'closest'} build: {info['registers']} "
              f"registers a thread, {info['local_bytes']} B local, {info['shared_bytes']} B static "
              f"shared memory a block, {info['ctas_per_sm']} blocks = {info['warps_per_sm']} warps "
              f"resident an SM")
        check(info["local_bytes"] == 0, f"K8 uses {info['local_bytes']} B of local memory")
    k8_sets = {}
    for name, (kind, so, sd, stmin, stmax) in zip(("primary", "shadow", "bounce", "nee"), calls):
        any_hit = kind == "any"
        got = brute.brute_trace(acc, so, sd, stmin, stmax, any_hit)
        want = brute.brute_trace_plain(acc.tris, so, sd, stmin, stmax, any_hit)
        if any_hit:
            mismatches = {"hit": int((got != want).sum())}
            n_tests = float(any_tests[name].sum())
        else:
            mismatches = {k: int((bits(a) != bits(b)).sum()) for k, a, b in zip("tuvp", got, want)}
            n_tests = float((stmax > stmin).sum()) * n_tris
        print(f"K8 {kind} vs its plain version, Cornell {name}: {so.shape[0]} rays, "
              f"mismatches {mismatches}")
        check(not any(mismatches.values()), f"K8 {kind} ({name}): differs from its plain version")
        if name == "primary":
            hold_hits("K8 closest vs K1, Cornell primary", got, (t, u, v, prim), hits_only=True)
        ms = cuda_ms(lambda: brute.brute_trace(acc, so, sd, stmin, stmax, any_hit), 20)
        b = bound(n_tests * OPS_TRI, so.shape[0] * (28 + (1 if any_hit else 16)) + n_tris * 36)
        k8_sets[name] = dict(ms=ms, mismatches=mismatches, **b)
        print(f"K8 {kind} ({name}): {ms:.4f} ms (K1 {per_set[name]['ms']:.4f} ms), bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(ms >= 0.95 * b["bound_ms"],
              f"K8 {kind} ({name}): {ms} ms below 95% of its bound {b['bound_ms']} ms")
    k8_plain = cuda_ms(lambda: brute.brute_trace_plain(acc.tris, o, d, tmin, tmax, False), 3)
    print(f"K8 plain version, Cornell primary: {k8_plain:.4f} ms")
    report["brute_trace"] = dict(max_abs_err=0.0, plain_ms=k8_plain,
                                 any_ms=k8_sets["shadow"]["ms"],
                                 any_bound_ms=k8_sets["shadow"]["bound_ms"],
                                 build=k8_builds, per_set=k8_sets, **k8_sets["primary"])


def blurred(name, args):
    """The pixels whose taps a stencil's function needs: all of them, but
    for K3 only those it blurs (depth >= 1e-5 and a history shorter than 8)."""
    if name != "eaw_disocclusion":
        return args[0].shape[0] * args[0].shape[1]
    geo, mom = args[1], args[2]
    return int(((geo[..., 3] >= 1e-5) & (mom[..., 2] < SPATIAL_VARIANCE_THRESHOLD)).sum())


def compare_stencils(session, report):
    """K3-K6, their bf16 instances and the whole chain in each grouping
    against their plain versions, on the gather's and the denoiser's
    inputs of a 1080p frame (the third after a reset) and on the gather's
    input of a lowres_indirect frame ([540, 960]); K4's and K5's builds."""
    import dataclasses

    import torch

    from capsaicin_tpu_torch.ops import stencil

    opts = session.options
    x = stencil_inputs(session)
    color4, geo, mom, moments4 = x["color4"], x["geo"], x["moments"], x["moments4"]
    indirect, full_geo, low_in, low_geo = x["indirect"], x["full_geo"], x["low_in"], x["low_geo"]
    s, sig, gsig = session.settings, x["sig"], x["gsig"]
    check(tuple(low_in.shape) == (H // 2, W // 2, 3), f"lowres gather input {low_in.shape}")
    strides = stencil.chain_strides(opts)
    pairs = ((1, 3), (5, 7))

    def close(a, b, what):
        torch.testing.assert_close(a, b, msg=what, **TOL)
        return float((a - b).abs().max())

    def close_bf16(a, b, what):
        check(a.dtype == b.dtype == torch.bfloat16, f"{what}: dtypes {a.dtype}, {b.dtype}")
        err = (a.float() - b.float()).abs()
        e_max, e_mean = float(err.max()), float(err.mean())
        check(e_max <= BF16_MAX and e_mean <= BF16_MEAN,
              f"{what}: bf16 max abs err {e_max}, mean {e_mean}")
        return e_max, e_mean

    def close_disocc(a, b, moments, what):
        """K3: colour as `close` (bf16 `close_bf16`); the variance, 8 /
        hist_len * |m2 - m1^2| of the blurred moments, which cancels, within
        1e-4 + 1e-3 of itself (bf16 2^-7, an ulp) + 1e-3 of its terms before
        the difference (stencil.disocc_variance_scale). Returns the max abs
        error (bf16: and the mean)."""
        bf16 = a.dtype == torch.bfloat16
        got = (close_bf16 if bf16 else close)(a[..., :3].contiguous(), b[..., :3].contiguous(),
                                            f"{what} colour")
        err = (a[..., 3].float() - b[..., 3].float()).abs()
        scale = stencil.disocc_variance_scale(moments)
        bar = 1e-4 + (2.0 ** -7 if bf16 else 1e-3) * b[..., 3].float().abs() + 1e-3 * scale
        tol = bool((err <= 1e-4 + (2.0 ** -7 if bf16 else 1e-3) * b[..., 3].float().abs()).all())
        print(f"{what}: variance max abs err {float(err.max()):.3g}, at most "
              f"{float((err / (1e-4 + scale)).max()):.3g} of 1e-4 + its terms (bar 1e-3); within "
              f"the colour's rtol and atol alone: {tol}")
        check(bool((err <= bar).all()), f"{what}: variance beyond its bar by "
              f"{float((err - bar).max())}")
        if bf16:
            return max(got[0], float(err.max())), max(got[1], float(err.mean()))
        return max(got, float(err.max()))

    # each kernel, its plain version and the argument sets it is held on
    cases = {
        "eaw_disocclusion": (stencil.eaw_disocclusion, stencil.eaw_disocclusion_plain,
                             [(color4, geo, mom, *sig)]),
        "eaw_stage": (stencil.eaw_stage, stencil.eaw_stage_plain,
                      [(color4, geo, k, v, *sig) for v in (True, False) for k in strides]),
        "spatial_gather": (stencil.spatial_gather, stencil.spatial_gather_plain,
                           [(indirect, full_geo, *gsig), (low_in, low_geo, *gsig)]),
        "eaw_pair": (stencil.eaw_pair, stencil.eaw_pair_plain,
                     [(color4, geo, *p, True, *sig) for p in pairs]),
    }
    # taps per pixel, and bytes per pixel read and written in float32
    work = {"eaw_disocclusion": (49, 16 + 16 + 12 + 16), "eaw_stage": (25, 16 + 16 + 16),
            "spatial_gather": (49, 12 + 16 + 12), "eaw_pair": (50, 16 + 16 + 16)}
    for name, (kernel, plain, arg_sets) in cases.items():
        taps, bpp = work[name]
        if name == "eaw_stage":  # timed and bounded with the variance, as the chain runs it
            held, arg_sets = arg_sets, [a for a in arg_sets if a[3]]
            for a in held[len(arg_sets):]:
                close(kernel(*a), plain(*a), f"{name} stride {a[2]} without the variance")
                b = tuple(v.bfloat16() if torch.is_tensor(v) else v for v in a)
                close_bf16(kernel(*b), plain(*b), f"{name} bf16 stride {a[2]} without the variance")
        bounds = [bound(bx * taps * TAP_OPS[name], px * bpp,
                        bx * (taps * MUFU_TAP + MUFU_PIXEL[name]))
                  for px, bx in ((a[0].shape[0] * a[0].shape[1], blurred(name, a))
                                 for a in arg_sets)]
        bf_sets = [tuple(a.bfloat16() if torch.is_tensor(a) else a for a in args)
                   for args in arg_sets]
        if name == "eaw_disocclusion":
            err = max(close_disocc(kernel(*a), plain(*a), a[2], f"{name} case {n}")
                      for n, a in enumerate(arg_sets))
            bf_err = [close_disocc(kernel(*a), plain(*a), a[2], f"{name} bf16 case {n}")
                      for n, a in enumerate(bf_sets)]
        else:
            err = max(close(kernel(*a), plain(*a), f"{name} case {n}")
                      for n, a in enumerate(arg_sets))
            bf_err = [close_bf16(kernel(*a), plain(*a), f"{name} bf16 case {n}")
                      for n, a in enumerate(bf_sets)]
        ms = [cuda_ms(lambda a=a: kernel(*a), 20) for a in arg_sets]
        plain_ms = [cuda_ms(lambda a=a: plain(*a), 3) for a in arg_sets]
        bf_ms = [cuda_ms(lambda a=a: kernel(*a), 20) for a in bf_sets]
        bf_plain = [cuda_ms(lambda a=a: plain(*a), 3) for a in bf_sets]
        entry = dict(max_abs_err=err, ms=sum(ms) / len(ms), plain_ms=sum(plain_ms) / len(ms),
                     bf16_max_abs_err=max(e for e, _ in bf_err),
                     bf16_mean_abs_err=max(e for _, e in bf_err),
                     bf16_ms=sum(bf_ms) / len(ms), bf16_plain_ms=sum(bf_plain) / len(ms),
                     bound_ms=sum(b["bound_ms"] for b in bounds) / len(ms),
                     bound_by=bounds[0]["bound_by"], bound_term=bounds[0]["bound_term"],
                     library_ms=None)
        if len(ms) > 1:  # per case: strides, pairs, or the gather's full and half resolution
            entry.update(case_ms=ms, case_plain_ms=plain_ms, case_bf16_ms=bf_ms,
                         case_bound_ms=[b["bound_ms"] for b in bounds])
        if name in ("eaw_disocclusion", "eaw_stage", "spatial_gather", "eaw_pair"):
            entry["build"] = {}
            for dt in (torch.float32, torch.bfloat16):
                info = stencil.kernel_info(name, dt)
                entry["build"][str(dt).split(".")[1]] = info
                print(f"{name} {dt} build: {info['registers']} registers a thread, "
                      f"{info['local_bytes']} B local, {info['dynamic_shared_bytes']} B dynamic "
                      f"shared memory a block, {info['ctas_per_sm']} blocks = "
                      f"{info['warps_per_sm']} warps resident an SM")
        report[name] = entry
        print(f"{name}: max abs err {err:.3g} (bf16 {entry['bf16_max_abs_err']:.3g}, mean "
              f"{entry['bf16_mean_abs_err']:.3g}); {entry['ms']:.4f} ms (plain "
              f"{entry['plain_ms']:.4f} ms), bf16 {entry['bf16_ms']:.4f} ms (plain "
              f"{entry['bf16_plain_ms']:.4f} ms); per case {[round(x, 4) for x in ms]} ms")

    # K3 where the history has filled on half the image (those pixels pass
    # through, and blocks all of whose outputs do stage nothing), and at
    # [540, 960] (every other pixel of the frame's inputs)
    steady = mom.clone()
    steady[:, : W // 2, 2] += stencil.SPATIAL_VARIANCE_THRESHOLD
    held = {"the history filled on half the image": (color4, geo, steady),
            "[540, 960]": tuple(v[::2, ::2].contiguous() for v in (color4, geo, mom))}
    for case, inputs in held.items():
        for dt in (torch.float32, torch.bfloat16):
            a = (*(v.to(dt) for v in inputs), *sig)
            what = f"eaw_disocclusion {str(dt).split('.')[1]}, {case}"
            close_disocc(stencil.eaw_disocclusion(*a), stencil.eaw_disocclusion_plain(*a), a[2],
                         what)
            print(f"{what}: {cuda_ms(lambda: stencil.eaw_disocclusion(*a), 20):.4f} ms, "
                  f"{blurred('eaw_disocclusion', a)} pixels blurred")

    def plain_chain(groups=tuple((k,) for k in strides), dt=torch.float32):
        """The chain of plain versions in `dt` storage, grouped as the
        kernels are (a pair keeps its intermediate in float32)."""
        c, g, mo = color4.to(dt), geo.to(dt), mom.to(dt)
        out = stencil.eaw_disocclusion_plain(c, g, mo, *sig)
        for group in groups:
            out = (stencil.eaw_pair_plain(out, g, *group, True, *sig) if len(group) == 2
                   else stencil.eaw_stage_plain(out, g, group[0], True, *sig))
        return out.float()

    def chain(o):
        return stencil.denoise_chain(color4, x["normal"], x["depth"], moments4, s, o)

    want = plain_chain()
    chain_plain = cuda_ms(plain_chain, 2)
    for fused in ("0", "1", "13"):
        o32 = dataclasses.replace(opts, eaw_fused=fused)
        o16 = dataclasses.replace(o32, eaw_bf16=True)
        err = close(chain(o32), want, f"denoise_chain eaw_fused={fused}")
        print(f"denoise_chain eaw_fused={fused}: max abs err {err:.3g} against the plain "
              f"sequential chain; {cuda_ms(lambda: chain(o32), 10):.4f} ms "
              f"(plain {chain_plain:.4f} ms)")
        e = (chain(o16) - plain_chain(stencil.chain_groups(o16), torch.bfloat16)).abs()
        e_max, e_mean = float(e.max()), float(e.mean())
        check(e_max <= BF16_MAX and e_mean <= BF16_MEAN,
              f"denoise_chain eaw_fused={fused} eaw_bf16: max abs err {e_max}, mean {e_mean}")
        print(f"denoise_chain eaw_fused={fused} eaw_bf16: max abs err {e_max:.3g} (mean "
              f"{e_mean:.3g}) against the plain chain of the same grouping in bf16; "
              f"{cuda_ms(lambda: chain(o16), 10):.4f} ms")


def compare_bvh(report):
    """K7 on the full colonnade's 1080p rays (primary, direct shadow,
    bounce and NEE of the third frame): against its plain version and K8
    on a subsample (K8 also bit-equal to its plain version there), against
    K7 over trees of other leaf sizes and through the ray sort on all rays;
    its times at leaf 4, 8 and 32; and K2 on the colonnade's 249,190-row
    table. Returns the four ray sets, the triangles
    and the leaf-4 tree, for compare_stream."""
    import torch

    from capsaicin_tpu_torch.ops import brute, bvh, lookup, static, traverse

    session = make_session(W, H, "cuda", scene="colonnade", traversal="bvh")
    acc = session.accel
    check(acc.leaf_size == bvh.LEAF_SIZE, f"leaf size {acc.leaf_size}")
    tris = torch.stack([session.scene_dev.tri_v0, session.scene_dev.tri_v1,
                        session.scene_dev.tri_v2], 1)
    trees = {bvh.LEAF_SIZE: acc}
    for leaf in (4, 8, 32):
        if leaf not in trees:
            trees[leaf] = bvh.build_bvh(tris, leaf)
    for leaf, tree in sorted(trees.items()):
        print(f"colonnade BVH leaf {leaf}: {tree.n_leaves} leaves, depth {tree.depth}, "
              f"wide records {tree.wide.numel() * 4 / 2**20:.2f} MiB, "
              f"triangles {tree.tris.numel() * 4 / 2**20:.2f} MiB")
    builds = {any_hit: bvh.kernel_info(torch.cuda.current_device(), any_hit, acc.depth)
              for any_hit in (False, True)}
    for any_hit, info in builds.items():
        print(f"K7 {'any-hit' if any_hit else 'closest-hit'} build at depth {acc.depth}: {info}")
        check(info["local_bytes"] == 0, f"K7 uses {info['local_bytes']} B of local memory")
    scene8 = static.pack_triangles(tris)
    k8_builds = {}
    for any_hit in (False, True):  # the tiled instance (Cornell's fits one tile)
        info = k8_builds["any_hit" if any_hit else "closest"] = brute.kernel_info(any_hit,
                                                                                  scene8.n_tris)
        print(f"brute_trace {'any-hit' if any_hit else 'closest'} build at {scene8.n_tris} "
              f"triangles: {info['registers']} registers a thread, {info['local_bytes']} B local, "
              f"{info['shared_bytes']} B static shared memory a block, {info['ctas_per_sm']} "
              f"blocks = {info['warps_per_sm']} warps resident an SM")
        check(info["local_bytes"] == 0, f"K8 uses {info['local_bytes']} B of local memory")
    names = ("primary", "shadow", "bounce", "nee")
    calls = frame_rays(session)
    check([c[0] for c in calls] == ["closest", "any", "closest", "any"],
          f"colonnade frame traces {[c[0] for c in calls]}")
    errs, per_set, k8_colonnade = [], {}, {}
    for name, (kind, o, d, tmin, tmax) in zip(names, calls):
        any_hit = kind == "any"
        n = o.shape[0]
        live = int((tmax >= tmin).sum())
        full = bvh.bvh_trace(acc, o, d, tmin, tmax, any_hit)
        idx = torch.arange(0, n, n // SUBSAMPLE, device=o.device)[:SUBSAMPLE]
        so, sd, stm = o[idx], d[idx], tmax[idx]
        sub = bvh.bvh_trace(acc, so, sd, tmin, stm, any_hit)
        # K7's walk on binary records (its plain version: bit-equal, and the
        # bound's count), its own four-wide walk and the stackless one
        plain, plain_ms = timed(lambda: traverse.ordered_walk(acc.host, so, sd, tmin, stm, any_hit,
                                                              counts=True))
        wide = traverse.wide_walk(acc.wide, acc.host, so, sd, tmin, stm, any_hit, counts=True)
        check(all(torch.equal(wide[k], plain[k]) for k in ("t", "u", "v", "prim")),
              f"K7 {kind} ({name}): the four-wide walk's plain version differs from the binary")
        stackless = traverse.traverse(acc.host, so, sd, tmin, stm, any_hit, counts=True)
        k8 = brute.brute_trace(scene8, so, sd, tmin, stm, any_hit)
        k8_ms = cuda_ms(lambda: brute.brute_trace(scene8, so, sd, tmin, stm, any_hit), 3)
        # K8 bit-equal to its plain arithmetic on the subsample, across its
        # tiles. Its work: every live ray tests every triangle; an any-hit
        # ray those up to its first hit in index order
        if any_hit:
            first, k8_plain_ms = timed(lambda: static.first_hits(scene8.tris, so, sd, tmin, stm))
            k8_same = torch.equal(k8, first >= 0)
            k8_tests = float(torch.where(first >= 0, first + 1, scene8.n_tris)[stm > tmin].sum())
        else:
            k8_plain, k8_plain_ms = timed(lambda: brute.brute_trace_plain(
                scene8.tris, so, sd, tmin, stm, False))
            k8_same = all(map(torch.equal, k8, k8_plain))
            k8_tests = float((stm > tmin).sum()) * scene8.n_tris
        print(f"K8 {kind} on the colonnade's {len(idx)}-ray subsample ({name}) vs its plain "
              f"version: bit-equal {k8_same} (the plain check took {k8_plain_ms:.1f} ms)")
        check(k8_same, f"K8 {kind} (colonnade {name}): differs from its plain version")
        k8_bound = bound(k8_tests * OPS_TRI,
                         len(idx) * (28 + (1 if any_hit else 16)) + scene8.n_tris * 36)
        print(f"K8 {kind} on the colonnade's {len(idx)}-ray subsample ({name}): {k8_ms:.3f} ms, "
              f"{k8_tests / len(idx):.0f} triangle tests a ray, bound {k8_bound['bound_ms']:.4f} "
              f"ms ({k8_bound['bound_by']})")
        check(k8_ms >= 0.95 * k8_bound["bound_ms"],
              f"K8 {kind} (colonnade {name}): {k8_ms} ms below 95% of its bound")
        k8_colonnade[name] = dict(rays=len(idx), ms=k8_ms, plain_check_ms=k8_plain_ms,
                                  tests_per_ray=k8_tests / len(idx),
                                  **k8_bound)
        what = f"K7 {kind} ({name})"
        if any_hit:
            check(torch.equal(sub, full[idx]), f"{what}: the subsample's hits differ from the full run's")
            n_diff = int((sub != (plain["prim"] >= 0)).sum())
            print(f"{what} vs its plain version (the ordered walk): {len(idx)} rays, "
                  f"{n_diff} mismatches")
            check(n_diff == 0, f"{what}: differs from the ordered walk")
            hold_any(f"{what} vs the stackless walk", sub, stackless["prim"] >= 0)
            hold_any(f"{what} vs K8", sub, k8)
        else:
            check(all(torch.equal(a, b[idx]) for a, b in zip(sub, full)),
                  f"{what}: the subsample's hits differ from the full run's")
            plain4 = tuple(plain[k] for k in ("t", "u", "v", "prim"))
            n_diff = int((sub[3] != plain4[3]).sum())
            same = all(torch.equal(a, b) for a, b in zip(sub, plain4))
            print(f"{what} vs its plain version (the ordered walk): {len(idx)} rays, "
                  f"{n_diff} prim mismatches, t/u/v/prim bit-equal: {same}")
            check(same, f"{what}: differs from the ordered walk")
            errs.append(0.0)  # bit-equal
            hold_hits(f"{what} vs the stackless walk", sub,
                      tuple(stackless[k] for k in ("t", "u", "v", "prim")))
            hold_hits(f"{what} vs K8", sub, k8, hits_only=True)
        for leaf, tree in trees.items():
            if leaf != acc.leaf_size:
                other = bvh.bvh_trace(tree, o, d, tmin, tmax, any_hit)
                (hold_any if any_hit else hold_hits)(f"{what} leaf {acc.leaf_size} vs leaf {leaf}",
                                                    full, other)
        times = {leaf: cuda_ms(lambda tree=tree: bvh.bvh_trace(tree, o, d, tmin, tmax, any_hit), 5)
                 for leaf, tree in sorted(trees.items())}
        # as the frame calls it: a pixel-order set goes to K7 as 8x4 tiles
        pixel_fn = session._trace[1 if any_hit else 0]
        tiled = pixel_fn(o, d, tmin, tmax)
        tiled = tiled if any_hit else tuple(tiled[k] for k in ("t", "u", "v", "prim"))
        check(torch.equal(tiled, full) if any_hit else all(map(torch.equal, tiled, full)),
              f"{what}: the session's call (8x4 tiles) gives other hits")
        session_ms = cuda_ms(lambda: pixel_fn(o, d, tmin, tmax), 5)
        # the bound: the box and triangle tests of the ordered walk (K7's
        # binary walk: a yardstick that does not move with the layout) on the
        # subsample, scaled to all rays; bytes: rays in (28 B), results out
        # (16 B, any-hit 1 B), the binary tree's pair records (64 B a leaf)
        # and the triangle slots once
        boxes, tests, records = (float(plain[k].double().mean())
                                 for k in ("boxes", "tris", "records"))
        ops = (boxes * OPS_BOX + tests * OPS_TRI) * n
        nbytes = n * (28 + (1 if any_hit else 16)) + acc.n_leaves * 64 + acc.tris.numel() * 4
        entry = dict(rays=n, live=live, box_tests_per_ray=boxes, tri_tests_per_ray=tests,
                     records_per_ray=records,
                     wide_records_per_ray=float(wide["records"].double().mean()),
                     wide_box_tests_per_ray=float(wide["boxes"].double().mean()),
                     stackless_box_tests_per_ray=float(stackless["boxes"].double().mean()),
                     stackless_tri_tests_per_ray=float(stackless["tris"].double().mean()),
                     ms_by_leaf=times, session_ms=session_ms, plain_ms=plain_ms,
                     plain_rays=len(idx), **bound(ops, nbytes))
        if name in ("bounce", "nee"):  # the session traces these sorted
            fn = session._sorted_trace[1 if any_hit else 0]
            got = fn(o, d, tmin, tmax)
            got = got if any_hit else tuple(got[k] for k in ("t", "u", "v", "prim"))
            check(torch.equal(got, full) if any_hit else all(map(torch.equal, got, full)),
                  f"{what}: sorted rays give other hits")
            order, _ = bvh.sort_rays_for_traversal(o, d, dead=tmax < tmin)
            oo, od, otm = o[order].contiguous(), d[order].contiguous(), tmax[order].contiguous()
            entry["sorted_ms"] = cuda_ms(lambda: bvh.bvh_trace(acc, oo, od, tmin, otm, any_hit), 5)
            entry["sort_and_trace_ms"] = cuda_ms(lambda: fn(o, d, tmin, tmax), 5)
        per_set[name] = entry
        print(f"{what}: {n} rays ({live} live); K7 ms by leaf size {times}, as the session "
              f"calls it (leaf 4, 8x4 tiles) {session_ms:.4f}; plain "
              f"{plain_ms:.1f} ms on {len(idx)} rays; {boxes:.1f} box and {tests:.1f} triangle "
              f"tests and {records:.1f} pair records per ray (the ordered walk; K7's four-wide "
              f"walk: {entry['wide_box_tests_per_ray']:.1f} box tests and "
              f"{entry['wide_records_per_ray']:.1f} records; the stackless "
              f"walk: {entry['stackless_box_tests_per_ray']:.1f} box and "
              f"{entry['stackless_tri_tests_per_ray']:.1f} triangle tests); bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})"
              + (f"; sorted rays {entry['sorted_ms']:.4f} ms, sort and "
                                          f"trace {entry['sort_and_trace_ms']:.4f} ms"
                                          if "sorted_ms" in entry else ""))
    mean = lambda key: sum(e[key] for e in per_set.values()) / len(per_set)  # noqa: E731
    report["bvh_trace"] = dict(
        max_abs_err=max(errs), ms=mean("session_ms"), plain_ms=mean("plain_ms"),
        plain_rays=SUBSAMPLE,
        bound_ms=mean("bound_ms"), bound_by=per_set["primary"]["bound_by"], library_ms=None,
        leaf_size=acc.leaf_size, build=builds[False], build_any_hit=builds[True],
        per_set=per_set)
    report["brute_trace"]["colonnade_subsample"] = k8_colonnade
    report["brute_trace"]["build_tiled"] = k8_builds

    # K2 on the colonnade's primary hits: the table is read from device memory
    table = session.shade.table
    t, u, v, prim = bvh.bvh_trace(acc, *calls[0][1:3], calls[0][3], calls[0][4], False)
    got = lookup.hit_attributes(table, prim, u, v)
    want = lookup.hit_attributes_plain(table, prim, u, v)
    err = 0.0
    for key in want:
        torch.testing.assert_close(got[key].double(), want[key].double(), rtol=1e-6, atol=1e-6)
        err = max(err, float((got[key].double() - want[key].double()).abs().max()))
    k2_ms = cuda_ms(lambda: lookup.hit_attributes(table, prim, u, v), 20)
    k2_plain = cuda_ms(lambda: lookup.hit_attributes_plain(table, prim, u, v), 20)
    n = prim.shape[0]
    large = bound(n * OPS_ATTR, n * 64 + table.numel() * 4)
    print(f"K2 on the colonnade's {table.shape[0]}-row table: max abs err {err:.3g}; "
          f"{k2_ms:.4f} ms (plain {k2_plain:.4f} ms), bound {large['bound_ms']:.4f} ms")
    report["hit_attributes"].update(large_table_rows=table.shape[0], large_table_max_abs_err=err,
                                    large_table_ms=k2_ms, large_table_plain_ms=k2_plain,
                                    large_table_bound_ms=large["bound_ms"])
    del session
    return calls, tris, acc


def stream_subsample(n, device):
    """Ray indices of a subsample of whole sub-packets, evenly spaced, about
    SUBSAMPLE rays: each pops what it pops in the full run. Returns
    (sub-packet indices, ray indices)."""
    import torch

    from capsaicin_tpu_torch.ops import stream

    p = -(-n // stream.LANE)
    sp = torch.arange(0, p, max(1, p * stream.LANE // SUBSAMPLE), device=device)
    sp = sp[:SUBSAMPLE // stream.LANE]
    idx = (sp[:, None] * stream.LANE + torch.arange(stream.LANE, device=device)).reshape(-1)
    return sp, idx[idx < n]


def hold_stream(what, sb, o, d, tmin, tmax, any_hit):
    """K10 on all rays and on a subsample of whole sub-packets, held to its
    plain version there. Returns (the full result, the plain result with
    its work counts, the subsample's sub-packets and rays, the plain
    version's ms, the max abs error)."""
    import torch

    from capsaicin_tpu_torch.ops import stream

    full = stream.stream_trace(sb, o, d, tmin, tmax, any_hit)
    sp, idx = stream_subsample(o.shape[0], o.device)
    so, sd, stm = o[idx], d[idx], tmax[idx]
    sub = stream.stream_trace(sb, so, sd, tmin, stm, any_hit)
    plain, plain_ms = timed(lambda: stream.stream_trace_plain(sb, so, sd, tmin, stm, any_hit))
    err = 0.0
    if any_hit:
        check(torch.equal(sub, full[idx]), f"{what}: the subsample's hits differ from the full run's")
        hold_any(f"{what} vs its plain version", sub, plain["hit"])
        check(torch.equal(sub, plain["hit"]), f"{what}: hits differ from the plain version's")
    else:
        check(all(torch.equal(a, b[idx]) for a, b in zip(sub, full)),
              f"{what}: the subsample's hits differ from the full run's")
        err = hold_hits(f"{what} vs its plain version", sub,
                        tuple(plain[k] for k in ("t", "u", "v", "prim")))
        check(torch.equal(sub[3], plain["prim"]), f"{what}: prim differs from the plain version's")
    return full, plain, sp, idx, plain_ms, err


def stream_bound(sb, plain, o, d, tmin, tmax, any_hit):
    """K10's bound on the rays o, d from its plain version's work on a
    subsample of whole sub-packets, scaled to all of them: the cull of each
    sub-packet with a live ray (`cull_ops`), a slab test (22) for each box
    test, a Moller-Trumbore test (45) for each triangle test; the bytes of
    each input read once (the rays, 28 B; the box table and the triangle
    slots) and the results written once (16 B, any-hit 1 B)."""
    import torch

    from capsaicin_tpu_torch.ops import stream

    n = o.shape[0]
    p = -(-n // stream.LANE)
    live_sp = int(torch.nn.functional.pad(tmax >= tmin, (0, p * stream.LANE - n))
                  .reshape(p, stream.LANE).any(1).sum())
    box_tests = float(plain["box_tests"].double().mean())
    tests = float(plain["tests"].double().mean())
    cull = cull_ops(sb, o, d, tmin, tmax, False)
    ops = cull + p * (box_tests * OPS_BOX + tests * OPS_TRI)
    nbytes = n * (28 + (1 if any_hit else 16)) + (sb.boxes.numel() + sb.tris.numel()) * 4
    work = dict(sub_packets=p, live_sub_packets=live_sp,
                candidates_per_sub_packet=float(plain["candidates"].double().mean()),
                pops_per_warp=float(plain["streamed"].double().mean()),
                max_pops_per_warp=int(plain["streamed"].max()),
                box_tests_per_sub_packet=box_tests, tests_per_sub_packet=tests,
                cull_ops=cull, ops=ops, bytes=nbytes)
    return work, bound(ops, nbytes)


def cull_ops(sb, o, d, tmin, tmax, count_only):
    """The box tests' operations on a ray set: for each sub-packet with a
    live ray, n_blocks tests of OPS_IBOX, OPS_IBOX_POINT where its rays
    have one direction, and for a count alone (K11) OPS_IBOX_STRADDLE where
    every axis straddles 0 and tcap0 >= 0."""
    from capsaicin_tpu_torch.ops import stream

    _, _, i_lo, i_hi, _, tcap0, live = stream._bounds(*stream._sub_packets(o, d, tmin, tmax))
    point = (i_lo == i_hi).all(1) & live
    straddle = ((i_lo < 0) & (i_hi > 0)).all(1) & (tcap0 >= 0) & live & bool(count_only)
    n_point, n_straddle = int(point.sum()), int(straddle.sum())
    n_rest = int(live.sum()) - n_point - n_straddle
    return sb.n_blocks * (n_point * OPS_IBOX_POINT + n_straddle * OPS_IBOX_STRADDLE
                          + n_rest * OPS_IBOX)


def compare_stream(report, calls, tris, tree7):
    """K10 and K11 on the full colonnade's 1080p rays (the four sets of
    compare_bvh): K10 against its plain version on a subsample of whole
    sub-packets and against K7 on all rays, at blocks of 32 and at blocks of
    8 (32,768 blocks, beyond the 16,384 of the first design's shared-memory
    list); K11 against its plain version on all rays; the bounce set
    balanced against unbalanced, and the session's sorted traces against
    the unsorted ones; K10's times at blocks of 8, 32, 64 and 128 beside
    K7's and K11's, and its bound from the plain version's work on the
    pixel-order sets and on the frame's own sorted sets."""
    import torch

    from capsaicin_tpu_torch.ops import bvh, stream
    from capsaicin_tpu_torch.render.traversal import make_stream_bounce_fns

    builds = {b: stream.build_stream_bvh(tris, b) for b in (STREAM_LARGE,) + STREAM_BLOCKS}
    acc = builds[stream.BLOCK_TRIS]
    resident = {}
    for any_hit in (False, True):
        info = stream.kernel_info(0, any_hit)
        resident[any_hit] = info["ctas_per_sm"] * info["sms"]
        check(info["shared_bytes"] <= stream.SHARED_BYTES <= stream.SHARED_CEILING,
              f"K10 static shared memory {info['shared_bytes']} B above its plan")
        print(f"K10 {'any-hit' if any_hit else 'closest'} build: {info['registers']} registers a "
              f"thread, {info['shared_bytes']} B shared memory a block (ceiling "
              f"{stream.SHARED_CEILING} B, whatever n_blocks), {info['local_bytes']} B spilled; "
              f"{info['ctas_per_sm']} blocks of 128 threads = {4 * info['ctas_per_sm']} warps "
              f"resident an SM on {info['sms']} SMs")
        report.setdefault("k10_build", {})["any_hit" if any_hit else "closest"] = info
    k11_build = stream.count_kernel_info(0)
    print(f"K11 build: {k11_build['registers']} registers a thread, {k11_build['local_bytes']} B "
          f"local, {k11_build['shared_bytes']} B static shared memory a block, "
          f"{k11_build['ctas_per_sm']} blocks = {k11_build['warps_per_sm']} warps resident an SM "
          f"({stream.COUNT_GROUP} sub-packets a block)")
    check(k11_build["local_bytes"] == 0, f"K11 uses {k11_build['local_bytes']} B of local memory")
    for b, sb in builds.items():
        plan = stream.launch_plan(sb.n_blocks, b, W * H, resident[False])
        print(f"colonnade stream blocks of {b}: {sb.n_blocks} blocks "
              f"({int((sb.boxes[:, 3] > 0).sum())} not empty); K10 at 1080p: grid "
              f"{plan['grid']}, shared {plan['shared_bytes']} B a block, scratch "
              f"{plan['scratch_bytes'] / 2**20:.1f} MiB")
    names = ("primary", "shadow", "bounce", "nee")
    per_set, errs = {}, []
    for name, (kind, o, d, tmin, tmax) in zip(names, calls):
        any_hit = kind == "any"
        n = o.shape[0]
        what = f"K10 {kind} ({name})"
        k7 = bvh.bvh_trace(tree7, o, d, tmin, tmax, any_hit)
        full, plain, sp, idx, plain_ms, err = hold_stream(what, acc, o, d, tmin, tmax, any_hit)
        errs.append(err)
        large = {}
        for b, sb in builds.items():
            if b in (acc.block_tris, STREAM_LARGE):
                got = full if sb is acc else hold_stream(
                    f"{what}, blocks of {b} ({sb.n_blocks} blocks)", sb, o, d, tmin, tmax,
                    any_hit)[0]
                if any_hit:
                    hold_any(f"{what}, blocks of {b}, vs K7, all rays", got, k7)
                else:
                    errs.append(hold_hits(f"{what}, blocks of {b}, vs K7, all rays", got, k7,
                                          hits_only=True))
        counts = stream.count_candidates(acc, o, d, tmin, tmax)
        counts_plain, count_plain_ms = timed(lambda: stream.stream_count_plain(acc, o, d, tmin, tmax))
        check(torch.equal(counts, counts_plain), f"K11 ({name}): counts differ from the plain version's")
        check(torch.equal(counts[sp].long(), plain["candidates"]),
              f"K11 ({name}): counts differ from the plain trace's candidates")
        large = builds[STREAM_LARGE]
        check(torch.equal(stream.count_candidates(large, o, d, tmin, tmax),
                          stream.stream_count_plain(large, o, d, tmin, tmax)),
              f"K11 ({name}), blocks of {STREAM_LARGE}: counts differ from the plain version's")
        times = {b: cuda_ms(lambda sb=sb: stream.stream_trace(sb, o, d, tmin, tmax, any_hit), 3)
                 for b, sb in builds.items()}
        k7_ms = cuda_ms(lambda: bvh.bvh_trace(tree7, o, d, tmin, tmax, any_hit), 3)
        k11_ms = cuda_ms(lambda: stream.count_candidates(acc, o, d, tmin, tmax), 20)
        work, b32 = stream_bound(acc, plain, o, d, tmin, tmax, any_hit)
        check(times[acc.block_tris] >= 0.95 * b32["bound_ms"],
              f"{what}: {times[acc.block_tris]} ms below 95% of its bound {b32['bound_ms']} ms")
        entry = dict(rays=n, live=int((tmax >= tmin).sum()), **work,
                     max_candidates=int(counts.max()), ms_by_block=times, k7_ms=k7_ms,
                     plain_ms=plain_ms, plain_rays=len(idx), count_ms=k11_ms,
                     count_plain_ms=count_plain_ms,
                     count_bound=bound(cull_ops(acc, o, d, tmin, tmax, True),
                                       n * 28 + work["sub_packets"] * 4 + acc.boxes.numel() * 4),
                     **b32)
        if name == "bounce":  # the session balances this set
            bal = stream.stream_closest(acc, o, d, tmin, tmax, balance=True)
            check(all(torch.equal(bal[k], x) for k, x in zip(("t", "u", "v", "prim"), full)),
                  f"{what}: the balanced trace gives other hits")
            entry["balanced_ms"] = cuda_ms(
                lambda: stream.stream_closest(acc, o, d, tmin, tmax, balance=True), 3)
        if name in ("bounce", "nee"):
            # the session's trace of this set: sorted by the 96-cell
            # direction key, the closest-hit one balanced; and K10 alone on
            # the sorted rays, balanced or not, with its bound there
            sorted_fn = make_stream_bounce_fns(acc)[1 if any_hit else 0]
            got = sorted_fn(o, d, tmin, tmax)
            got = got if any_hit else tuple(got[k] for k in ("t", "u", "v", "prim"))
            check(torch.equal(got, full) if any_hit else all(map(torch.equal, got, full)),
                  f"{what}: the session's sorted trace gives other hits")
            entry["session_trace_ms"] = cuda_ms(lambda: sorted_fn(o, d, tmin, tmax), 3)
            order, _ = bvh.sort_rays_for_traversal(o, d, dead=tmax < tmin, dir_grid=4)
            oo, od, otm = o[order].contiguous(), d[order].contiguous(), tmax[order].contiguous()
            sorted_counts = stream.count_candidates(acc, oo, od, tmin, otm)
            check(torch.equal(sorted_counts, stream.stream_count_plain(acc, oo, od, tmin, otm)),
                  f"K11 ({name}, sorted): counts differ from the plain version's")
            if not any_hit:  # the frame's own count: the sorted bounce set
                entry["sorted_count_ms"] = cuda_ms(
                    lambda: stream.count_candidates(acc, oo, od, tmin, otm), 20)
            entry["sorted_candidates_per_sub_packet"] = float(sorted_counts.double().mean())
            entry["sorted_max_candidates"] = int(sorted_counts.max())
            _, splain, _, _, _, _ = hold_stream(f"{what}, sorted", acc, oo, od, tmin, otm, any_hit)
            swork, sbound = stream_bound(acc, splain, oo, od, tmin, otm, any_hit)
            entry["sorted"] = dict(swork, **sbound)
            entry["sorted_ms"] = cuda_ms(
                lambda: stream.stream_trace(acc, oo, od, tmin, otm, any_hit), 3)
            frame_ms = entry["sorted_ms"]
            if not any_hit:
                sorted_order = stream.balance_order(sorted_counts)
                entry["sorted_balanced_ms"] = frame_ms = cuda_ms(
                    lambda: stream.stream_trace(acc, oo, od, tmin, otm, False, sorted_order), 3)
            check(frame_ms >= 0.95 * sbound["bound_ms"],
                  f"{what}, sorted: {frame_ms} ms below 95% of its bound {sbound['bound_ms']} ms")
        per_set[name] = entry
        print(f"{what}: {n} rays, {work['sub_packets']} sub-packets ({work['live_sub_packets']} with "
              f"a live ray); {work['candidates_per_sub_packet']:.1f} candidate blocks, "
              f"{work['pops_per_warp']:.1f} pops a warp (max {work['max_pops_per_warp']}), "
              f"{work['box_tests_per_sub_packet']:.0f} box tests and "
              f"{work['tests_per_sub_packet']:.0f} triangle tests per sub-packet (plain, "
              f"{len(idx)} rays); K10 ms by block {times} (K7 {k7_ms:.4f}); plain {plain_ms:.1f} ms; "
              f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}); K11 {k11_ms:.4f} ms (plain "
              f"{count_plain_ms:.1f}, bound {entry['count_bound']['bound_ms']:.4f}); max "
              f"candidates {entry['max_candidates']}"
              + (f"; balanced {entry['balanced_ms']:.4f} ms" if "balanced_ms" in entry else "")
              + (f"; sorted (dir_grid 4): {entry['sorted_candidates_per_sub_packet']:.1f} "
                 f"candidates (max {entry['sorted_max_candidates']}), "
                 f"{entry['sorted']['pops_per_warp']:.1f} pops a warp, "
                 f"{entry['sorted']['box_tests_per_sub_packet']:.0f} box and "
                 f"{entry['sorted']['tests_per_sub_packet']:.0f} triangle tests per sub-packet, "
                 f"bound {entry['sorted']['bound_ms']:.4f} ms; K10 {entry['sorted_ms']:.4f} ms"
                 + (f", balanced {entry['sorted_balanced_ms']:.4f} ms"
                    if "sorted_balanced_ms" in entry else "")
                 + f"; the session's sort and trace {entry['session_trace_ms']:.4f} ms"
                 + (f"; K11 on the sorted set (the frame's call) {entry['sorted_count_ms']:.4f} ms"
                    if "sorted_count_ms" in entry else "")
                 if "sorted_ms" in entry else ""))
    mean = lambda key: sum(e[key] for e in per_set.values()) / len(per_set)  # noqa: E731
    report["stream_trace"] = dict(
        max_abs_err=max(errs), ms=sum(e["ms_by_block"][acc.block_tris] for e in per_set.values())
        / len(per_set), plain_ms=mean("plain_ms"), plain_rays=SUBSAMPLE, bound_ms=mean("bound_ms"),
        bound_by=per_set["bounce"]["bound_by"], library_ms=None, block_tris=acc.block_tris,
        build=report.pop("k10_build"), per_set=per_set)
    report["stream_count"] = dict(
        max_abs_err=0.0, ms=mean("count_ms"), plain_ms=mean("count_plain_ms"),
        bound_ms=sum(e["count_bound"]["bound_ms"] for e in per_set.values()) / len(per_set),
        bound_by=per_set["bounce"]["count_bound"]["bound_by"], library_ms=None,
        frame_call_ms=per_set["bounce"]["sorted_count_ms"], build=k11_build)


def compare_microstep(report):
    """K9's five variants: exactly its plain walk at 40 steps and at the
    benchmark's 4096, timed at 64 packets x 4096 steps (the counts are its
    path's launches); each variant's build."""
    import torch

    from capsaicin_tpu_torch import kernels as K
    from capsaicin_tpu_torch.tools import microstep as msk

    packets, steps = 64, msk.STEPS
    rays, nodes = msk.make_inputs(packets, device="cuda")
    builds = {}
    for variant in msk.VARIANTS:
        check(torch.equal(msk.microstep(variant, rays, nodes, 40),
                          msk.microstep_plain(variant, rays, nodes, 40)),
              f"K9 {variant}: out differs from the plain walk at 40 steps")
        info = builds[variant] = msk.kernel_info(variant)
        print(f"microstep {variant} build: {info['registers']} registers a thread, "
              f"{info['local_bytes']} B local, {info['dynamic_shared_bytes']} B dynamic shared "
              f"memory a block, {info['ctas_per_sm']} blocks = {info['warps_per_sm']} warps "
              f"resident an SM")
        check(info["local_bytes"] == 0, f"K9 {variant} uses {info['local_bytes']} B of local memory")
    outs = {variant: msk.microstep(variant, rays, nodes, steps) for variant in msk.VARIANTS}
    K.reset_counts()
    variants = {}
    for variant in msk.VARIANTS:
        ms = cuda_ms(lambda v=variant: msk.microstep(v, rays, nodes, steps), 5)
        variants[variant] = dict(ms=ms, **msk.step_times(ms, packets, steps))
    launches = msk.K9.launches
    for variant in msk.VARIANTS:
        want, variants[variant]["plain_ms"] = timed(
            lambda v=variant: msk.microstep_plain(v, rays, nodes, steps))
        check(torch.equal(outs[variant], want),
              f"K9 {variant}: out differs from the plain walk at {steps} steps")
        print(f"K9 {variant}: {variants[variant]['ms']:.4f} ms for {packets} packets x {steps} "
              f"steps = {variants[variant]['ns_per_step']:.3f} ns/step "
              f"({variants[variant]['ns_per_walk_step']:.2f} ns per step of one packet's walk); "
              f"plain {variants[variant]['plain_ms']:.1f} ms; out equal to the plain walk's at 40 "
              f"and {steps} steps")
    full = variants["full"]
    report["microstep"] = dict(
        max_abs_err=0.0, ms=full["ms"], plain_ms=full["plain_ms"], variants=variants,
        build=builds,
        **bound(packets * msk.PACKET * steps * OPS_MICROSTEP,
                rays.numel() * 4 + nodes.numel() * 4 + packets * msk.PACKET * 4))
    return launches


def run_config(name, cfg, frames, per_frame):
    """One Cornell configuration through the session API: a warm-up frame,
    then `frames` frames (render_loop with accumulate for a loop config)
    with the counts reset just before; checks launches and the image."""
    import torch

    from capsaicin_tpu_torch import kernels as K

    cfg = dict(cfg)
    loop = cfg.pop("loop", None)
    width, height = cfg["width"], cfg["height"]
    torch.cuda.reset_peak_memory_stats()
    session = make_session(**cfg, device="cuda")
    session.render_async()
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    if loop:
        display = session.render_loop(loop, chunk=loop, accumulate=True)
    else:
        for _ in range(frames):
            display = session.render_async()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / frames
    launches = {k.name: k.launches for k in K.REGISTRY}
    check_launches(launches, per_frame, frames, name)
    check_image(display.cpu().numpy(), (height, width, 3), name,
                sky_corner=not cfg.get("scene", "").startswith("colonnade"))
    o = session.options
    rays = rays_per_frame(width, height, o.num_diffuse_bounces, o.lowres_indirect, o.spp)
    print(f"{name} {width}x{height}: {ms:.2f} ms/frame over {frames} frames = "
          f"{rays / ms / 1e3:.2f} Mrays/s ({rays} rays/frame); set-up {session.setup_s:.3f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from capsaicin_tpu_torch import kernels as K
    # importing registers the kernels: K1, K2, K3-K6, K7, K8, K10, K11, K9
    from capsaicin_tpu_torch.ops import static  # noqa: F401
    from capsaicin_tpu_torch.ops import lookup, stencil  # noqa: F401
    from capsaicin_tpu_torch.ops import bvh, brute, stream  # noqa: F401
    from capsaicin_tpu_torch.tools import microstep  # noqa: F401

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    mufu, sms, clock = mufu_rate()
    print(f"bounds: {HBM_BYTES_PER_S:.3g} B/s, {FP32_OPS_PER_S:.3g} float32 op/s, "
          f"{mufu:.4g} MUFU op/s ({sms} SMs x {MUFU_PER_SM_CLOCK} x {clock:g} MHz)")
    print(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    # RenderOptions' EAW defaults come from these; every config here sets
    # its own (make_session)
    print("CAPSAICIN_EAW_FUSED=" + repr(os.environ.get("CAPSAICIN_EAW_FUSED")) +
          " CAPSAICIN_EAW_BF16=" + repr(os.environ.get("CAPSAICIN_EAW_BF16")))
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    K.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(k.name for k in K.REGISTRY))

    # 3. every kernel against its plain version at the 1080p frame's shapes
    session = make_session(W, H, "cuda")
    report = {}
    compare_trace(session, report)
    compare_stencils(session, report)
    calls, tris, tree7 = compare_bvh(report)
    compare_stream(report, calls, tris, tree7)
    del calls, tris, tree7
    microstep_launches = compare_microstep(report)

    # 4. the flagship, gi1080 with default options, through the session
    # API, counting launches; then PR 1's gather=False path, shortly
    session.reset()
    torch.cuda.synchronize()
    K.reset_counts()
    t_first = time.perf_counter()
    session.render_async()
    torch.cuda.synchronize()
    t_steady = time.perf_counter()
    for _ in range(FRAMES - 1):
        display = session.render_async()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    path_launches = {k.name: k.launches for k in K.REGISTRY}
    print(f"launches over {FRAMES} frames: {path_launches}")
    check_launches(path_launches, FLAGSHIP_LAUNCHES, FRAMES, "gi1080")
    check_image(display.cpu().numpy(), (H, W, 3), "gi1080")
    ms = (t_end - t_steady) * 1e3 / (FRAMES - 1)
    rays = rays_per_frame(W, H, session.options.num_diffuse_bounces)
    print(f"gi1080 1080p frame: first {(t_steady - t_first) * 1e3:.2f} ms, then {ms:.2f} "
          f"ms/frame over {FRAMES - 1} frames = {rays / ms / 1e3:.2f} Mrays/s "
          f"({rays} rays/frame)")
    del session
    run_config("gi1080_no_gather", dict(width=W, height=H, options=dict(gather=False)), 3,
               dict(FLAGSHIP_LAUNCHES, spatial_gather=0))

    # 4b. the other configurations of bench.py through the session API
    path_launches["microstep"] = microstep_launches
    for name, cfg, frames, per_frame in CONFIGS:
        launches = run_config(name, cfg, frames, per_frame)
        for kernel, path in PATH_OF.items():
            if path == name:
                path_launches[kernel] = launches[kernel]
    for name, n in path_launches.items():
        check(n > 0, f"{name} was never launched on its path")

    # 5. the kernel path against the CPU path, end to end
    for what, cfg in (("default", dict()),
                      ("lowres_indirect spp=2, textured",
                       dict(options=dict(lowres_indirect=True, spp=2), scene="textured")),
                      ('eaw_fused="1" eaw_bf16', dict(options=dict(eaw_fused="1", eaw_bf16=True))),
                      ("colonnade(target_tris=20000), bvh",
                       dict(scene="colonnade20k", traversal="bvh")),
                      ("colonnade(target_tris=20000), stream",
                       dict(scene="colonnade20k", traversal="stream"))):
        images = {}
        for device in ("cuda", "cpu"):
            small = make_session(SMALL, SMALL, device, **cfg)
            for _ in range(SMALL_FRAMES):
                images[device] = small.render()
        rmse = float(np.sqrt(np.mean((images["cuda"] - images["cpu"]) ** 2)))
        print(f"{SMALL}x{SMALL} {what}, {SMALL_FRAMES} frames: display RMSE CUDA vs CPU "
              f"{rmse:.3g}")
        check(rmse <= RMSE_BAR, f"{what}: display RMSE {rmse} above {RMSE_BAR}")

    kernels = [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=path_launches[k.name], path=PATH_OF.get(k.name, "gi1080"),
             **report[k.name])
        for k in K.REGISTRY
    ]
    check(len(kernels) == 11, f"{len(kernels)} kernels registered, expected 11")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        check(all(key in k for key in keys), f"{k['name']}: missing {set(keys) - set(k)}")
        # a time under the bound means the count of work is wrong
        check(k["ms"] >= 0.95 * k["bound_ms"],
              f"{k['name']}: {k['ms']} ms below 95% of its bound {k['bound_ms']} ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
