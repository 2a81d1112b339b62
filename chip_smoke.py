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
its out exactly the plain walk's at 40 and 4096 steps), holds the
feedback fetch (K12) bit-equal to its plain version on every lane of the
bounce hits of 1080p offline64 frames (the Cornell box and the colonnade,
16 launches a frame) and times it with the L2 flushed, renders the
Cornell box at 1920x1080 with default options through the session API and
checks that the frame went through every kernel, renders the other
configurations of bench.py the same way (the colonnade through the BVH
and through the stream at blocks of 32, 64 and 128), holds small CUDA
renders against the CPU path, then drives the public API and the viewer:
the 249,190-triangle textured colonnade written as OBJ, MTL and PNGs and
read back through load_scene_obj on the C++ loader (its meshes held to
the Python parser's, both textures in the atlas), rendered at 1920x1080
through the BVH and held to the directly built scene; add_scene of two
OBJs on K1 and a save_state resume; the CLI at 1080p with --timings, the
gi1080 per-pass table, and a ViewerState driven through keys, the mouse,
every panel option and a resize, each frame's launches checked; then
renders on meshes of n x cuda:0 (RenderSession(mesh=...): gi1080 on 2 and
8 row blocks and the colonnade through the BVH and the stream on 2, each
held to the unsharded frame with every kernel launched n times its
per-frame count, the EAW chain per block with its halo on 8 blocks of a
1920x272 crop, ms/frame on 1, 2 and 8 blocks); last the plain-torch
traversals, wavefront and cull, on the full colonnade (dense_phase: its
four 1080p ray sets' subsamples held to K7, 1080p frames held to the BVH
frame with their launches, the cull frames on 2 x cuda:0). Every
kernel's time stands beside its
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
# K12, a lane: the reprojection (dot products, the normalisations, the
# plane intersection, uv and xy) 70, the bilinear blend 21, the indices,
# weights and depth test 19; MUFU: 10 divisions and 2 sqrt (a reciprocal or
# root each). Bytes: the hit in, colour and flag out, and each history
# pixel a corner reads (12 B) and each depth a point fetch reads (4 B) once.
OPS_FETCH = 110
MUFU_FETCH = 12
FETCH_LANE_BYTES = 25
FETCH_SETS = (("cornell", "auto"), ("colonnade", "bvh"))  # offline64's scenes
FETCH_OPTIONS = dict(num_diffuse_bounces=4, spp=4)  # offline64's frame: 16 fetches
FLUSH_BYTES = 64 << 20  # larger than the H100's 50 MB L2
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
                     "eaw_disocclusion": 1, "eaw_stage": 4, "eaw_pair": 0, "feedback_fetch": 1}
# The other Cornell configurations of bench.py:113-160, as (name, size and
# options, frames timed, per-frame launches each fixes)
DIRECT512 = dict(width=512, height=512, options=dict(
    num_diffuse_bounces=0, output=1, taa=False, denoise=False, gather=False))
DIRECT512_LAUNCHES = dict(static_trace=2, hit_attributes=2, spatial_gather=0,
                          eaw_disocclusion=0, eaw_stage=0, eaw_pair=0, feedback_fetch=0)
PROGRESSIVE = dict(width=1024, height=1024, options=dict(lowres_indirect=True))
TEXTURED = dict(width=1024, height=1024, scene="textured")
CONFIGS = [
    ("direct512", DIRECT512, 8, DIRECT512_LAUNCHES),
    ("direct512_loop16", dict(DIRECT512, loop=16), 16, DIRECT512_LAUNCHES),
    ("gi1080x4", dict(width=W, height=H, options=dict(num_diffuse_bounces=4)), 8,
     dict(static_trace=10, hit_attributes=6, spatial_gather=1, eaw_stage=4, eaw_pair=0,
          feedback_fetch=4)),
    ("gi1080x4_spp64", dict(width=W, height=H, options=dict(num_diffuse_bounces=4, spp=64)), 4,
     dict(static_trace=514, hit_attributes=321, spatial_gather=1, eaw_stage=4,
          feedback_fetch=256)),
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
# The plain-torch traversals' phase (dense_phase): whole blocks of 128 rays
# in each set's subsample, 1080p frames a mode (the wavefront's cut to one:
# about a minute a frame on the H100, PERF.md) and mesh frames, and the
# launches of each frame (its tracing is plain torch)
DENSE_BLOCKS = SUBSAMPLE // 128
DENSE_FRAMES = {"wavefront": 1, "cull": 3}
DENSE_MESH_FRAMES = 2
DENSE_LAUNCHES = dict(hit_attributes=3, eaw_disocclusion=1, eaw_stage=4, spatial_gather=1,
                      static_trace=0, brute_trace=0, bvh_trace=0, stream_trace=0, stream_count=0)
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
                 traversal="auto", stream_block_tris=None, mesh=None):
    """A session with the scene uploaded (none for scene=None, with the
    Cornell camera), on `mesh` where given; its set_scene time (build and
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
                            stream_block_tris=stream_block_tris, mesh=mesh)
    session.set_camera(make_camera("colonnade" if scene and scene.startswith("colonnade")
                                   else "cornell", width, height))
    if scene is None:
        return session
    host = host_scene(scene)
    t0 = time.perf_counter()
    session.set_scene(quantize_atlas(host) if atlas_u32 else host)
    if torch.device(device).type == "cuda":
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


def cold_ms(fn, iters):
    """Device ms of one call of `fn` with the L2 cache flushed before it
    (a 64 MB write between calls, outside the events): the mean of `iters`
    calls after a warm-up."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def fetch_reads(p, camera, width, height):
    """(history pixels the four bilinear corners read, depths the point
    fetch reads): the distinct pixels of feedback_fetch_plain's indices."""
    import torch

    from capsaicin_tpu_torch.ops import camera as cam
    from capsaicin_tpu_torch.ops import resample

    xy = resample.uv_to_xy(cam.calculate_image_plane_uv(camera, p), (width, height))
    fl = torch.floor(xy - 0.5)
    bx = resample.pixel_index(fl[:, 0], -1, width - 1).clamp_min(0)
    by = resample.pixel_index(fl[:, 1], -1, height - 1).clamp_min(0)
    x1, y1 = (bx + 1) % width, (by + 1) % height
    corners = torch.cat([by * width + bx, by * width + x1, y1 * width + bx, y1 * width + x1])
    pl = torch.floor(xy)
    point = (resample.pixel_index(pl[:, 1], 0, height - 1) * width
             + resample.pixel_index(pl[:, 0], 0, width - 1))
    return int(torch.unique(corners).numel()), int(torch.unique(point).numel())


def compare_feedback(report):
    """K12 on the feedback fetches of an offline64 frame (1920x1080, 4
    bounces, spp 4: 16 fetches) of the Cornell box and of the full
    colonnade through the BVH, the third after a reset: its launches 16 a
    frame; on the fetches of spp sample 0 (bounces 1-4) bit-equal to its
    plain version on every lane, timed with the L2 flushed (and warm) beside
    its bound and the plain (eager) fetch's time; its build."""
    import torch

    from capsaicin_tpu_torch.ops import feedback

    real = feedback.feedback_fetch
    per_set = {}
    per_frame = FETCH_OPTIONS["num_diffuse_bounces"] * FETCH_OPTIONS["spp"]
    for scene, traversal in FETCH_SETS:
        session = make_session(W, H, "cuda", options=FETCH_OPTIONS, scene=scene,
                               traversal=traversal)
        for _ in range(2):
            session.render_async()
        calls = []

        def record(p, *rest):
            if len(calls) < FETCH_OPTIONS["num_diffuse_bounces"]:
                calls.append((p.clone(),) + rest)
            return real(p, *rest)

        torch.cuda.synchronize()
        before = feedback.K12.launches
        feedback.feedback_fetch = record  # passes.indirect_gi calls it through the module
        try:
            session.render_async()
            torch.cuda.synchronize()
        finally:
            feedback.feedback_fetch = real
        launches = feedback.K12.launches - before
        check(launches == per_frame, f"K12: {launches} launches in an offline64 frame ({scene}), "
                                     f"expected {per_frame}")
        del session
        for bounce, args in enumerate(calls, 1):
            p, camera = args[0], args[1]
            n = p.shape[0]
            got = feedback.feedback_fetch(*args)
            want = feedback.feedback_fetch_plain(*args)
            bad = ((got[0].view(torch.int32) != want[0].view(torch.int32)).any(-1)
                   | (got[1] != want[1]))
            mismatches = int(bad.sum())
            pixels, depths = fetch_reads(p, camera, W, H)
            entry = dict(
                lanes=n, mismatches=mismatches, disoccluded=int(got[1].sum()),
                history_pixels=pixels, depth_pixels=depths,
                ms=cold_ms(lambda: feedback.feedback_fetch(*args), 20),
                warm_ms=cuda_ms(lambda: feedback.feedback_fetch(*args), 20),
                plain_ms=cuda_ms(lambda: feedback.feedback_fetch_plain(*args), 3),
                **bound(n * OPS_FETCH, n * FETCH_LANE_BYTES + pixels * 12 + depths * 4,
                        n * MUFU_FETCH))
            per_set[f"{scene}_bounce{bounce}"] = entry
            print(f"K12 {scene} bounce {bounce}: {n} lanes, {entry['disoccluded']} disoccluded, "
                  f"{pixels} history pixels read; mismatches against its plain version "
                  f"{mismatches}; {entry['ms']:.4f} ms cold, {entry['warm_ms']:.4f} warm (plain "
                  f"{entry['plain_ms']:.4f} ms), bound {entry['bound_ms']:.4f} ms "
                  f"({entry['bound_term']})")
            check(mismatches == 0, f"K12 {scene} bounce {bounce}: {mismatches} lanes differ "
                                   "from its plain version")
            check(entry["ms"] >= 0.95 * entry["bound_ms"],
                  f"K12 {scene} bounce {bounce}: {entry['ms']} ms below 95% of its bound "
                  f"{entry['bound_ms']} ms")
        del calls
    info = feedback.kernel_info(torch.cuda.current_device())
    print(f"K12 build: {info['registers']} registers a thread, {info['local_bytes']} B local, "
          f"{info['shared_bytes']} B shared a block, {info['ctas_per_sm']} blocks = "
          f"{info['warps_per_sm']} warps resident an SM")
    check(info["local_bytes"] == 0, f"K12 uses {info['local_bytes']} B of local memory")
    mean = lambda key: sum(e[key] for e in per_set.values()) / len(per_set)  # noqa: E731
    report["feedback_fetch"] = dict(
        max_abs_err=0.0, ms=mean("ms"), warm_ms=mean("warm_ms"), plain_ms=mean("plain_ms"),
        bound_ms=mean("bound_ms"), bound_by="bytes", library_ms=None, build=info,
        per_set=per_set)


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


def variant_launches(o) -> dict:
    """Per-frame launches of a Cornell frame under RenderOptions `o`
    (spp 1, eaw_fused "0"): K1 traces primary and direct shadow rays and
    a bounce and its NEE ray per bounce, K2 fetches twice and once a
    bounce; K5 runs with gather, K3 and K4 (2 or 4 stages) with denoise."""
    b = o.num_diffuse_bounces
    return dict(static_trace=2 + 2 * b, hit_attributes=2 + b, spatial_gather=int(o.gather),
                eaw_disocclusion=int(o.denoise), eaw_stage=(4 if o.eaw5 else 2) * int(o.denoise),
                eaw_pair=0, bvh_trace=0, feedback_fetch=b * int(o.gbuffer_feedback))


def ingest_phase(tmp, smi):
    """The textured colonnade (249,190 triangles, two textured materials)
    written as OBJ + MTL + two PNGs, read back through load_scene_obj on
    the C++ loader (its meshes held to the Python parser's), rendered at
    1920x1080 through traversal "auto" (the BVH, K7) and held against the
    same meshes given to build_scene directly."""
    import numpy as np
    import torch
    from PIL import Image

    from capsaicin_tpu_torch import kernels as K
    from capsaicin_tpu_torch import native
    from capsaicin_tpu_torch.scene import build_scene, obj_loader, textures
    from capsaicin_tpu_torch.scene.procedural import colonnade_textured, make_camera, write_obj
    from capsaicin_tpu_torch.scene.scene import load_scene_obj

    t_phase = time.perf_counter()
    meshes, images = colonnade_textured()
    obj = os.path.join(tmp, "colonnade_textured.obj")
    t0 = time.perf_counter()
    write_obj(obj, meshes)
    for name, img in images.items():
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8), "RGBA").save(
            os.path.join(tmp, name))
    write_s = time.perf_counter() - t0
    check(native.available(), "ingest: the C++ OBJ loader did not build")
    loads = native.loads
    t0 = time.perf_counter()
    scene = load_scene_obj(obj, texture_dir=tmp)
    load_s = time.perf_counter() - t0
    check(native.loads == loads + 1, "ingest: load_scene_obj did not take the C++ loader")
    t0 = time.perf_counter()
    parsed, _ = obj_loader.load_obj(obj)
    parse_s = time.perf_counter() - t0
    names = {m.texture_name for m in parsed if m.texture_name}
    t0 = time.perf_counter()
    build_scene(parsed, {n: textures.load_texture(n, tmp) for n in names})
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python, _ = obj_loader.load_obj(obj, force_python=True)
    python_s = time.perf_counter() - t0
    check([m.name for m in parsed] == [m.name for m in python], "ingest: mesh names differ")
    for a, b in zip(parsed, python):
        check(a.indices == b.indices and a.texture_name == b.texture_name,
              f"ingest: mesh {a.name} differs from the Python parser's")
        for f in ("positions", "normals", "texcoords"):
            err = float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())
            check(err <= 1e-6, f"ingest: {a.name} {f} differ by {err} from the Python parser's")
    check(scene.num_triangles == 249_190, f"ingest: {scene.num_triangles} triangles")
    # both textures loaded: a 1x1 fallback would shrink the tiles
    check(scene.atlas.shape == (2, 128, 128, 16) and sorted(scene.atlas_size.tolist())
          == [[96, 48], [128, 128]], f"ingest: atlas {scene.atlas.shape} "
          f"{scene.atlas_size.tolist()}, expected the 128x128 checker and 48x96 stripes")
    print(f"ingest: {scene.num_triangles} triangles, atlas {tuple(scene.atlas.shape)}; write_obj "
          f"{write_s:.3f} s ({os.path.getsize(obj) / 2**20:.1f} MiB); load_scene_obj "
          f"{load_s:.3f} s; C++ parse {parse_s:.3f} s, build_scene {build_s:.3f} s; "
          f"Python parse {python_s:.3f} s; {smi}")

    displays = {}
    for what, host in (("obj", scene), ("direct", build_scene(meshes, images))):
        session = make_session(W, H, "cuda", scene=None)
        session.set_camera(make_camera("colonnade", W, H))
        t0 = time.perf_counter()
        session.set_scene(host)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        session.render_async()
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            display = session.render_async()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FRAMES
        launches = {k.name: k.launches for k in K.REGISTRY}
        displays[what] = display.cpu().numpy()
        # traversal "auto" takes the BVH above 128 triangles
        check_launches(launches, dict(bvh_trace=4, hit_attributes=3, static_trace=0), FRAMES,
                       f"ingest {what}")
        check_image(displays[what], (H, W, 3), f"ingest {what}", sky_corner=False)
        print(f"ingest {what}: textured colonnade {W}x{H}, traversal auto: {ms:.2f} ms/frame "
              f"over {FRAMES} frames; set_scene {setup_s:.3f} s; launches {launches}; {smi}")
        del session
    rmse = float(np.sqrt(np.mean((displays["obj"] - displays["direct"]) ** 2)))
    print(f"ingest: display RMSE, OBJ-loaded against build_scene of the meshes: {rmse:.3g}")
    check(rmse <= RMSE_BAR, f"ingest: display RMSE {rmse} above {RMSE_BAR}")
    print(f"phase ingest: {time.perf_counter() - t_phase:.1f} s")


def session_phase(tmp, smi):
    """A 1920x1080 Cornell session loaded from OBJ, add_scene of a second
    OBJ (52 triangles: K1 carries it), save_state after 4 frames, and the
    resume in a fresh session held to the first session's frames."""
    import dataclasses

    import numpy as np
    import torch

    from capsaicin_tpu_torch import kernels as K
    from capsaicin_tpu_torch.scene.procedural import cornell_box, write_obj
    from capsaicin_tpu_torch.scene.scene import load_scene_obj

    t_phase = time.perf_counter()
    box = cornell_box()
    moved = [dataclasses.replace(m, positions=list(
        (np.asarray(m.positions, np.float32).reshape(-1, 3) + np.float32([0.4, 0, 0.3]))
        .reshape(-1))) for m in box if m.name == "tallBox"]
    paths = [os.path.join(tmp, "cornell.obj"), os.path.join(tmp, "tallbox.obj")]
    write_obj(paths[0], box)
    write_obj(paths[1], moved)

    def loaded():
        session = make_session(W, H, "cuda", scene=None)
        for path in paths:
            session.add_scene(load_scene_obj(path))
        return session

    session = loaded()
    check(session.scene_host.num_triangles == 52, "session: add_scene gave "
          f"{session.scene_host.num_triangles} triangles, expected 52")
    K.reset_counts()
    for _ in range(4):
        session.render_async()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in K.REGISTRY}
    check_launches(launches, dict(FLAGSHIP_LAUNCHES, bvh_trace=0), 4, "session add_scene")
    state_path = os.path.join(tmp, "state.npz")
    session.save_state(state_path)
    for _ in range(4):
        want = session.render()
    resumed = loaded()
    resumed.load_state(state_path)
    check(resumed.state.frame_count == 4, "session: resumed frame count")
    for _ in range(4):
        got = resumed.render()
    err = float(np.abs(got - want).max())
    print(f"session: add_scene of 2 OBJs, 52 triangles through K1 ({launches['static_trace']} "
          f"launches in 4 frames); the resume after 4 frames, 4 more: max abs difference "
          f"{err:.3g}; {smi}")
    check(err <= 1e-6, f"session: resumed frames differ by {err}")
    print(f"phase session: {time.perf_counter() - t_phase:.1f} s")


def viewer_phase(tmp, smi):
    """The CLI at 1920x1080 on the card with --timings, the per-pass table
    of the gi1080 frame (the reference's timer names; the passes add up to
    at most the whole frame), and a ViewerState driven through keys, the
    mouse, every panel option and a resize, each frame's launches those of
    its variant."""
    import numpy as np
    import torch
    from PIL import Image

    from capsaicin_tpu_torch import kernels as K
    from capsaicin_tpu_torch.render.profiling import PASS_NAMES
    from capsaicin_tpu_torch.viewer import cli, web

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "cli.png")
    check(cli.main(["--scene", "cornell", "--width", str(W), "--height", str(H), "--frames",
                    str(FRAMES), "--timings", "--out", out]) == 0, "viewer: the CLI failed")
    with Image.open(out) as img:
        check(img.size == (W, H), f"viewer: the CLI wrote a {img.size} image")

    session = make_session(W, H, "cuda")
    for _ in range(4):
        session.render_async()
    for method in ("inframe", "isolated"):
        table = session.measure_pass_timings(method=method)
        check(list(table) == list(PASS_NAMES) + ["whole frame"],
              f"viewer: timings keys {list(table)}")
        check(all(v >= 0.0 for v in table.values()), f"viewer: a negative time in {table}")
        passes_s = sum(table[k] for k in PASS_NAMES)
        if method == "inframe":
            check(passes_s <= table["whole frame"] * 1.05,
                  f"viewer: passes {passes_s} s above the whole frame {table['whole frame']} s")
        print(f"viewer: gi1080 measure_pass_timings({method!r}), ms: "
              + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in table.items())
              + f"; passes sum {passes_s * 1e3:.3f}; {smi}")

    state = web.ViewerState(session)
    steps = [dict(keys=["w"]), dict(keys=["a", "e"]), dict(keys=["s"]), dict(keys=["d", "q"]),
             dict(dx=12.0), dict(dx=-30.0, dy=8.0), dict(dy=-5.0),
             dict(settings_updates={"exposure": 0.8, "eaw_luma_sigma": 2.0})]
    steps += [dict(option_updates={"output": m}) for m in (1, 2, 3, 0)]
    steps += [dict(option_updates={"num_diffuse_bounces": b}) for b in (0, 2, 1)]
    for name in ("denoise", "eaw5", "gather", "taa"):
        steps += [dict(option_updates={name: False}), dict(option_updates={name: True})]
    steps += [dict(resize=[1280, 720]), dict(keys=["w"], dx=4.0)]
    t0 = time.perf_counter()
    for step in steps:
        K.reset_counts()
        img, _, _ = state.step(step.get("keys", []), step.get("dx", 0.0), step.get("dy", 0.0),
                               step.get("settings_updates"), step.get("option_updates"),
                               step.get("resize"))
        launches = {k.name: k.launches for k in K.REGISTRY}
        check_launches(launches, variant_launches(session.options), 1, f"viewer step {step}")
        check(img.shape == (session.height, session.width, 3) and bool(np.isfinite(img).all()),
              f"viewer step {step}: image {img.shape}, finite {np.isfinite(img).all()}")
    if session._bg_thread is not None:
        session._bg_thread.join(timeout=60)
    check((session.width, session.height) == (1280, 720), "viewer: resize")
    print(f"viewer: {len(steps)} ViewerState steps (keys, mouse, knobs, every panel option, a "
          f"resize to 1280x720) in {time.perf_counter() - t0:.2f} s, launches as each variant's")
    print(f"phase viewer: {time.perf_counter() - t_phase:.1f} s")


def mesh_phase(smi) -> dict:
    """Multi-device rendering on meshes of n x cuda:0 (one card: the cost
    of sharding, not a scaling): gi1080 on 2 and 8 row blocks, 3 frames
    against the unsharded session, the third with a camera whose drift
    passes 0.01 px in some blocks only (so the static-camera test must be
    the mesh's), and gi1080_eaw_fused1 on 2 blocks, 1 frame (K6); each
    kernel launched n times its per-frame count. The EAW chain per block of
    a 1920x272 crop on 8 blocks (32 and 36 rows against its reach of 35:
    multi-hop) held to the unsharded chain. The colonnade through the BVH
    and through the stream on 2 blocks, 2 frames against the unsharded
    session, with the primary set's differing hit ids. Every display but
    the stream's is the unsharded one bit for bit; the stream's bounce
    sub-packets differ per block (exact ties may differ), so it is held
    to display RMSE 1e-3. ms/frame of gi1080 unsharded and on 1, 2 and 8
    blocks. Returns the launches of the checked mesh frames (its path)."""
    import numpy as np
    import torch

    from capsaicin_tpu_torch import kernels as K
    from capsaicin_tpu_torch.ops import mathops, stencil
    from capsaicin_tpu_torch.ops.camera import tilted
    from capsaicin_tpu_torch.parallel import make_mesh
    from capsaicin_tpu_torch.parallel import sharding as sh
    from capsaicin_tpu_torch.render import passes
    from capsaicin_tpu_torch.render.settings import RenderOptions

    t_phase = time.perf_counter()
    path = {k.name: 0 for k in K.REGISTRY}

    def counted(fn):
        """fn() with the counts set to 0 before it; (its result, the launches)."""
        K.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in K.REGISTRY}
        for k, v in launches.items():
            path[k] += v
        return out, launches

    def compare(what, got, want, exact=True):
        diff = np.abs(got.astype(np.float64) - want)
        rmse = float(np.sqrt(np.mean(diff ** 2)))
        differ = int((diff > 0).any(-1).sum())
        print(f"mesh {what}: display max abs difference {diff.max():.3g}, RMSE {rmse:.3g}, "
              f"{differ} differing pixels")
        check(bool(np.isfinite(got).all()), f"mesh {what}: non-finite pixels")
        check(rmse <= RMSE_BAR, f"mesh {what}: display RMSE {rmse} above {RMSE_BAR}")
        check(not exact or differ == 0, f"mesh {what}: {differ} pixels differ")

    device = "cuda:0"

    def shards(n):
        return make_mesh([device] * n)

    # gi1080 on 2 and 8 blocks against the unsharded frames
    ref = make_session(W, H, device)
    cams = [ref.camera, ref.camera, tilted(ref.camera, H)]
    want = []
    for cam in cams:
        ref.set_camera(cam)
        want.append(ref.render())
    geo = passes.reprojection(cams[2], cams[1], ref.state.prev_nd_depth, W, H)
    sessions = {}
    for n in (2, 8):
        s = sessions[n] = make_session(W, H, device, mesh=shards(n))
        blocks = s.sharding.blocks
        drift = [float(geo["drift"][b.start:b.stop].max()) for b in blocks]
        print(f"mesh gi1080 on {n} blocks of {[b.rows for b in blocks]} rows; frame 3's drift "
              f"max a block {[round(d, 4) for d in drift]} px")
        check(min(drift) < 1e-2 < max(drift), f"mesh: frame 3's drift {drift} is not split")

        def run():
            out = []
            for cam in cams:
                s.set_camera(cam)
                out.append(s.render())
            return out

        got, launches = counted(run)
        check_launches(launches, {k: n * v for k, v in FLAGSHIP_LAUNCHES.items()}, len(cams),
                       f"mesh gi1080 on {n} blocks")
        for f in range(len(cams)):
            compare(f"gi1080 on {n} blocks, frame {f + 1}", got[f], want[f])
    fused = dict(options=dict(eaw_fused="1"))
    want_fused = make_session(W, H, device, **fused).render()
    s = make_session(W, H, device, mesh=shards(2), **fused)
    got, launches = counted(s.render)
    check_launches(launches, dict(eaw_pair=4, eaw_stage=0, eaw_disocclusion=2), 1,
                   "mesh gi1080_eaw_fused1 on 2 blocks")
    compare("gi1080_eaw_fused1 on 2 blocks", got, want_fused)

    # the EAW chain on a 1920x272 crop of frame 3's state, 8 blocks (multi-hop)
    st, rows = ref.state, slice(H // 2 - 136, H // 2 + 136)
    inputs = (st.color_history[rows].float(), mathops.oct_decode(st.prev_nd_oct[rows]),
              st.prev_nd_depth[rows], st.moments_history[rows].float())
    sharding = sh.row_sharding(shards(8), 272)
    for variant in (dict(), dict(eaw_fused="1"), dict(eaw_bf16=True)):
        opts = RenderOptions(**{"eaw_fused": "0", "eaw_bf16": False, **variant})
        reach = stencil.chain_reach(opts)
        chain_want = stencil.denoise_chain(*inputs, ref.settings, opts)
        chain_got = sh.gather_rows(sh.halo_map(
            sharding, lambda *x: stencil.denoise_chain(*x, ref.settings, opts), reach,
            *[sh.shard_rows(sharding, x) for x in inputs]), device)
        err = float((chain_got - chain_want).abs().max())
        print(f"mesh EAW chain {variant or 'eaw5'} on 1920x272, 8 blocks of "
              f"{[b.rows for b in sharding.blocks]} rows, halo {reach}: max abs difference "
              f"{err:.3g} from the unsharded chain, "
              f"{int((chain_got != chain_want).any(-1).sum())} differing pixels")
        check(torch.allclose(chain_got, chain_want, **TOL), f"mesh chain {variant}: {err}")

    # the colonnade through the BVH and the stream on 2 blocks
    for traversal, per_frame in (("bvh", COLONNADE_LAUNCHES), ("stream", STREAM_LAUNCHES)):
        cfg = dict(scene="colonnade", traversal=traversal)
        ref_c, s = make_session(W, H, device, **cfg), make_session(W, H, device, mesh=shards(2),
                                                                   **cfg)
        display, ref_c.state, aux = ref_c.frame(collect_aux=True)
        want_c = [display.cpu().numpy(), ref_c.render()]

        def run():
            d, s.state, a = s.frame(collect_aux=True)
            return [d.cpu().numpy(), s.render()], a

        (got, got_aux), launches = counted(run)
        check_launches(launches, {k: 2 * v for k, v in per_frame.items()}, 2,
                       f"mesh colonnade {traversal} on 2 blocks")
        ids = int((got_aux.gbuffer_prim != aux.gbuffer_prim).sum())
        print(f"mesh colonnade {traversal} on 2 blocks: {ids} of {W * H} primary hit ids differ; "
              f"set-up {s.setup_s:.3f} s (unsharded {ref_c.setup_s:.3f} s)")
        for f in range(2):
            compare(f"colonnade {traversal} on 2 blocks, frame {f + 1}", got[f], want_c[f],
                    exact=traversal != "stream")
        del ref_c, s

    # the cost of sharding on one card
    sessions[None], sessions[1] = ref, make_session(W, H, device, mesh=shards(1))
    for n in (None, 1, 2, 8):
        s = sessions[n]
        s.render_async()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            s.render_async()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FRAMES
        print(f"mesh gi1080 {'unsharded' if n is None else f'on {n} x {device}'}: {ms:.2f} "
              f"ms/frame over {FRAMES} frames; {smi}")
    print(f"mesh path launches: {path}")
    print(f"phase mesh: {time.perf_counter() - t_phase:.1f} s")
    return path


def dense_phase(smi):
    """The plain-torch traversals, "wavefront" (ops/wavefront.py) and
    "cull" (ops/cull.py), on the full colonnade. Traces: the four 1080p
    ray sets of the BVH session's third frame, on subsamples of DENSE_BLOCKS
    whole blocks of 128 rays evenly spaced (65,536 rays), through
    wavefront_closest/wavefront_any and through the cull functions the
    session uses (coherent for primary and shadow rays, the incoherent and
    sorted make_bounce_fns for bounce and NEE), each held to K7 on the same
    rays and timed with CUDA events, with the packets that took
    wavefront's continuation stages and cull's retrace and rescue. Frames:
    1920x1080 with default options through each mode, DENSE_FRAMES[mode]
    frames from a reset held to the BVH session's (primary hit ids equal but on
    edge or equal-depth pixels, display RMSE <= 1e-3), the launches of
    each frame checked, ms/frame on the host clock, set-up seconds and
    peak memory. Mesh: the cull frames on 2 x cuda:0 against the unsharded
    ones (primary hit ids equal, display RMSE <= 1e-3)."""
    import numpy as np
    import torch

    from capsaicin_tpu_torch import kernels as K
    from capsaicin_tpu_torch.ops import bvh, cull, wavefront
    from capsaicin_tpu_torch.parallel import make_mesh
    from capsaicin_tpu_torch.render.traversal import make_bounce_fns

    t_phase = time.perf_counter()
    ref = make_session(W, H, "cuda", scene="colonnade", traversal="bvh")
    calls = frame_rays(ref)
    tris = torch.stack([ref.scene_dev.tri_v0, ref.scene_dev.tri_v1, ref.scene_dev.tri_v2], 1)
    t0 = time.perf_counter()
    wbvh = wavefront.build_wavefront_bvh(tris)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cbvh = cull.build_cull_bvh(tris)
    torch.cuda.synchronize()
    print(f"dense builds on the colonnade's {tris.shape[0]} triangles: wavefront "
          f"{t1 - t0:.3f} s ({wbvh.n_leaves} rows), cull {time.perf_counter() - t1:.3f} s "
          f"(depth {cbvh.depth}, levels {cbvh.coh_level}/{cbvh.inc_level})")
    bounce = make_bounce_fns(cbvh)
    for name, (kind, o, d, tmin, tmax) in zip(("primary", "shadow", "bounce", "nee"), calls):
        any_hit = kind == "any"
        n = o.shape[0]
        blocks = torch.arange(0, n // 128, (n // 128) // DENSE_BLOCKS, device=o.device)
        idx = (blocks[:DENSE_BLOCKS, None] * 128 + torch.arange(128, device=o.device)).reshape(-1)
        so, sd, stm = o[idx].contiguous(), d[idx].contiguous(), tmax[idx].contiguous()
        want = bvh.bvh_trace(ref.accel, so, sd, tmin, stm, any_hit)
        if name in ("bounce", "nee"):
            cull_fn = bounce[1 if any_hit else 0]
        else:
            cull_fn = functools.partial(cull.cull_any if any_hit else cull.cull_closest, cbvh)
        wave_fn = functools.partial(
            wavefront.wavefront_any if any_hit else wavefront.wavefront_closest, wbvh)
        for mode, fn in (("wavefront", wave_fn), ("cull", cull_fn)):
            wavefront.STATS.update(continued=0, stages=0)
            cull.STATS.update(retraced=0, rescued=0)
            got, ms = timed(lambda: fn(so, sd, tmin, stm))
            what = f"dense {mode} {kind} ({name}, {len(idx)} rays) vs K7"
            if any_hit:
                hold_any(what, got, want)
            else:
                hold_hits(what, tuple(got[k] for k in ("t", "u", "v", "prim")), want,
                          hits_only=True)
            work = (f"{wavefront.STATS['continued']} of {-(-len(idx) // wavefront.LANE)} "
                    f"packets continued, {wavefront.STATS['stages']} stages" if mode == "wavefront"
                    else f"{cull.STATS['retraced']} of {-(-len(idx) // cull.G)} packets "
                    f"retraced, {cull.STATS['rescued']} rescued")
            print(f"{what}: {ms:.1f} ms a call; {work}")

    # frames: each mode from a reset against the BVH session's frames
    want, state = [], ref.state
    for _ in range(max(DENSE_FRAMES.values())):
        display, state, aux = ref.frame(state=state, collect_aux=True)
        want.append((display.cpu().numpy(), aux.gbuffer_prim, aux.gbuffer_bary, aux.nd_depth))

    def hold_frame(what, display, aux, frame):
        w_display, w_prim, w_bary, w_depth = want[frame]
        diff = aux.gbuffer_prim != w_prim
        edge = torch.zeros_like(diff)
        for pr, b in ((aux.gbuffer_prim, aux.gbuffer_bary), (w_prim, w_bary)):
            edge |= (pr >= 0) & ((b[..., 0] < 1e-5) | (b[..., 1] < 1e-5)
                                 | (1.0 - b[..., 0] - b[..., 1] < 1e-5))
        tie = (aux.nd_depth - w_depth).abs() <= 1e-4 * w_depth.abs()
        img = display.cpu().numpy()
        rmse = float(np.sqrt(np.mean((img.astype(np.float64) - w_display) ** 2)))
        print(f"{what}: {int(diff.sum())} of {W * H} primary hit ids differ from the BVH "
              f"frame's ({int((diff & ~edge & ~tie).sum())} off edges and ties), display RMSE "
              f"{rmse:.3g}")
        check(not bool((diff & ~edge & ~tie).any()),
              f"{what}: a primary hit id differs off the edges and ties")
        check(bool(np.isfinite(img).all()) and rmse <= RMSE_BAR, f"{what}: display RMSE {rmse}")
        return aux.gbuffer_prim, img

    unsharded = {}
    for mode in ("wavefront", "cull"):
        torch.cuda.reset_peak_memory_stats()
        s = make_session(W, H, "cuda", scene="colonnade", traversal=mode)
        wavefront.STATS.update(continued=0, stages=0)
        cull.STATS.update(retraced=0, rescued=0)
        K.reset_counts()
        state, times, out = s.state, [], []
        for f in range(DENSE_FRAMES[mode]):
            t0 = time.perf_counter()
            display, state, aux = s.frame(state=state, collect_aux=True)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append(hold_frame(f"dense {mode} 1080p frame {f + 1}", display, aux, f))
        launches = {k.name: k.launches for k in K.REGISTRY}
        check_launches(launches, DENSE_LAUNCHES, DENSE_FRAMES[mode], f"dense {mode} frames")
        unsharded[mode] = out
        work = (f"{wavefront.STATS['continued']} packets continued over "
                f"{wavefront.STATS['stages']} stages" if mode == "wavefront" else
                f"{cull.STATS['retraced']} packets retraced, {cull.STATS['rescued']} rescued")
        print(f"dense {mode} colonnade 1080p: set-up {s.setup_s:.3f} s; ms/frame "
              f"{[round(t, 1) for t in times]} (host clock, each synchronised); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {work} over "
              f"{DENSE_FRAMES[mode]} frames; launches {launches}; {smi}")
        del s

    # the cull frames on a mesh of 2 x cuda:0
    s = make_session(W, H, "cuda", scene="colonnade", traversal="cull",
                     mesh=make_mesh(["cuda:0"] * 2))
    K.reset_counts()
    state = s.state
    for f in range(DENSE_MESH_FRAMES):
        t0 = time.perf_counter()
        display, state, aux = s.frame(state=state, collect_aux=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        prim, img = unsharded["cull"][f]
        ids = int((aux.gbuffer_prim != prim).sum())
        rmse = float(np.sqrt(np.mean((display.cpu().numpy().astype(np.float64) - img) ** 2)))
        print(f"dense cull mesh of 2 x cuda:0, frame {f + 1}: {ids} primary hit ids differ from "
              f"the unsharded frame's, display RMSE {rmse:.3g}, {ms:.1f} ms")
        check(ids == 0 and rmse <= RMSE_BAR, f"dense cull mesh frame {f + 1}: {ids} ids, {rmse}")
    check_launches({k.name: k.launches for k in K.REGISTRY},
                   {k: 2 * v for k, v in DENSE_LAUNCHES.items()}, DENSE_MESH_FRAMES,
                   "dense cull mesh frames")
    print(f"phase dense: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from capsaicin_tpu_torch import kernels as K
    # importing registers the kernels: K1, K2, K3-K6, K7, K8, K10, K11, K9, K12
    from capsaicin_tpu_torch.ops import static  # noqa: F401
    from capsaicin_tpu_torch.ops import feedback  # noqa: F401
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
    compare_feedback(report)

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
                       dict(scene="colonnade20k", traversal="stream")),
                      ("colonnade(target_tris=20000), wavefront",
                       dict(scene="colonnade20k", traversal="wavefront")),
                      ("colonnade(target_tris=20000), cull",
                       dict(scene="colonnade20k", traversal="cull"))):
        images = {}
        for device in ("cuda", "cpu"):
            small = make_session(SMALL, SMALL, device, **cfg)
            for _ in range(SMALL_FRAMES):
                images[device] = small.render()
        rmse = float(np.sqrt(np.mean((images["cuda"] - images["cpu"]) ** 2)))
        print(f"{SMALL}x{SMALL} {what}, {SMALL_FRAMES} frames: display RMSE CUDA vs CPU "
              f"{rmse:.3g}")
        check(rmse <= RMSE_BAR, f"{what}: display RMSE {rmse} above {RMSE_BAR}")

    # 6-8. the public API and the viewer: OBJ ingest, add_scene and the
    # resume, the CLI, per-pass timings and ViewerState
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ingest_phase(tmp, smi)
        session_phase(tmp, smi)
        viewer_phase(tmp, smi)

    # 9. multi-device rendering: every kernel of a mesh frame's path launched
    mesh_path = mesh_phase(smi)
    for name in ("static_trace", "hit_attributes", "spatial_gather", "eaw_disocclusion",
                 "eaw_stage", "eaw_pair", "bvh_trace", "stream_trace", "stream_count"):
        check(mesh_path[name] > 0, f"{name} was never launched on the mesh path")

    # 10. the plain-torch traversals, wavefront and cull, on the colonnade
    dense_phase(smi)

    kernels = [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=path_launches[k.name], path=PATH_OF.get(k.name, "gi1080"),
             **report[k.name])
        for k in K.REGISTRY
    ]
    check(len(kernels) == 12, f"{len(kernels)} kernels registered, expected 12")
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
