#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (capsaicin_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from csrc/, holds each (and its bf16-storage
instance) against its plain PyTorch version at the shapes of the 1080p
frame, renders the Cornell box at 1920x1080 with default options through
the session API and checks that the frame went through every kernel,
renders the other Cornell configurations of bench.py the same way, then
holds small CUDA renders against the CPU path.

    python3 chip_smoke.py

Exits non-zero, printing no result, when CUDA is unavailable or any check
fails. The last line of its output is one JSON object naming the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

W, H = 1920, 1080
FRAMES = 8
SMALL = 64
SMALL_FRAMES = 3
RMSE_BAR = 1e-3  # BASELINE.json's accuracy bar
TOL = dict(rtol=1e-3, atol=1e-4)  # float32 kernels against their plain versions
BF16_MAX, BF16_MEAN = 2e-2, 1e-3  # bf16 storage: one rounding may flip by an ulp
SKY = (0.7, 0.7, 0.85)

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
# The configuration whose run is the path of a kernel not on the flagship's
PATH_OF = {"eaw_pair": "gi1080_eaw_fused1"}


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rays_per_frame(width, height, bounces, lowres=False, spp=1):
    """Rays traced per frame, counted as bench.py:102 counts them: primary
    and direct shadow at every pixel, and per bounce and per spp sample one
    bounce ray and one NEE shadow ray at the indirect resolution."""
    full = width * height
    half = full // 4 if lowres else full
    return 2 * full + 2 * half * bounces * spp


def make_session(width, height, device, options=None, scene="cornell", atlas_u32=False):
    from capsaicin_tpu_torch.render.session import RenderSession
    from capsaicin_tpu_torch.render.settings import RenderOptions
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import (
        cornell_box, cornell_box_textured, make_camera)
    from capsaicin_tpu_torch.scene.scene import quantize_atlas

    session = RenderSession(width, height, options=RenderOptions(**(options or {})),
                            device=device)
    session.set_camera(make_camera("cornell", width, height))
    host = build_scene(*cornell_box_textured()) if scene == "textured" else build_scene(
        cornell_box())
    session.set_scene(quantize_atlas(host) if atlas_u32 else host)
    return session


def check_image(img, shape, what):
    import numpy as np

    check(img.shape == shape, f"{what}: display shape {img.shape}")
    check(bool(np.isfinite(img).all()), f"{what}: display has non-finite pixels")
    sky = np.float32(SKY) ** (1.0 / 2.2)
    check(bool(np.abs(img[0, 0] - sky).max() < 1e-3),
          f"{what}: corner pixel {img[0, 0]} is not the sky {sky}")


def check_launches(launches, per_frame, frames, what):
    for name, n in per_frame.items():
        check(launches[name] == n * frames,
              f"{what}: {name} {launches[name]} launches, expected {n * frames}")


def compare_trace(session, report):
    """K1 (closest on primary rays, any-hit on shadow rays) and K2 against
    their plain versions on the 1080p frame's rays."""
    import torch

    from capsaicin_tpu_torch.ops import camera as cam
    from capsaicin_tpu_torch.ops import lookup, static
    from capsaicin_tpu_torch.render import shading

    n = W * H
    xy = cam.pixel_grid(W, H, session.device)
    o, d = cam.create_primary_rays(session.camera, xy, (W, H), 0)
    o = o.reshape(n, 3).contiguous()
    d = d.reshape(n, 3).contiguous()
    tmax = torch.full((n,), 1e6, device=session.device)
    acc, table = session.accel, session.shade.table

    t, u, v, prim = static.static_trace(acc, o, d, 0.0, tmax, False)
    tp, up, vp, pp = static.static_trace_plain(acc.tris, o, d, 0.0, tmax, False)
    # an edge ray is one that either version hits within 1e-5 of an edge
    edge = torch.zeros_like(prim, dtype=torch.bool)
    for pr, uu, vv in ((prim, u, v), (pp, up, vp)):
        edge |= (pr >= 0) & ((uu < 1e-5) | (vv < 1e-5) | (1.0 - uu - vv < 1e-5))
    diff = prim != pp
    n_diff = int(diff.sum())
    print(f"K1 closest: {n} primary rays, {n_diff} prim mismatches "
          f"({int((diff & ~edge).sum())} off the edges)")
    check(not bool((diff & ~edge).any()), "K1: prim differs on a ray that is not an edge ray")
    check(n_diff <= 1e-4 * n, "K1: more than 1e-4 of rays differ in prim")
    same = ~diff
    err = max(float((a - b)[same].abs().max()) for a, b in ((t, tp), (u, up), (v, vp)))
    check(err <= 1e-5, f"K1: t/u/v differ by {err} where prim matches")

    # shadow rays of the direct pass: hit points toward the light, dead
    # (tmax = -1) where the primary ray missed or the surface faces away
    hit = lookup.hit_attributes(table, prim, u, v)
    hitp = lookup.hit_attributes_plain(table, prim, u, v)
    k2_err = 0.0
    for key in hit:
        a, b = hit[key].double(), hitp[key].double()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        k2_err = max(k2_err, float((a - b).abs().max()))
    print(f"K2: max abs err {k2_err:.3g} against the plain version")
    kd = shading.material_from_hit(session.shade, hitp)
    ldir, unshadowed = shading.direct_illumination_terms(hitp["p"], hitp["n"], kd, 0)
    ldir = ldir.contiguous()
    live = (pp >= 0) & (unshadowed > 0.0).any(-1)
    stmax = torch.where(live, shading.LIGHT_DISTANCE, -1.0)
    sp = hitp["p"].contiguous()
    sh = static.static_trace(acc, sp, ldir, shading.SHADOW_TMIN, stmax, True)
    shp = static.static_trace_plain(acc.tris, sp, ldir, shading.SHADOW_TMIN, stmax, True)[3] >= 0
    n_sdiff = int((sh != shp).sum())
    print(f"K1 any-hit: {n} shadow rays ({int((~live).sum())} dead), {n_sdiff} mismatches")
    check(n_sdiff <= 1e-4 * n, "K1: more than 1e-4 of shadow rays differ")

    k1_ms = cuda_ms(lambda: static.static_trace(acc, o, d, 0.0, tmax, False), 20)
    k1_plain = cuda_ms(lambda: static.static_trace_plain(acc.tris, o, d, 0.0, tmax, False), 5)
    any_ms = cuda_ms(lambda: static.static_trace(acc, sp, ldir, shading.SHADOW_TMIN, stmax, True), 20)
    any_plain = cuda_ms(
        lambda: static.static_trace_plain(acc.tris, sp, ldir, shading.SHADOW_TMIN, stmax, True), 5)
    print(f"K1 closest {k1_ms:.4f} ms (plain {k1_plain:.4f} ms); "
          f"any-hit {any_ms:.4f} ms (plain {any_plain:.4f} ms)")
    k2_ms = cuda_ms(lambda: lookup.hit_attributes(table, prim, u, v), 20)
    k2_plain = cuda_ms(lambda: lookup.hit_attributes_plain(table, prim, u, v), 20)
    print(f"K2 {k2_ms:.4f} ms (plain {k2_plain:.4f} ms)")
    report["static_trace"] = dict(max_abs_err=err, ms=k1_ms, plain_ms=k1_plain)
    report["hit_attributes"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain)


def frame_aux(session, options, frames=3):
    """(FrameState, PassOutputs) of the last of `frames` frames rendered
    from a reset with `options`, outside the session's own state."""
    from capsaicin_tpu_torch.render import pipeline
    from capsaicin_tpu_torch.render.traversal import make_traversal

    closest, any_hit = make_traversal("static", session.accel)
    state = pipeline.init_state(session.width, session.height, session.camera, options)
    for _ in range(frames):
        _, state, aux = pipeline.render_frame(
            session.shade, closest, any_hit, session.camera, state, session.settings,
            session.noise, session.width, session.height, options, collect_aux=True)
    return state, aux


def compare_stencils(session, report):
    """K3-K6, their bf16 instances and the whole chain in each grouping
    against their plain versions, on the gather's and the denoiser's
    inputs of a 1080p frame (the third after a reset) and on the gather's
    input of a lowres_indirect frame ([540, 960])."""
    import dataclasses

    import torch

    from capsaicin_tpu_torch.ops import mathops as m
    from capsaicin_tpu_torch.ops import stencil
    from capsaicin_tpu_torch.render import passes

    opts = session.options
    st, aux = frame_aux(session, opts)
    color4 = st.color_history.float().contiguous()
    moments4 = st.moments_history.float()
    normal = m.oct_decode(st.prev_nd_oct)
    geo = stencil.pack_geo(normal, st.prev_nd_depth)
    mom = moments4[..., [0, 1, 3]].contiguous()
    s = session.settings
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    gsig = (s.gather_normal_sigma, s.gather_depth_sigma, s.gather_luma_sigma)
    indirect = aux.indirect_raw.contiguous()
    lst, laux = frame_aux(session, dataclasses.replace(opts, lowres_indirect=True))
    ox, oy = passes.interleave_offset(lst.frame_count - 1)
    low_in = laux.indirect_raw.contiguous()
    low_geo = stencil.pack_geo(m.oct_decode(laux.nd_oct[oy::2, ox::2]),
                               laux.nd_depth[oy::2, ox::2])
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

    # each kernel, its plain version and the argument sets it is held on
    full_geo = stencil.pack_geo(m.oct_decode(aux.nd_oct), aux.nd_depth)
    cases = {
        "eaw_disocclusion": (stencil.eaw_disocclusion, stencil.eaw_disocclusion_plain,
                             [(color4, geo, mom, *sig)]),
        "eaw_stage": (stencil.eaw_stage, stencil.eaw_stage_plain,
                      [(color4, geo, k, True, *sig) for k in strides]),
        "spatial_gather": (stencil.spatial_gather, stencil.spatial_gather_plain,
                           [(indirect, full_geo, *gsig), (low_in, low_geo, *gsig)]),
        "eaw_pair": (stencil.eaw_pair, stencil.eaw_pair_plain,
                     [(color4, geo, *p, True, *sig) for p in pairs]),
    }
    for name, (kernel, plain, arg_sets) in cases.items():
        bf_sets = [tuple(a.bfloat16() if torch.is_tensor(a) else a for a in args)
                   for args in arg_sets]
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
                     bf16_ms=sum(bf_ms) / len(ms), bf16_plain_ms=sum(bf_plain) / len(ms))
        if len(ms) > 1:  # per case: strides, pairs, or the gather's full and half resolution
            entry.update(case_ms=ms, case_plain_ms=plain_ms, case_bf16_ms=bf_ms)
        report[name] = entry
        print(f"{name}: max abs err {err:.3g} (bf16 {entry['bf16_max_abs_err']:.3g}, mean "
              f"{entry['bf16_mean_abs_err']:.3g}); {entry['ms']:.4f} ms (plain "
              f"{entry['plain_ms']:.4f} ms), bf16 {entry['bf16_ms']:.4f} ms (plain "
              f"{entry['bf16_plain_ms']:.4f} ms); per case {[round(x, 4) for x in ms]} ms")

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
        return stencil.denoise_chain(color4, normal, st.prev_nd_depth, moments4, s, o)

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


def run_config(name, cfg, frames, per_frame):
    """One Cornell configuration through the session API: a warm-up frame,
    then `frames` frames (render_loop with accumulate for a loop config)
    with the counts reset just before; checks launches and the image."""
    import torch

    from capsaicin_tpu_torch import kernels as K

    cfg = dict(cfg)
    loop = cfg.pop("loop", None)
    width, height = cfg["width"], cfg["height"]
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
    check_image(display.cpu().numpy(), (height, width, 3), name)
    o = session.options
    rays = rays_per_frame(width, height, o.num_diffuse_bounces, o.lowres_indirect, o.spp)
    print(f"{name} {width}x{height}: {ms:.2f} ms/frame over {frames} frames = "
          f"{rays / ms / 1e3:.2f} Mrays/s ({rays} rays/frame); launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from capsaicin_tpu_torch import kernels as K
    # importing registers the kernels: K1, K2, then K3-K6
    from capsaicin_tpu_torch.ops import static  # noqa: F401
    from capsaicin_tpu_torch.ops import lookup, stencil  # noqa: F401

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
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

    # 4b. the other Cornell configurations of bench.py through the session API
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
                      ('eaw_fused="1" eaw_bf16', dict(options=dict(eaw_fused="1", eaw_bf16=True)))):
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
    check(len(kernels) == 6, f"{len(kernels)} kernels registered, expected 6")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
