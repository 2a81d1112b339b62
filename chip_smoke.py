#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (capsaicin_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes of the 1080p frame, renders the Cornell box
at 1920x1080 through the session API and checks that the frame went
through every kernel, then holds a small CUDA render against the CPU path.

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


def rays_per_frame(width, height, bounces):
    """Rays traced per frame, counted as bench.py counts them: primary and
    direct shadow at every pixel, and per bounce one bounce ray and one
    NEE shadow ray."""
    return 2 * width * height + 2 * width * height * bounces


def make_session(width, height, device):
    from capsaicin_tpu_torch.render.session import RenderSession
    from capsaicin_tpu_torch.render.settings import RenderOptions
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera

    session = RenderSession(width, height, options=RenderOptions(gather=False), device=device)
    session.set_camera(make_camera("cornell", width, height))
    session.set_scene(build_scene(cornell_box()))
    return session


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
    acc, table = session.accel, session.attr_table

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
    kd = shading.material_from_hit(hitp)
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


def compare_stencils(session, report):
    """K3, K4 and the whole chain against their plain versions on the
    denoiser's inputs of a 1080p frame (after two frames of history)."""
    import torch

    from capsaicin_tpu_torch.ops import mathops as m
    from capsaicin_tpu_torch.ops import stencil

    session.reset()
    for _ in range(3):
        session.render_async()
    st = session.state
    color4 = st.color_history.float().contiguous()
    moments4 = st.moments_history.float()
    normal = m.oct_decode(st.prev_nd_oct)
    geo = torch.cat([normal, st.prev_nd_depth[..., None]], -1).contiguous()
    mom = moments4[..., [0, 1, 3]].contiguous()
    s = session.settings
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)

    def close(a, b, what):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4, msg=what)
        return float((a - b).abs().max())

    k3_err = close(stencil.eaw_disocclusion(color4, geo, mom, *sig),
                   stencil.eaw_disocclusion_plain(color4, geo, mom, *sig), "K3")
    strides = stencil.chain_strides(session.options)
    k4_err = 0.0
    for stride in strides:
        k4_err = max(k4_err, close(
            stencil.eaw_stage(color4, geo, stride, True, *sig),
            stencil.eaw_stage_plain(color4, geo, stride, True, *sig), f"K4 stride {stride}"))

    def plain_chain():
        out = stencil.eaw_disocclusion_plain(color4, geo, mom, *sig)
        for stride in strides:
            out = stencil.eaw_stage_plain(out, geo, stride, True, *sig)
        return out

    def chain():
        return stencil.denoise_chain(color4, normal, st.prev_nd_depth, moments4, s, session.options)

    chain_err = close(chain(), plain_chain(), "denoise_chain")
    print(f"K3 max abs err {k3_err:.3g}; K4 {k4_err:.3g}; chain {chain_err:.3g}")
    chain_ms = cuda_ms(chain, 10)
    chain_plain = cuda_ms(plain_chain, 2)
    print(f"denoise_chain {chain_ms:.4f} ms (plain {chain_plain:.4f} ms)")

    k3_ms = cuda_ms(lambda: stencil.eaw_disocclusion(color4, geo, mom, *sig), 20)
    k3_plain = cuda_ms(lambda: stencil.eaw_disocclusion_plain(color4, geo, mom, *sig), 3)
    k4_ms = sum(cuda_ms(lambda: stencil.eaw_stage(color4, geo, st_, True, *sig), 20)
                for st_ in strides) / len(strides)
    k4_plain = sum(cuda_ms(lambda: stencil.eaw_stage_plain(color4, geo, st_, True, *sig), 3)
                   for st_ in strides) / len(strides)
    print(f"K3 {k3_ms:.4f} ms (plain {k3_plain:.4f} ms); K4 mean over strides "
          f"{list(strides)} {k4_ms:.4f} ms (plain {k4_plain:.4f} ms)")
    report["eaw_disocclusion"] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain)
    report["eaw_stage"] = dict(max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np

    from capsaicin_tpu_torch import kernels as K
    # importing registers the kernels, in the order K1, K2, K3, K4
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

    # 4. the 1080p frame through the session API, counting launches
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
    launches = {k.name: k.launches for k in K.REGISTRY}
    per_frame = {"static_trace": 4, "hit_attributes": 3, "eaw_disocclusion": 1, "eaw_stage": 4}
    print(f"launches over {FRAMES} frames: {launches}")
    for name, n in per_frame.items():
        check(launches[name] == n * FRAMES, f"{name}: {launches[name]} launches, "
              f"expected {n * FRAMES}")
    img = display.cpu().numpy()
    check(img.shape == (H, W, 3), f"display shape {img.shape}")
    check(bool(np.isfinite(img).all()), "display has non-finite pixels")
    sky = np.float32([0.7, 0.7, 0.85]) ** (1.0 / 2.2)
    check(bool(np.abs(img[0, 0] - sky).max() < 1e-3), f"corner pixel {img[0, 0]} is not the sky {sky}")
    ms = (t_end - t_steady) * 1e3 / (FRAMES - 1)
    rays = rays_per_frame(W, H, session.options.num_diffuse_bounces)
    print(f"1080p frame: first {(t_steady - t_first) * 1e3:.2f} ms, then {ms:.2f} ms/frame "
          f"over {FRAMES - 1} frames = {rays / ms / 1e3:.2f} Mrays/s ({rays} rays/frame)")

    # 5. kernel path against the CPU path, end to end
    images = {}
    for device in ("cuda", "cpu"):
        small = make_session(SMALL, SMALL, device)
        for _ in range(SMALL_FRAMES):
            images[device] = small.render()
    rmse = float(np.sqrt(np.mean((images["cuda"] - images["cpu"]) ** 2)))
    print(f"{SMALL}x{SMALL}, {SMALL_FRAMES} frames: display RMSE CUDA vs CPU {rmse:.3g}")
    check(rmse <= RMSE_BAR, f"display RMSE {rmse} above {RMSE_BAR}")

    kernels = [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=launches[k.name], **report[k.name])
        for k in K.REGISTRY
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
