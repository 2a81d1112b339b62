"""Where a frame's time goes on the GPU: per-pass and per-kernel device
time of the port's frame, from a torch.profiler trace (the counterpart of
the reference's named GPU timestamps, render_system.cpp:271-281).

A kernel belongs to the pass whose profiler range (pipeline.PASS_NAMES)
was open on the host when the kernel was launched; the trace ties each
kernel to its launch by the CUPTI correlation id. Busy time is the union
of the kernels' (and copies') intervals on the device, so overlapping
work is not counted twice; a pass takes the part of its kernels'
intervals that no earlier device work covers. Needs a CUDA session; run on a GPU:

    python -m capsaicin_tpu_torch.render.profiling --width 1920 --height 1080 --frames 5
    python -m capsaicin_tpu_torch.render.profiling --scene colonnade --traversal bvh
    python -m capsaicin_tpu_torch.render.profiling --scene colonnade --traversal stream \
        --stream-block 64
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from .pipeline import PASS_NAMES

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(events, frames: int, wall_ms: float, top: int = 15) -> dict:
    """Per-frame device times from the `traceEvents` of a chrome trace:
    busy ms, idle share against `wall_ms`, ms per pass, and the `top`
    kernels by total time with their launches per frame."""
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
              if e.get("cat") == "user_annotation" and e["name"] in PASS_NAMES]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in spans
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    # each device interval's part that no earlier one covers goes to the
    # busy time and to the pass that launched it, so the passes add up to at
    # most the busy time (the trace's rounding of its timestamps included)
    busy_us, end = 0.0, float("-inf")
    pass_us = dict.fromkeys(PASS_NAMES, 0.0)
    by_name = {}
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        own = max(0.0, stop - max(start, end))
        busy_us += own
        end = max(end, stop)
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        for lo, hi, name in ranges:
            if ts is not None and lo <= ts <= hi:
                pass_us[name] += own
                break
        us, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], n + 1)

    busy_ms = busy_us / 1e3 / frames
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "frames": frames,
        "wall_ms": wall_ms,
        "busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "passes_ms": {name: us / 1e3 / frames for name, us in pass_us.items()},
        "top": [{"name": name, "ms": us / 1e3 / frames, "calls": n / frames}
                for name, (us, n) in rows],
    }


def profile_frames(session, frames: int = 5, warmup: int = 2, top: int = 15) -> dict:
    """Render `warmup` frames, then profile `frames` frames of a CUDA
    session; returns summarize_trace's result with the device's name."""
    if session.device.type != "cuda":
        raise ValueError("profile_frames measures device time: it needs a CUDA session")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(warmup):
        session.render_async()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            session.render_async()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    result = summarize_trace(events, frames, wall_ms, top)
    return {"device": torch.cuda.get_device_name(session.device),
            "width": session.width, "height": session.height, **result}


def main(argv=None) -> int:
    from ..scene import build_scene
    from ..scene.procedural import colonnade, cornell_box, make_camera
    from .session import RenderSession

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--scene", choices=("cornell", "colonnade"), default="cornell",
                    help="the Cornell box (40 triangles) or the colonnade (~250k)")
    ap.add_argument("--traversal", default="auto",
                    help="static, brute, bvh, stream or auto (static up to 128 triangles, "
                    "else bvh)")
    ap.add_argument("--stream-block", type=int, default=None,
                    help="triangles per block of traversal stream (default 32)")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    session = RenderSession(args.width, args.height, traversal=args.traversal,
                            stream_block_tris=args.stream_block)
    session.set_camera(make_camera(args.scene, args.width, args.height))
    session.set_scene(build_scene(colonnade() if args.scene == "colonnade" else cornell_box()))
    result = profile_frames(session, frames=args.frames)
    block = f", block {session.accel.block_tris}" if args.traversal == "stream" else ""
    print(f"{result['device']} {args.scene} {args.width}x{args.height}, traversal "
          f"{args.traversal}{block}: wall {result['wall_ms']:.3f} "
          f"ms/frame, device busy {result['busy_ms']:.3f} ms/frame, "
          f"idle share {result['idle_share']:.3f}")
    for name, ms in result["passes_ms"].items():
        print(f"  pass {name:16s} {ms:9.3f} ms")
    for row in result["top"]:
        print(f"  {row['ms']:9.3f} ms {row['calls']:7.1f}x  {row['name'][:90]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
