"""K10's times on the full colonnade's four 1080p ray sets (primary,
direct shadow, bounce, NEE of the third frame of `colonnade_stream`) in
pixel order and, for bounce and NEE, in the session's 96-cell sorted order
(the bounce set balanced), at blocks of 32, 64 and 128, with a digest of
each result; K11's (`count_candidates`) on the four sets and on the
frame's own call (the bounce set in the sorted order), at blocks of 8 and
32, with a digest of each count (`ms`: CUDA events around `--count-iters`
calls as the host issues them; `device_ms`: the same calls queued behind
a spin of the device); then the `colonnade_stream*` ms/frame. One JSON
line.

It uses only the stream API that every version of the port has, so an
A/B of two trees on one card runs it from each tree's root in turns
(parent, change, change, parent) and compares the times and the digests:

    python3 -m capsaicin_tpu_torch.tools.stream_times [--iters 2] [--count-iters 20] [--frames 8]

GPU only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import torch

from capsaicin_tpu_torch.ops import bvh, stream
from capsaicin_tpu_torch.render import pipeline
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.render.traversal import make_stream_bounce_fns
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, make_camera

W, H = 1920, 1080
BLOCKS = (32, 64, 128)
COUNT_BLOCKS = (8, 32)  # K11's block sizes timed: 32,768 and 8,192 boxes
SPIN_CYCLES = 10_000_000  # about 5 ms at 1.98 GHz: the host queues every call meanwhile
NAMES = ("primary", "shadow", "bounce", "nee")


def session(host, block_tris=None):
    s = RenderSession(W, H, options=RenderOptions(), device="cuda", traversal="stream",
                      stream_block_tris=block_tris)
    s.set_camera(make_camera("colonnade", W, H))
    s.set_scene(host)
    return s


def frame_rays(s, frames=3):
    """[(kind, origins, dirs, tmin, tmax [N])] of the primary, shadow,
    bounce and NEE traces of the last of `frames` frames from a reset."""
    closest, any_hit = s._trace
    calls = []

    def record(kind, fn):
        def traced(o, d, tmin, tmax):
            tm = torch.as_tensor(tmax, dtype=torch.float32, device=o.device).expand(o.shape[0])
            calls.append((kind, o.contiguous(), d.contiguous(), float(tmin), tm.contiguous()))
            return fn(o, d, tmin, tmax)
        return traced

    state = pipeline.init_state(s.width, s.height, s.camera, s.options)
    for _ in range(frames):
        calls.clear()
        _, state = pipeline.render_frame(s.shade, record("closest", closest), record("any", any_hit),
                                         s.camera, state, s.settings, s.noise, s.width, s.height,
                                         s.options)
    torch.cuda.synchronize()
    return list(calls)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device ms of one call of `fn`: `iters` calls queued while the device
    spins, CUDA events around them, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def digest(out):
    h = hashlib.sha256()
    for x in (out if isinstance(out, tuple) else (out,)):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2, help="timed calls after one warm-up")
    ap.add_argument("--count-iters", type=int, default=20, help="K11's timed calls")
    ap.add_argument("--frames", type=int, default=8, help="frames timed per configuration")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    host = build_scene(colonnade())
    s = session(host)
    calls = frame_rays(s)
    tris = torch.stack([s.scene_dev.tri_v0, s.scene_dev.tri_v1, s.scene_dev.tri_v2], 1)
    del s
    result = {"device": smi, "rays": {}, "k10": {}, "k11": {}, "frame_ms": {}}
    for name, (kind, o, d, tmin, tmax) in zip(NAMES, calls):
        result["rays"][name] = digest((o, d, tmax))
    count_sets = {name: (o, d, tmin, tmax) for name, (_, o, d, tmin, tmax) in zip(NAMES, calls)}
    o, d, tmin, tmax = count_sets["bounce"]
    order, _ = bvh.sort_rays_for_traversal(o, d, dead=tmax < tmin, dir_grid=4)
    count_sets["bounce_sorted"] = (o[order].contiguous(), d[order].contiguous(), tmin,
                                   tmax[order].contiguous())
    for b in COUNT_BLOCKS:
        sb = stream.build_stream_bvh(tris, b)
        for name, (o, d, tmin, tmax) in count_sets.items():
            count = lambda o=o, d=d, tmin=tmin, tm=tmax: stream.count_candidates(  # noqa: E731
                sb, o, d, tmin, tm)
            entry = {"ms": cuda_ms(count, args.count_iters),
                     "device_ms": device_ms(count, args.count_iters), "digest": digest(count())}
            result["k11"][f"{name}{b}"] = entry
            print(f"K11 blocks {b} {name}: {entry}", flush=True)
        del sb
    for b in BLOCKS:
        sb = stream.build_stream_bvh(tris, b)
        for name, (kind, o, d, tmin, tmax) in zip(NAMES, calls):
            any_hit = kind == "any"
            trace = lambda o=o, d=d, tm=tmax, order=None: stream.stream_trace(  # noqa: E731
                sb, o, d, tmin, tm, any_hit, order)
            entry = {"ms": cuda_ms(trace, args.iters), "digest": digest(trace())}
            if name in ("bounce", "nee"):
                order, _ = bvh.sort_rays_for_traversal(o, d, dead=tmax < tmin, dir_grid=4)
                oo, od, otm = o[order].contiguous(), d[order].contiguous(), tmax[order].contiguous()
                bal = None if any_hit else stream.balance_order(
                    stream.count_candidates(sb, oo, od, tmin, otm))
                entry["sorted_ms"] = cuda_ms(lambda: trace(oo, od, otm, bal), args.iters)
                entry["sorted_digest"] = digest(trace(oo, od, otm, bal))
                fn = make_stream_bounce_fns(sb)[1 if any_hit else 0]
                entry["session_trace_ms"] = cuda_ms(lambda: fn(o, d, tmin, tmax), args.iters)
            result["k10"][f"{name}{b}"] = entry
            print(f"blocks {b} {name}: {entry}", flush=True)
        del sb
    for b in BLOCKS:
        s = session(host, b)
        s.render_async()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.frames):
            s.render_async()
        torch.cuda.synchronize()
        result["frame_ms"][b] = (time.perf_counter() - t0) * 1e3 / args.frames
        print(f"colonnade_stream blocks of {b}: {result['frame_ms'][b]:.2f} ms/frame", flush=True)
        del s
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
