"""Where a frame's time goes: the session's per-pass timings under the
reference's timer names (`measure_pass_timings`, the counterpart of its
named GPU timestamp table, render_system.cpp:189-226, 271-281), and per-pass
and per-kernel device time of the port's frame from a torch.profiler trace.

`measure_pass_timings` times each pass of a frame that does not advance
the session's state: on CUDA with a pair of CUDA events around each pass
on the frame's stream, read after one sync at the end of the frame; on
the CPU, or with method="isolated" (a device sync before and after each
pass), with the host clock. On a mesh session of several GPUs each pass
has an event pair on each GPU, and its time is its slowest GPU's.

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
    python -m capsaicin_tpu_torch.render.profiling --scene colonnade --traversal cull --frames 2

The program's spans and counters live here too. `span(name)` is a
profiler range while a profiler records and a shared no-op context
otherwise, so with tracing off a span costs one flag test. Spans of a
frame nest by time on the host thread that issues it: the pass ranges
(pipeline.PASS_NAMES) lie in the session's `session.queue` span, and the
spans inside a pass (`gi.feedback_fetch`, `ray_sort`) in its range.
`count(name, value)` adds a host int or a 0-d device tensor to a
process-wide registry while a profiler records, without a sync;
`counters()` reads every counter to the host with one sync a device, and
`reset_counters()` empties the registry. Counters: `rays.<set>` and
`live_rays.<set>` (tmax >= tmin) of the sets `primary`, `shadow`,
`bounce` and `nee` (`count_rays`, at the trace calls of render.passes),
and K7's `bvh.rays`, `bvh.box_tests` and `bvh.tri_tests` (ops.bvh, from
its counting build; the plain walk on the CPU counts nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_OFF = nullcontext()  # the span of every name while no profiler records
_HOST_COUNTS: Dict[str, int] = {}
_DEVICE_COUNTS: Dict[str, List[torch.Tensor]] = {}


def recording() -> bool:
    """True while a torch.profiler records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler range named `name` while a profiler records, else a
    shared no-op context (one flag test)."""
    return torch.profiler.record_function(name) if recording() else _OFF


def count(name: str, value):
    """Add `value`, a host int or a 0-d integer tensor on any device, to the
    counter `name` while a profiler records. Never syncs: a device value is
    kept as it is and summed at the read."""
    if not recording():
        return
    if isinstance(value, torch.Tensor):
        _DEVICE_COUNTS.setdefault(name, []).append(value)
    else:
        _HOST_COUNTS[name] = _HOST_COUNTS.get(name, 0) + int(value)


def count_rays(ray_set: str, n: int, tmin: float, tmax):
    """`rays.<ray_set>` (n, the rays submitted) and `live_rays.<ray_set>`
    (those with tmax >= tmin; tmax a float or [n]) while a profiler records."""
    if not recording():
        return
    count(f"rays.{ray_set}", n)
    if isinstance(tmax, torch.Tensor):
        count(f"live_rays.{ray_set}", (tmax >= tmin).sum())
    else:
        count(f"live_rays.{ray_set}", n if tmax >= tmin else 0)


def counters() -> Dict[str, int]:
    """Every counter's total as a host int: one sum and one copy to the host
    (the sync) a device that holds counts."""
    out = dict(_HOST_COUNTS)
    by_device: Dict[torch.device, Dict[str, List[torch.Tensor]]] = {}
    for name, values in _DEVICE_COUNTS.items():
        for v in values:
            by_device.setdefault(v.device, {}).setdefault(name, []).append(
                v.reshape(()).to(torch.int64))
    for names in by_device.values():
        totals = torch.stack([torch.stack(vs).sum() for vs in names.values()]).tolist()
        for name, total in zip(names, totals):
            out[name] = out.get(name, 0) + int(total)
    return out


def reset_counters():
    _HOST_COUNTS.clear()
    _DEVICE_COUNTS.clear()


# The reference's pass timers (raytracing_system.cpp:1024-1559), as the JAX
# package's profiling.PASS_NAMES; a table also has "whole frame".
PASS_NAMES = (
    "RaytracePrimaryVisibility",
    "RT Direct lighting",
    "RT Indirect diffuse",
    "Spatial gather",
    "Reproject history",
    "Temporal upscale",
    "EAW",
    "Combine illumination",
    "TAA",
)


class PassTimer:
    """A per-pass timer for pipeline.render_frame's `timer` hook. Seconds
    add up by name over frames, in the order the passes end. `devices`:
    the session's distinct devices (on a mesh of several, a pass takes the
    time of its slowest device)."""

    def __init__(self, devices, isolated: bool = False):
        self.devices = [torch.device(d) for d in devices]
        cuda = all(d.type == "cuda" for d in self.devices)
        self.events = cuda and not isolated
        self.sync = cuda and isolated
        self.seconds: Dict[str, float] = {}
        self._pending = []

    def _add(self, name: str, seconds: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def _record(self):
        """An event recorded on each device's current stream."""
        events = [torch.cuda.Event(enable_timing=True) for _ in self.devices]
        for e, d in zip(events, self.devices):
            e.record(torch.cuda.current_stream(d))
        return events

    def _synchronize(self):
        for d in self.devices:
            torch.cuda.synchronize(d)

    @contextmanager
    def __call__(self, name: str):
        if self.events:
            start = self._record()
            yield
            self._pending.append((name, start, self._record()))
            return
        if self.sync:
            self._synchronize()
        t0 = time.perf_counter()
        yield
        if self.sync:
            self._synchronize()
        self._add(name, time.perf_counter() - t0)

    def end_frame(self):
        """Read the frame's events after one sync (CUDA events only)."""
        if self._pending:
            for e in self._pending[-1][2]:
                e.synchronize()
            for name, start, end in self._pending:
                self._add(name, max(s.elapsed_time(e) for s, e in zip(start, end)) / 1e3)
            self._pending = []


def measure_pass_timings(session, iters: int = 3, method: str = "inframe") -> Dict[str, float]:
    """Mean seconds of each pass that the session's options run, under
    PASS_NAMES, and of the whole frame ("whole frame", last), over `iters`
    frames after one untimed frame. The frames start from the session's
    state and camera and do not advance them. method: "inframe" (CUDA
    events on the frame's stream) or "isolated" (a device sync before and
    after each pass, host clock); the CPU takes the host clock."""
    if method not in ("inframe", "isolated"):
        raise ValueError(f"unknown method {method!r}: expected 'inframe' or 'isolated'")
    session.frame()  # untimed: the first frame of a variant sets up its buffers
    timer = PassTimer(session.devices, isolated=method == "isolated")
    for _ in range(max(int(iters), 1)):
        with timer("whole frame"):
            session.frame(timer=timer)
        timer.end_frame()
    n = max(int(iters), 1)
    return {name: s / n for name, s in timer.seconds.items()}


def summarize_trace(events, frames: int, wall_ms: float, top: int = 15) -> dict:
    """Per-frame device times from the `traceEvents` of a chrome trace:
    busy ms, idle share against `wall_ms`, ms per pass, and the `top`
    kernels by total time with their launches per frame."""
    from .pipeline import PASS_NAMES as RANGE_NAMES

    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
              if e.get("cat") == "user_annotation" and e["name"] in RANGE_NAMES]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in spans
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}

    # each device interval's part that no earlier one covers goes to the
    # busy time and to the pass that launched it, so the passes add up to at
    # most the busy time (the trace's rounding of its timestamps included)
    busy_us, end = 0.0, float("-inf")
    pass_us = dict.fromkeys(RANGE_NAMES, 0.0)
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
                    choices=("auto", "static", "brute", "bvh", "stream", "wavefront", "cull"),
                    help="auto: static up to 128 triangles, else bvh")
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
