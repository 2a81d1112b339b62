"""A bounded stretch of a run under torch.profiler, reduced to what the
per-layer metrics read: device busy time (the union of kernel, copy and
set intervals, so overlapping work counts once), device time by kernel
name and by the host range open when each kernel was launched (CUPTI
correlation ids tie a kernel to its launch), and the device's idle gaps
labelled by what the host was doing. The arithmetic is a frozen copy of
capsaicin_tpu_torch/render/profiling.py's summarize_trace.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# host calls in which the host waits for the device or copies from it
WAIT_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaMemcpy", "cudaEventSynchronize")
FRAME_RANGE = "portbench.frame"  # the harness's range around each frame or request


def capture(run_stretch, tmpdir: Optional[str] = None):
    """Run `run_stretch()` (which returns (frames, wall seconds)) under
    torch.profiler with CPU and CUDA activity; returns a Trace. The chrome
    trace goes to a temporary file under TMPDIR and is deleted."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        frames, wall_s = run_stretch()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, frames, wall_s)


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


class Trace:
    """The reduced trace of `frames` frames over `wall_s` seconds of host
    time. Times in the chrome trace are microseconds."""

    def __init__(self, events: List[dict], frames: int, wall_s: float):
        self.frames = frames
        self.wall_s = wall_s
        spans = [e for e in events if e.get("ph") == "X"]
        self.device = sorted(((e["ts"], e["ts"] + e["dur"], e["name"],
                               e.get("args", {}).get("correlation"))
                              for e in spans if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda d: d[0])
        self.launch_ts = {e["args"]["correlation"]: e["ts"] for e in spans
                          if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
        self.ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                       if e.get("cat") == "user_annotation"]
        self.waits = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                      if e.get("cat") in LAUNCH_CATEGORIES and e["name"].startswith(WAIT_CALLS)]
        # each device interval's part that no earlier one covers
        self.own = []
        end = float("-inf")
        for start, stop, _, _ in self.device:
            self.own.append(max(0.0, stop - max(start, end)))
            end = max(end, stop)
        self.busy_s = sum(self.own) / 1e6
        frame_ranges = [r for r in self.ranges if r[2] == FRAME_RANGE]
        if frame_ranges:
            self.t0 = min(r[0] for r in frame_ranges)
            self.t1 = max(r[1] for r in frame_ranges)
        else:
            self.t0 = self.device[0][0] if self.device else 0.0
            self.t1 = self.device[-1][1] if self.device else 0.0

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.wall_s)

    def kernel_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds any
        of `names`."""
        names = tuple(names)
        hits = [stop - start for start, stop, name, _ in self.device
                if any(n in name for n in names)]
        return sum(hits) / 1e6, len(hits)

    def range_seconds(self, range_name: str) -> float:
        """Device seconds (each interval's uncovered part) of the work
        launched while a host range of this name was open."""
        spans = sorted((lo, hi) for lo, hi, name in self.ranges if name == range_name)
        starts = [lo for lo, _ in spans]
        total = 0.0
        for (start, stop, _, corr), own in zip(self.device, self.own):
            ts = self.launch_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                total += own
        return total / 1e6

    def top_kernels(self, n: int = 10) -> List[list]:
        """[[name, device seconds]] of the n kernels (by name) that took most."""
        by_name: Dict[str, float] = {}
        for start, stop, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, pass_names: Iterable[str], n: int = 10) -> List[list]:
        """[[label, seconds]]: the device's idle time inside the traced
        frames, summed by what the host was doing for most of each gap:
        the pass range it was in (`pass_names`), "readback" (waiting for
        or copying from the device), or "between frames"."""
        pass_names = set(pass_names)
        busy = _union((s, e) for s, e, _, _ in self.device)
        gaps, prev = [], self.t0
        for lo, hi in busy:
            if lo > prev:
                gaps.append((prev, min(lo, self.t1)))
            prev = max(prev, hi)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted([(lo, hi, name) for lo, hi, name in self.ranges if name in pass_names]
                      + [(lo, hi, "readback") for lo, hi in self.waits])
        starts = [h[0] for h in host]
        longest = max((hi - lo for lo, hi, _ in host), default=0.0)
        by_label: Dict[str, float] = {}
        for lo, hi in gaps:
            if hi <= lo:
                continue
            cover: Dict[str, float] = {}
            i = bisect.bisect_left(starts, lo - longest)
            while i < len(host) and host[i][0] < hi:
                h_lo, h_hi, name = host[i]
                ov = min(hi, h_hi) - max(lo, h_lo)
                if ov > 0:
                    cover[name] = cover.get(name, 0.0) + ov
                i += 1
            rest = (hi - lo) - sum(cover.values())
            label = max(cover, key=cover.get) if cover and max(cover.values()) >= rest \
                else "between frames"
            by_label[label] = by_label.get(label, 0.0) + (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:n]]
