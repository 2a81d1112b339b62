"""What the readers of the program's own spans and counters share. The
spans are profiler ranges that capsaicin_tpu_torch opens inside a frame
(`session.queue`, `session.readback`, `gi.feedback_fetch`, `ray_sort`);
the counters are read from capsaicin_tpu_torch.render.profiling, which
sums them over the traced stretch (they count only while a profiler
records). A program that opens no such span or keeps no such counter
gives None, and the metric is left out."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def _spans(run, name: str) -> List[Tuple[float, float]]:
    """The (start, end) microseconds of every host range `name` in the trace."""
    if run.trace is None:
        return []
    return sorted((lo, hi) for lo, hi, n in run.trace.ranges if n == name)


def host_ms(run, name: str) -> Optional[float]:
    """Host ms a frame inside the ranges `name`."""
    spans = _spans(run, name)
    if not spans:
        return None
    return sum(hi - lo for lo, hi in spans) / 1e3 / run.trace.frames


def device_ms(run, name: str) -> Optional[float]:
    """Device ms a frame of the work launched under the ranges `name`
    (each device interval's part that no earlier one covers)."""
    if not _spans(run, name):
        return None
    return run.trace.range_seconds(name) * 1e3 / run.trace.frames


def launches(run, name: str) -> Optional[float]:
    """Device operations (kernels, copies, sets) a frame whose launch,
    tied to them by the CUPTI correlation id, lies inside a range `name`."""
    spans = _spans(run, name)
    if not spans:
        return None
    starts = [lo for lo, _ in spans]
    n = 0
    for _, _, _, corr in run.trace.device:
        ts = run.trace.launch_ts.get(corr)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        n += i >= 0 and spans[i][0] <= ts <= spans[i][1]
    return n / run.trace.frames


def counters(run) -> Optional[dict]:
    """The program's counters over the traced stretch, or None where the
    run was not traced or the program keeps none."""
    if run.trace is None:
        return None
    from capsaicin_tpu_torch.render import profiling

    read = getattr(profiling, "counters", None)
    return read() if read is not None else None


def total(counts: dict, prefix: str) -> int:
    """The sum of the counters whose name starts with `prefix`."""
    return sum(v for k, v in counts.items() if k.startswith(prefix))
