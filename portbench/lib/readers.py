"""What the metric readers under portbench/metrics/ share. A reader that
finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Iterable, Optional

from . import stats


def frame_ms(run) -> Optional[float]:
    """The window's wall time over the frames displayed in it (interactive)."""
    if run.cell.traffic["loop"] != "interactive":
        return None
    return run.record["window_s"] / run.record["frames"] * 1e3


def latency_percentile_ms(run, q: float) -> Optional[float]:
    """The q-th percentile of every frame's latency in the window (interactive)."""
    if run.cell.traffic["loop"] != "interactive":
        return None
    return stats.percentile(run.record["latencies_s"], q) * 1e3


def idle_percent(run) -> Optional[float]:
    """The device's idle share of the traced frames, in percent."""
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share


def range_ms(run, name: str) -> Optional[float]:
    """Device ms a frame of the work launched under the host range `name`."""
    if run.trace is None:
        return None
    return run.trace.range_seconds(name) * 1e3 / run.trace.frames


def kernels_ms(run, names: Iterable[str]) -> Optional[float]:
    """Device ms a frame of the kernels whose name holds one of `names`;
    None where none ran."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(names)
    return seconds * 1e3 / run.trace.frames if launches else None
