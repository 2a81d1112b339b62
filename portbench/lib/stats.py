"""The arithmetic of the end-to-end metrics: rays a frame, percentiles,
quartile spreads."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rays_per_frame(width: int, height: int, bounces: int, spp: int,
                   lowres_indirect: bool = False) -> int:
    """Rays a frame traces, as bench.py counts them: a primary and a shadow
    ray a pixel, and a bounce and a shadow ray a bounce and a sample of
    each indirect pixel (a quarter of them under lowres_indirect)."""
    pixels = width * height
    indirect = pixels // 4 if lowres_indirect else pixels
    return 2 * pixels + 2 * indirect * int(bounces) * max(int(spp), 1)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all `values`, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles over the median
    (statistics.quantiles, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
