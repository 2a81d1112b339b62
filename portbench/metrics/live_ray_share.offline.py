"""The share of the traced rays that are live (tmax >= tmin), in percent:
the sum of the program's `live_rays.<set>` counters over the sum of its
`rays.<set>` counters, over the sets primary, shadow, bounce and nee of
the traced request. The bounce loop traces every lane and retires the
dead ones; this is the share that does work."""

from portbench.lib import spans


def read(run):
    counts = spans.counters(run)
    if not counts:
        return None
    rays = spans.total(counts, "rays.")
    return 100.0 * spans.total(counts, "live_rays.") / rays if rays else None
