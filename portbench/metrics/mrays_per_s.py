"""mrays_per_s: rays of every frame completed in the window (bench.py's
count, portbench.lib.stats.rays_per_frame) over its wall time, which ends
at an image boundary and includes that image's readback."""


def read(run):
    r = run.record
    return r["frames"] * r["rays_per_frame"] / r["window_s"] / 1e6
