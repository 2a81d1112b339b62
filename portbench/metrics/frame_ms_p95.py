"""frame_ms_p95: the 95th percentile of the latency of every frame of the
window, from its submission to its image in host memory."""

from portbench.lib import readers


def read(run):
    return readers.latency_percentile_ms(run, 95.0)
