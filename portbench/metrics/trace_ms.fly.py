"""Device ms a frame of the traversal kernels, matched by name."""

from portbench.lib import readers

KERNELS = ("static_trace", "bvh_trace", "brute_trace", "stream_trace", "stream_count")


def read(run):
    return readers.kernels_ms(run, KERNELS)
