"""The device's idle share of the traced frames: 1 - the union of its
kernel, copy and set intervals over the host's wall time, in percent."""

from portbench.lib import readers


def read(run):
    return readers.idle_percent(run)
