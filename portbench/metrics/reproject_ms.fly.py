"""Device ms a frame of the work launched under the program's
"reproject" range (the reprojection and history fetch)."""

from portbench.lib import readers

RANGE = "reproject"


def read(run):
    return readers.range_ms(run, RANGE)
