"""Device ms a frame of the work launched under the program's
"indirect_gi" range: the bounce and shadow ray sets, their traces and
their shading."""

from portbench.lib import readers

RANGE = "indirect_gi"


def read(run):
    return readers.range_ms(run, RANGE)
