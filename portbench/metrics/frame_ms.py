"""frame_ms: the window's wall time over the frames displayed in it; each
frame is the camera update, render() and its image on the host."""

from portbench.lib import readers


def read(run):
    return readers.frame_ms(run)
