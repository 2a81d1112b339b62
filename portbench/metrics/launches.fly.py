"""Device operations a frame (kernels, copies and sets) launched while the
program's `session.queue` span was open, tied to their launch by the CUPTI
correlation id: the eager launches the host issues for one frame."""

from portbench.lib import spans

SPAN = "session.queue"


def read(run):
    return spans.launches(run, SPAN)
