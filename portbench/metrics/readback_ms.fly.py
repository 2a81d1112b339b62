"""Host ms a frame inside the program's `session.readback` span: the
display image copied to host memory after the frame's sync
(RenderSession.render), as the viewer waits for it."""

from portbench.lib import spans

SPAN = "session.readback"


def read(run):
    return spans.host_ms(run, SPAN)
