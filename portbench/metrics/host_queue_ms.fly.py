"""Host ms a frame inside the program's `session.queue` span: the host
issuing one frame's launches (RenderSession.render_async around frame())."""

from portbench.lib import spans

SPAN = "session.queue"


def read(run):
    return spans.host_ms(run, SPAN)
