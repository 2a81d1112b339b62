"""Device ms a frame of the work launched under the program's
`gi.feedback_fetch` span: the bounce loop's GBUFFER_FEEDBACK fetch of the
previous frame's combined colour and depth at each bounce hit
(passes._feedback_fetch)."""

from portbench.lib import spans

SPAN = "gi.feedback_fetch"


def read(run):
    return spans.device_ms(run, SPAN)
