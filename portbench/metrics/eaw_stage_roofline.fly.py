"""K4's (eaw_stage, one a-trous stage of the EAW chain, float32) share of
its roofline: the least time of its launches in the traced frames over
their device time, in percent. The least time of one launch at W x H is
the largest of its bytes over the HBM rate, its float32 operations over
the float32 rate and its special-function operations over the MUFU rate
(portbench.lib.peaks, the published H100 SXM peaks at 700 W). Counts
frozen from chip_smoke.py: each byte once (colour 16 B and geo 16 B read,
16 B written a pixel), 25 taps a pixel of 24 float32 operations and 2
special-function operations (lg2, ex2), and 4 special-function operations
a pixel (the reciprocals and the variance's sqrt)."""

from portbench.lib import peaks

KERNEL = "eaw_stage"
BYTES_PER_PIXEL = 16 + 16 + 16
TAPS = 25
OPS_PER_TAP = 24
MUFU_PER_TAP = 2
MUFU_PER_PIXEL = 4


def least_seconds(width: int, height: int):
    px = width * height
    return peaks.least_seconds(px * BYTES_PER_PIXEL, px * TAPS * OPS_PER_TAP,
                               px * (TAPS * MUFU_PER_TAP + MUFU_PER_PIXEL))


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds((KERNEL,))
    if not launches:
        return None
    least, _ = least_seconds(run.width, run.height)
    return 100.0 * least * launches / seconds
