"""K7's (bvh_trace, the BVH walk) share of its roofline over the traced
request, in percent: the least time of the work it did over the device
time of its launches. The least time is its float32 operations over the
float32 rate (portbench.lib.peaks, the published H100 SXM peak at 700 W):
box tests x 22 + triangle tests x 45, the counts of the program's
counters bvh.box_tests and bvh.tri_tests (K7's counting build), the
operations a test frozen from chip_smoke.py (OPS_BOX: 6 sub, 6 mul, 6
min/max, 4 reductions; OPS_TRI: the Moller-Trumbore crosses, dots and
division). Bytes are not reckoned, so the share can read low, never
over 100%."""

from portbench.lib import peaks, spans

KERNEL = "bvh_trace"
OPS_BOX = 22
OPS_TRI = 45


def read(run):
    counts = spans.counters(run)
    if not counts or "bvh.box_tests" not in counts:
        return None
    seconds, launches = run.trace.kernel_seconds((KERNEL,))
    if not launches:
        return None
    ops = counts["bvh.box_tests"] * OPS_BOX + counts["bvh.tri_tests"] * OPS_TRI
    return 100.0 * ops / peaks.FP32_OPS_PER_S / seconds
