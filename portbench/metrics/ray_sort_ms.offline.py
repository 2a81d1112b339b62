"""Device ms a frame of the work launched under the program's `ray_sort`
span: the bounce and NEE rays' coherence sort, their permutation before
the trace and the results' inverse permutation after it
(render.traversal.with_ray_sorting and with_ray_sorting_any)."""

from portbench.lib import spans

SPAN = "ray_sort"


def read(run):
    return spans.device_ms(run, SPAN)
