"""K7's box tests and triangle tests a ray walked: the program's counters
(bvh.box_tests + bvh.tri_tests) / bvh.rays over the traced request, from
K7's counting build."""

from portbench.lib import spans


def read(run):
    counts = spans.counters(run)
    if not counts or not counts.get("bvh.rays"):
        return None
    return (counts["bvh.box_tests"] + counts["bvh.tri_tests"]) / counts["bvh.rays"]
