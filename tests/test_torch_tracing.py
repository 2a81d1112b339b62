"""The port's spans and counters (render.profiling: span, count, counters)
and the benchmark's readers of them, on the CPU at 16x16.

With no profiler a span enters no profiler range and nothing is counted.
Under a CPU torch.profiler a frame's new spans nest where they belong (the
pass ranges in `session.queue`, `gi.feedback_fetch` and `ray_sort` in
`indirect_gi`, `session.readback` after the frame), and the ray counters
equal the rays and the live rays (tmax >= tmin) of the sets the trace
functions were given. Each reader of portbench/metrics/ that reads them is
run on a synthetic trace and on the program's counters, and gives None
where the program has neither. K7's counting build is tested on the card
(tests/test_torch_cuda.py)."""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch.render import pipeline, profiling
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.traversal import with_ray_sorting, with_ray_sorting_any
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera
from torch_threads import share_cores

share_cores()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from portbench.lib import cells  # noqa: E402
from portbench.lib import trace as trace_lib  # noqa: E402

W = H = 16
SETS = ("primary", "shadow", "bounce", "nee")


@pytest.fixture(scope="module")
def session():
    """The Cornell box (K1's plain version), one frame in, so that the
    next frame's bounce hits fetch a history."""
    s = RenderSession(W, H, device="cpu")
    s.set_camera(make_camera("cornell", W, H))
    s.set_scene(build_scene(cornell_box()))
    s.render_async()
    return s


def _profiled(fn, tmp_path):
    """fn() under a CPU torch.profiler; returns the user_annotation spans
    of the exported trace as (start, end, name) in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation")


def test_no_profiler_no_range_and_no_count(session, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    profiling.reset_counters()
    assert not profiling.recording()
    session.render()
    assert profiling.counters() == {}


def test_spans_nest_and_rays_are_counted(session, tmp_path):
    """Each new span inside its range, and the ray counters against the
    rays the frame's trace functions were given, set by set. The bounce
    and NEE rays go through the ray sort (as the BVH mode's do)."""
    given = {k: [0, 0] for k in SETS}  # rays, live rays

    def wrap(fn, ray_set):
        def traced(o, d, tmin, tmax):
            tm = torch.as_tensor(tmax).expand(o.shape[0])
            given[ray_set][0] += o.shape[0]
            given[ray_set][1] += int((tm >= tmin).sum())
            return fn(o, d, tmin, tmax)
        return traced

    closest, any_hit = traces = session._trace
    session._trace = (wrap(closest, "primary"), wrap(any_hit, "shadow"))
    session._sorted_trace = (wrap(with_ray_sorting(closest), "bounce"),
                             wrap(with_ray_sorting_any(any_hit), "nee"))
    profiling.reset_counters()
    try:
        spans = _profiled(session.render, tmp_path)
    finally:
        session._trace, session._sorted_trace = traces, None
    counts = profiling.counters()
    profiling.reset_counters()

    names = [n for _, _, n in spans]
    assert [n for n in names if n in pipeline.PASS_NAMES] == list(pipeline.PASS_NAMES)
    assert names.count("session.queue") == names.count("session.readback") == 1
    assert names.count("gi.feedback_fetch") == 1  # one bounce: the fetch at its hit
    assert names.count("ray_sort") == 4  # bounce and NEE: the sort, and the inverse after

    def within(name, outer):
        (lo, hi), = [(a, b) for a, b, n in spans if n == outer]
        return all(lo <= a and b <= hi for a, b, n in spans if n == name)

    assert all(within(p, "session.queue") for p in pipeline.PASS_NAMES)
    assert within("gi.feedback_fetch", "indirect_gi") and within("ray_sort", "indirect_gi")
    queue_end = [b for _, b, n in spans if n == "session.queue"][0]
    assert all(a >= queue_end for a, _, n in spans if n == "session.readback")

    assert given["primary"] == [W * H, W * H]  # every primary ray is live
    assert 0 < given["bounce"][1] < W * H and 0 < given["nee"][1] < W * H
    for ray_set in SETS:
        assert counts[f"rays.{ray_set}"] == given[ray_set][0] == W * H, ray_set
        assert counts[f"live_rays.{ray_set}"] == given[ray_set][1], ray_set
    assert not any(k.startswith("bvh.") for k in counts)  # K7 did not run


def test_counters_sum_host_and_device_values():
    profiling.reset_counters()
    profiling.count("x", 3)  # no profiler: dropped
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("x", 4)
        profiling.count("x", torch.tensor(5))
        profiling.count("y", torch.count_nonzero(torch.tensor([1.0, -1.0, 2.0]) >= 0.0))
        profiling.count_rays("s", 3, 0.0, torch.tensor([1.0, -1.0, 0.0]))
        profiling.count_rays("t", 7, 1e-4, -1.0)
    assert profiling.counters() == {"x": 9, "y": 2, "rays.s": 3, "live_rays.s": 2,
                                    "rays.t": 7, "live_rays.t": 0}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_the_plain_walk_counts_nothing():
    """On CPU tensors ops.bvh runs the plain walk, which keeps no counters,
    profiler or not."""
    from capsaicin_tpu_torch.ops import bvh

    scene = build_scene(cornell_box())
    accel = bvh.build_bvh(np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1))
    o = torch.zeros((4, 3))
    d = torch.nn.functional.normalize(torch.randn(4, 3, generator=torch.Generator().manual_seed(1)),
                                      dim=1)
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        bvh.bvh_trace(accel, o, d, 0.0, 1e6, False)
    assert profiling.counters() == {}


# -- the benchmark's readers ----------------------------------------------------


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _run(events, frames=2):
    return SimpleNamespace(trace=trace_lib.Trace(events, frames=frames, wall_s=1e-3))


# two frames: each queues its launches under session.queue, then reads back
EVENTS = [
    _ev("user_annotation", trace_lib.FRAME_RANGE, 0, 500),
    _ev("user_annotation", "session.queue", 0, 100),
    _ev("user_annotation", "indirect_gi", 10, 80),
    _ev("user_annotation", "gi.feedback_fetch", 20, 20),
    _ev("user_annotation", "ray_sort", 50, 10),
    _ev("user_annotation", "session.readback", 300, 40),
    _ev("user_annotation", "session.queue", 500, 60),
    _ev("user_annotation", "session.readback", 700, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=3),
    _ev("cuda_runtime", "cudaLaunchKernel", 70, 1, corr=4),
    _ev("cuda_runtime", "cudaLaunchKernel", 510, 1, corr=5),
    _ev("cuda_runtime", "cudaMemcpyAsync", 310, 1, corr=6),
    _ev("kernel", "void at::native::vectorized_gather_kernel<16, long>(...)", 100, 30, corr=1),
    _ev("kernel", "void at::native::vectorized_gather_kernel<16, long>(...)", 130, 10, corr=2),
    _ev("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel(...)", 140, 8,
        corr=3),
    _ev("kernel", "void bvh_trace_kernel<false, true>(...)", 150, 100, corr=4),
    _ev("kernel", "void other_kernel(...)", 600, 5, corr=5),
    _ev("gpu_memcpy", "Memcpy DtoH", 320, 15, corr=6),
]


@pytest.mark.parametrize("metric, value", [
    ("host_queue_ms.fly", (100 + 60) / 1e3 / 2),
    ("readback_ms.fly", (40 + 20) / 1e3 / 2),
    ("launches.fly", 5 / 2),  # the copy was launched by the readback
    ("feedback_fetch_ms.fly", 40 / 1e3 / 2),
    ("feedback_fetch_ms.offline", 40 / 1e3 / 2),
    ("ray_sort_ms.offline", 8 / 1e3 / 2),
])
def test_span_readers(metric, value):
    read = cells.reader(metric)
    assert read(_run(EVENTS)) == pytest.approx(value)
    # the parent program opens no such span: the metric is left out
    assert read(_run([e for e in EVENTS if e["cat"] != "user_annotation"])) is None
    assert read(SimpleNamespace(trace=None)) is None


COUNTS = {"rays.primary": 100, "live_rays.primary": 100, "rays.bounce": 300,
          "live_rays.bounce": 100, "bvh.rays": 200, "bvh.box_tests": 9000,
          "bvh.tri_tests": 1000}


@pytest.mark.parametrize("metric, value", [
    ("live_ray_share.offline", 100.0 * 200 / 400),
    ("bvh_tests_per_ray.offline", 10000 / 200),
    # (9000 x 22 + 1000 x 45) float32 operations over 67e12/s, over 100 us
    ("bvh_trace_roofline.offline", 100.0 * (9000 * 22 + 1000 * 45) / 67e12 / 100e-6),
])
def test_counter_readers(metric, value, monkeypatch):
    read = cells.reader(metric)
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS))
    assert read(_run(EVENTS)) == pytest.approx(value)
    assert read(SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read(_run(EVENTS)) is None
    monkeypatch.delattr(profiling, "counters")  # the parent program keeps no counters
    assert read(_run(EVENTS)) is None
