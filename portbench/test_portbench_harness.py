"""CPU tests of the benchmark harness, its reference and its check:

    python -m pytest portbench/ -q

The test marked `cuda` runs a short cell on the card and skips elsewhere."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run as run_mod
from portbench.lib import cells, check, stats, traffic
from portbench.lib import camera as cam_lib
from portbench.lib import scene as scene_lib
from portbench.lib import trace as trace_lib

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
SMALL = (32, 32)
SMALL_SCENE = {"colonnade": {"target_tris": 3000}}
# the accumulate mix cut to what the CPU renders in seconds
SMALL_MIX = {"frames": 2, "chunk": 2, "options": {"num_diffuse_bounces": 2, "spp": 2}}


def bench_json():
    return cells.load_benchmark(REPO_DIR)


def small(cell):
    """The cell at a test's size: the colonnade cut, the accumulate mix shortened."""
    if cell.traffic["loop"] == "accumulate":
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL_MIX))
    return cell


def run_small(name, seed=2**31 + 11, seconds=0.5, **kw):
    cell = small(cells.resolve(name, bench_json()))
    return run_mod.run_cell(cell, seed, seconds, False, "cpu", size=SMALL,
                            scene_overrides=SMALL_SCENE.get(cell.config["scene"]["generator"]),
                            **kw)


# -- cells and files ---------------------------------------------------------


@pytest.mark.parametrize("name", [w["name"] for w in bench_json()["workloads"]])
def test_cell_resolves_from_its_files(name):
    cell = cells.resolve(name, bench_json())
    assert cell.config["width"] == 1920 and cell.config["height"] == 1080
    assert cell.traffic["loop"] in ("interactive", "accumulate")
    assert check.limits_of(name)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    # every per-layer metric's end-to-end metric is reported in the cell
    e2e = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in e2e for m in cell.per_layer)


def test_new_files_are_picked_up(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries run without an edit to any file that is there."""
    root = tmp_path
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    bench = bench_json()
    cfg = json.loads((root / "portbench/configs/cornell_1080.json").read_text())
    cfg["width"], cfg["height"] = 48, 32
    (root / "portbench/configs/cornell_small.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/still.json").write_text(json.dumps(
        dict(json.loads((root / "portbench/traffic/fly.json").read_text()),
             camera={"drag_px": [0.0, 0.0], "dt_ms": 16.7, "yaw_limit_deg": 20.0,
                     "pitch_limit_deg": 8.0})))
    (root / "portbench/metrics/frames_in_window.py").write_text(
        "def read(run):\n    return float(run.record['frames'])\n")
    (root / "portbench/limits/cornell_small.still.json").write_text(
        (root / "portbench/limits/cornell_1080.fly.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="cornell_small",
                                 file="portbench/configs/cornell_small.json"))
    bench["workloads"].append({"name": "cornell_small.still", "config": "cornell_small",
                               "traffic": "still", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_in_window", "unit": "frames",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["cornell_small.still"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(cells, "TRAFFIC_DIR", str(root / "portbench/traffic"))
    monkeypatch.setattr(cells, "METRICS_DIR", str(root / "portbench/metrics"))
    monkeypatch.setattr(check, "LIMITS_DIR", str(root / "portbench/limits"))
    cell = cells.resolve("cornell_small.still", cells.load_benchmark(str(root)), str(root))
    assert (cell.config["width"], cell.config["height"]) == (48, 32)
    res = run_mod.run_cell(cell, 5, 0.3, False, "cpu")
    assert res["correct"]
    assert res["metrics"]["frames_in_window"]["value"] >= 1
    assert set(res["metrics"]) == {"setup_s", "frames_in_window"}


# -- traffic and arithmetic ----------------------------------------------------


def test_fly_path_is_a_function_of_the_seed():
    mix = json.loads(open(os.path.join(BENCH_DIR, "traffic/fly.json")).read())
    base = cam_lib.preset("cornell", 1920, 1080)

    def poses(seed, n=300):
        p = traffic.poses(mix, base, seed)
        return np.array([np.concatenate([p.next()[k] for k in ("forward", "right", "up")])
                         for _ in range(n)])

    a, b, c = poses(2**31 + 5), poses(2**31 + 5), poses(2**31 + 6)
    assert np.array_equal(a, b)
    assert not np.allclose(a, c)
    yaw0, pitch0 = cam_lib.yaw_pitch(base)
    yaws = np.degrees(np.arctan2(a[:, 0], a[:, 2])) - yaw0
    pitches = np.degrees(np.arcsin(-a[:, 1])) - pitch0
    assert np.abs(yaws).max() <= 20.0 + 1e-6 and np.abs(pitches).max() <= 8.0 + 1e-6
    assert np.abs(yaws).max() > 10.0  # the path moves through the range


def test_rays_per_frame():
    assert stats.rays_per_frame(1920, 1080, 1, 1) == 8_294_400
    assert stats.rays_per_frame(1920, 1080, 4, 4) == 70_502_400
    assert stats.rays_per_frame(1920, 1080, 1, 1, lowres_indirect=True) == 5_184_000


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 50) == pytest.approx(5.5)
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9.0, 10.0, 11.0, 10.0, 10.0, 10.0]) == pytest.approx(0.5 / 10.0)


def test_window_summary_keeps_few_latencies_and_quantiles_of_many():
    few = run_mod.window_summary({"window_s": 7.5, "frames": 32, "latencies_s": [3.7, 3.8]})
    assert few == {"window_s": 7.5, "frames": 32, "latencies": 2, "latencies_s": [3.7, 3.8]}
    many = run_mod.window_summary({"window_s": 40.0, "frames": 100,
                                   "latencies_s": [0.001 * i for i in range(100, 0, -1)]})
    assert "latencies_s" not in many and many["latencies"] == 100
    assert many["q0_s"] == pytest.approx(0.001) and many["q50_s"] == pytest.approx(0.051)
    assert many["q99_s"] == pytest.approx(0.1) and many["max_s"] == pytest.approx(0.1)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_union_ranges_and_gaps():
    """Busy time is the union of device intervals; a kernel's time goes to
    the range open at its launch; idle gaps take the host's label."""
    events = [
        _ev("user_annotation", trace_lib.FRAME_RANGE, 0, 100),
        _ev("user_annotation", "reproject", 0, 40),
        _ev("user_annotation", "denoise", 40, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=2),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 70, 30),
        _ev("kernel", "void eaw_stage_kernel<float>(...)", 10, 20, corr=1),
        _ev("kernel", "void other_kernel(...)", 20, 20, corr=2),  # overlaps 20..30
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 10),
    ]
    t = trace_lib.Trace(events, frames=1, wall_s=100e-6)
    assert t.busy_s == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert t.idle_share == pytest.approx(0.6)
    assert t.kernel_seconds(("eaw_stage",)) == (pytest.approx(20e-6), 1)
    assert t.range_seconds("reproject") == pytest.approx(20e-6)
    assert t.range_seconds("denoise") == pytest.approx(10e-6)  # its part after 30
    gaps = dict(t.idle_gaps(("reproject", "denoise")))
    # [0, 10]: reproject; [40, 60]: denoise (40..60 in it, 60..70 busy); [70, 100]: readback
    assert gaps == {"reproject": pytest.approx(10e-6), "denoise": pytest.approx(20e-6),
                    "readback": pytest.approx(30e-6)}
    assert t.top_kernels(1)[0][0].startswith("void eaw_stage")


# -- the reference against the program -------------------------------------------


@pytest.mark.parametrize("config", ["cornell_1080", "colonnade_1080"])
def test_reference_agrees_with_the_port_on_the_cpu(config):
    """Three 32x32 frames of a moving camera: the reference's displays
    and histories against capsaicin_tpu_torch's CPU path."""
    from capsaicin_tpu_torch import create_session
    from capsaicin_tpu_torch.ops.camera import Camera
    from capsaicin_tpu_torch.render.settings import RenderOptions, make_settings

    from portbench.reference.camera import Camera as RefCamera

    cfg = json.loads(open(os.path.join(BENCH_DIR, "configs", f"{config}.json")).read())
    cfg["width"], cfg["height"] = SMALL
    spec = dict(cfg["scene"], **SMALL_SCENE.get(cfg["scene"]["generator"], {}))
    scene = scene_lib.make_scene(spec)
    session = create_session(*SMALL, device="cpu", traversal=cfg["traversal"],
                             options=RenderOptions(**cfg["options"]),
                             settings=make_settings(**cfg["settings"]))
    base = cam_lib.preset(cfg["camera"], *SMALL)
    session.set_camera(cam_lib.as_camera(base, Camera))
    session.set_scene(scene)
    ref = check.Reference(scene, cfg, cfg["options"], "cpu", run_mod.NOISE_PATH)
    state = None
    yaw, pitch = cam_lib.yaw_pitch(base)
    for k in range(3):
        pose = cam_lib.look(base, yaw + 0.8 * k, pitch)
        image = session.render(cam_lib.as_camera(pose, Camera))
        display, state = ref.frame(pose, state)
        assert np.abs(display.numpy() - image).max() <= 1e-6
        assert (state.color_history - session.state.color_history).abs().max() <= 1e-6
        assert torch.equal(state.prev_nd_inst, session.state.prev_nd_inst)
    assert isinstance(state.prev_camera, RefCamera)


def test_scene_generators_match_the_port():
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box

    for ours, theirs in ((scene_lib.make_scene({"generator": "cornell_box"}),
                          build_scene(cornell_box())),
                         (scene_lib.make_scene({"generator": "colonnade", "target_tris": 8000}),
                          build_scene(colonnade(target_tris=8000)))):
        for f in ours._fields:
            a, b = np.asarray(getattr(ours, f)), np.asarray(getattr(theirs, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


# -- whole runs on the CPU: sound, control, faults ------------------------------


@pytest.mark.parametrize("name", ["cornell_1080.fly", "colonnade_1080.offline64",
                                  "cornell_1080.offline64"])
def test_sound_run_is_correct(name):
    res = run_small(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0.0 for c in res["checks"].values())


@pytest.mark.parametrize("name", ["cornell_1080.fly", "colonnade_1080.offline64",
                                  "cornell_1080.offline64"])
def test_control_fails(name):
    """The program's own lower precision (float16 histories, bfloat16
    stencil storage) is not correct."""
    res = run_small(name, option_overrides={"history_dtype": "float16", "eaw_bf16": True})
    assert not res["correct"], res["checks"]


def _stale_state(monkeypatch):
    """A frame that leaves the session's state as it was."""
    from capsaicin_tpu_torch.render.session import RenderSession

    real = RenderSession.frame

    def frame(self, *a, **kw):
        out = real(self, *a, **kw)
        return (out[0], self.state) + tuple(out[2:]) if kw.get("state") is None else out

    monkeypatch.setattr(RenderSession, "frame", frame)


def _half_batch(monkeypatch):
    """Half of each request's frames left out, the mean taken over the rest
    (interactive: the lower half of the image's rows not rendered)."""
    from capsaicin_tpu_torch.render.session import RenderSession

    real_loop, real_render = RenderSession.render_loop, RenderSession.render

    def render_loop(self, frames, camera=None, chunk=16, accumulate=False):
        return real_loop(self, max(frames // 2, 1), camera, max(chunk // 2, 1), accumulate)

    def render(self, camera=None):
        image = real_render(self, camera).copy()
        image[image.shape[0] // 2:] = 0.0
        return image

    monkeypatch.setattr(RenderSession, "render_loop", render_loop)
    monkeypatch.setattr(RenderSession, "render", render)


def _altered_answer(monkeypatch):
    """One pixel of every displayed image altered where it is produced."""
    from capsaicin_tpu_torch.render import pipeline

    real = pipeline.render_frame

    def render_frame(*a, **kw):
        out = real(*a, **kw)
        display = out[0].clone()
        display[3, 5, 1] += 0.1
        return (display,) + tuple(out[1:])

    monkeypatch.setattr(pipeline, "render_frame", render_frame)


@pytest.mark.parametrize("fault", [_stale_state, _half_batch, _altered_answer])
@pytest.mark.parametrize("name", ["cornell_1080.fly", "colonnade_1080.offline64",
                                  "cornell_1080.offline64"])
def test_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(name)
    assert not res["correct"], (fault.__name__, res["checks"])


# -- what a run refuses -----------------------------------------------------------


def test_no_result_without_a_card(tmp_path):
    """Without a CUDA card (or in a directory that holds only the benchmark)
    a run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    bare = tmp_path / "bare"
    shutil.copytree(BENCH_DIR, bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), bare)
    for cwd in (REPO_DIR, bare):
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                              "cornell_1080.fly", "--seed", "1", "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "capsaicin_tpu_torch_extra", sys)
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert run_mod.forbidden_modules() == ["jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "capsaicin_tpu"}
    found = [(p, m) for p in _modules() for m in _imports(p) if m.split(".")[0] in bad]
    assert found == []


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH_DIR, "reference")
    allowed = {"torch", "numpy", "math", "typing", "dataclasses", "functools", "__future__"}
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert tops <= allowed, (f, tops - allowed)


# -- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.resolve("cornell_1080.fly", bench_json())
    res = run_mod.run_cell(cell, 2**31 + 3, 2.0, False, "cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
