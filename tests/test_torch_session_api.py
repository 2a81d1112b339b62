"""The port's session API beyond a frame, on the CPU at 16x16: add_scene
against set_scene of the merged scene, save_state/load_state (the resume
bit-equal, the file in the JAX package's format both ways), timings and
measure_pass_timings (the reference's timer names, gated by the options
as the JAX package gates them), precompile_variants/precompile_background,
and the facade. Frames of one session are deterministic, so equal inputs
give bit-equal images. No JAX frame is rendered: its CPU compile costs
minutes."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import capsaicin_tpu
import capsaicin_tpu_torch as cap
from capsaicin_tpu.render import RenderOptions as JOptions
from capsaicin_tpu.render import RenderSession as JSession
from capsaicin_tpu.render.profiling import PASS_NAMES as JPASS_NAMES
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import cornell_box as jcornell_box
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu_torch.render import passes, profiling
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera, write_obj
from capsaicin_tpu_torch.scene.scene import load_scene_obj, merge_scenes
from torch_threads import share_cores

share_cores()

S = 16


def _session(scene=None, **kw):
    session = RenderSession(S, S, options=RenderOptions(**kw), device="cpu")
    session.set_camera(make_camera("cornell", S, S))
    if scene is not None:
        session.set_scene(scene)
    return session


def _two_objs(tmp_path):
    """The Cornell box, and its tall box moved toward the camera, as OBJs."""
    box = cornell_box()

    def moved(m):
        pos = np.asarray(m.positions, np.float32).reshape(-1, 3) + np.float32([0.4, 0, 0.3])
        return dataclasses.replace(m, positions=list(pos.reshape(-1)))

    extra = [moved(m) for m in box if m.name == "tallBox"]
    paths = [str(tmp_path / "a.obj"), str(tmp_path / "b.obj")]
    write_obj(paths[0], box)
    write_obj(paths[1], extra)
    return paths


def test_add_scene_equals_set_scene_of_the_merge(tmp_path):
    """Two OBJ loads accumulate (repeated LoadSceneFromOBJ); the first
    add_scene is set_scene. The frames equal those of one session given
    the merged scene."""
    a, b = (load_scene_obj(p) for p in _two_objs(tmp_path))
    added = _session()
    added.add_scene(a)
    first = added.render()
    added.add_scene(b)
    assert added.scene_host.num_meshes == 8 and added.scene_host.num_triangles == 52
    assert added.state.frame_count == 0  # a new scene resets accumulation
    ref = _session(merge_scenes(a, b))
    for _ in range(2):
        got, want = added.render(), ref.render()
        np.testing.assert_array_equal(got, want)
    assert np.abs(got - first).max() > 1e-3  # the added box shows


@pytest.mark.parametrize("history", ["float32", "float16"])
def test_save_load_state_resumes_bit_equal(tmp_path, history):
    scene = build_scene(cornell_box())
    s1 = _session(scene, history_dtype=history)
    for _ in range(3):
        s1.render_async()
    path = str(tmp_path / "ckpt.npz")
    s1.save_state(path)
    s1.render_async()
    want = s1.render()
    s2 = _session(scene, history_dtype=history)
    s2.load_state(path)
    assert s2.state.frame_count == 3 and isinstance(s2.state.frame_count, int)
    assert s2.state.color_history.dtype == s1.state.color_history.dtype
    s2.render_async()
    np.testing.assert_array_equal(s2.render(), want)


@pytest.mark.parametrize("history", ["float32", "float16"])
def test_state_file_is_the_jax_packages(tmp_path, history):
    """The port's file has the keys, shapes and dtypes of the JAX
    package's save_state, and each package's load_state reads the other's
    file (no frame rendered)."""
    jsess = JSession(S, S, traversal="brute", options=JOptions(history_dtype=history))
    jsess.set_camera(jmake_camera("cornell", S, S))
    jsess.set_scene(jbuild_scene(jcornell_box()))
    jpath, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsess.save_state(jpath)
    port = _session(build_scene(cornell_box()), history_dtype=history)
    port.render_async()
    port.save_state(path)
    with np.load(jpath) as jd, np.load(path) as d:
        assert sorted(d.files) == sorted(jd.files)
        for k in jd.files:
            assert (d[k].shape, d[k].dtype) == (jd[k].shape, jd[k].dtype), k
        saved = {k: d[k] for k in d.files}
    jsess.load_state(path)  # the JAX package resumes the port's file
    assert int(jsess.state.frame_count) == 1
    np.testing.assert_array_equal(np.asarray(jsess.state.color_history), saved["color_history"])
    np.testing.assert_array_equal(np.asarray(jsess.state.prev_camera.position), saved["cam_0"])
    port.load_state(jpath)  # and the port the JAX package's
    assert port.state.frame_count == 0
    assert port.state.prev_nd_inst.dtype == torch.int32
    np.testing.assert_array_equal(port.state.prev_camera.sensor_size.numpy(),
                                  np.asarray(jsess.camera.sensor_size))


def test_timings_hold_the_last_renders_seconds():
    session = _session(build_scene(cornell_box()))
    assert session.timings == {}
    session.render()
    t = session.timings
    assert list(t) == ["frame"] and t["frame"] > 0.0
    t["frame"] = -1.0  # a copy
    assert session.timings["frame"] > 0.0


@pytest.mark.parametrize("method", ["inframe", "isolated"])
def test_pass_timings_have_the_reference_names(method):
    """Default options: every timer of the JAX package's table and the
    whole frame, each >= 0, the passes inside the frame; the state and the
    next frame are left as they were."""
    scene = build_scene(cornell_box())
    session = _session(scene)
    ref = _session(scene)
    session.render_async()
    ref.render_async()
    t = session.measure_pass_timings(iters=1, method=method)
    assert list(t) == list(JPASS_NAMES) + ["whole frame"]
    assert profiling.PASS_NAMES == JPASS_NAMES
    assert all(v >= 0.0 for v in t.values())
    assert sum(t[k] for k in JPASS_NAMES) <= t["whole frame"]
    assert session.state.frame_count == 1
    np.testing.assert_array_equal(session.render(), ref.render())
    with pytest.raises(ValueError):
        session.measure_pass_timings(method="prefix")


def test_pass_timings_follow_the_options(monkeypatch):
    """gather and taa off drop their timers, as in the JAX package
    (tests/test_session_variants.py); the spp loop runs inside "RT
    Indirect diffuse"."""
    session = _session(build_scene(cornell_box()), gather=False, taa=False, spp=2)
    t = session.measure_pass_timings(iters=1)
    assert set(t) == (set(JPASS_NAMES) | {"whole frame"}) - {"Spatial gather", "TAA"}
    open_timers, seen = [], []

    @contextlib.contextmanager
    def recorder(name):
        open_timers.append(name)
        yield
        open_timers.pop()

    indirect = passes.indirect_gi

    def spy(*a, **kw):
        seen.append(list(open_timers))
        return indirect(*a, **kw)

    monkeypatch.setattr(passes, "indirect_gi", spy)
    session.frame(timer=recorder)
    assert seen == [["RT Indirect diffuse"]] * 2


def test_precompile_variants_counts_new_ones_and_leaves_the_frame():
    scene = build_scene(cornell_box())
    session, ref = _session(scene), _session(scene)
    for s in (session, ref):
        s.render_async()
    variants = [session.options, dataclasses.replace(session.options, output=1),
                dataclasses.replace(session.options, history_dtype="float16", taa=False)]
    state = session.state
    assert session.precompile_variants(variants) == 3
    assert session.precompile_variants(variants) == 0  # all run before
    assert session.precompile_variants(variants[:1] + [
        dataclasses.replace(session.options, gather=False)]) == 1
    assert session.state is state
    np.testing.assert_array_equal(session.render(), ref.render())
    session.resize(S, 8)  # another size: the variants are new again
    assert session.precompile_variants(variants[:2]) == 2
    with pytest.raises(RuntimeError):
        _session().precompile_variants()


def test_precompile_variants_default_is_the_panel():
    session = _session(build_scene(cornell_box()), denoise=False, gather=False, taa=False,
                       num_diffuse_bounces=0)
    assert session.precompile_variants() == len(session.panel_variants())


def test_precompile_background_kicks_coalesce():
    """Kicks while the worker runs go to the same thread, and the last
    request is the one it ends with (JAX: tests/test_session_variants.py)."""
    session = _session(build_scene(cornell_box()))
    v1 = [dataclasses.replace(session.options, output=1)]
    v2 = [dataclasses.replace(session.options, output=3)]
    with session._precompile_lock:  # hold the worker
        t1 = session.precompile_background(v1)
        t2 = session.precompile_background(v2)
        assert t2 is t1
    t1.join(timeout=60)
    assert not t1.is_alive() and session.bg_served == v2
    t3 = session.precompile_background()  # the worker retired: a new one
    t3.join(timeout=60)
    assert t3 is not t1 and session.bg_served is None


def test_facade_matches_jax(monkeypatch):
    assert cap.__all__ == capsaicin_tpu.__all__
    for name in cap.__all__:
        assert hasattr(cap, name), name
    cap.init("cpu")
    assert cap._initialized
    cap.shutdown()
    assert not cap._initialized
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cap.init()  # the card by default, and no quiet fall-back
    with pytest.raises(RuntimeError):
        cap.create_session(S, S)
    session = cap.create_session(S, S, device="cpu")
    session.set_camera(make_camera("cornell", S, S))
    merged = cap.merge_scenes(cap.build_scene(cornell_box()), cap.build_scene(cornell_box()))
    assert isinstance(merged, cap.Scene) and merged.num_triangles == 80
    session.set_scene(merged)
    assert np.isfinite(session.render()).all()
    assert isinstance(cap.default_camera(), cap.Camera)


def test_load_scene_obj_through_the_facade(tmp_path):
    path = str(tmp_path / "cb.obj")
    write_obj(path, cornell_box())
    scene = cap.load_scene_obj(path)
    assert scene.num_triangles == 40 and scene.num_meshes == 7
    assert os.path.exists(str(tmp_path / "cb.mtl"))
