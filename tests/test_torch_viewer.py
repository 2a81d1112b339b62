"""The port's viewer on the CPU: CameraRig against the JAX package's rig on
the same key and mouse sequences (the same host math, so the same
float64 values), to_camera against the JAX camera (float32, equal), the
CLI writing a PNG at 16x16 and raising without CUDA unless asked for the
CPU, ViewerState driving a CPU session, and the page's timings poll."""

import time

import numpy as np
import pytest
import torch

from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu.viewer.input import CameraRig as JRig
from capsaicin_tpu_torch.render.profiling import PASS_NAMES
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions, default_settings
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera, write_obj
from capsaicin_tpu_torch.viewer import cli, web
from capsaicin_tpu_torch.viewer.input import MOUSE_SENSITIVITY, MOVEMENT_SPEED, CameraRig
from torch_threads import share_cores

share_cores()

S = 16

# (keys, dx, dy, dt_ms) steps; None keys: a mouse step
SEQUENCES = {
    "wasd": [({"w"}, 0, 0, 16.0), ({"a", "e"}, 0, 0, 10.0), ({"s", "d", "q"}, 0, 0, 7.5)],
    "yaw90": [(None, 90.0 / (MOUSE_SENSITIVITY * 10.0), 0.0, 10.0), ({"w"}, 0, 0, 16.0)],
    "pitch45": [(None, 0.0, 45.0 / (MOUSE_SENSITIVITY * 10.0), 10.0), ({"d"}, 0, 0, 3.0)],
    "wrap": [(None, 359.0 / MOUSE_SENSITIVITY, 0.0, 1.0), (None, 2.0 / MOUSE_SENSITIVITY, 0, 1.0)],
    "mixed": [(None, 13.0, -7.0, 16.0), ({"w", "d"}, 0, 0, 16.0), (None, -40.0, 22.0, 33.0),
              ({"q", "s"}, 0, 0, 5.0), (None, 3.0, 900.0, 100.0)],
}


def _drive(rig, steps):
    for keys, dx, dy, dt in steps:
        if keys is None:
            rig.handle_mouse(dx, dy, dt_ms=dt)
        else:
            rig.handle_keys(keys, dt_ms=dt)


@pytest.mark.parametrize("which", list(SEQUENCES))
def test_camera_rig_matches_jax(which):
    port, jax = CameraRig.from_camera(make_camera("cornell", S, S)), \
        JRig.from_camera(jmake_camera("cornell", S, S))
    for rig in (port, jax):
        _drive(rig, SEQUENCES[which])
    for f in ("position", "forward", "right", "up"):
        np.testing.assert_array_equal(getattr(port, f), getattr(jax, f), err_msg=f)
    assert (port.yaw, port.pitch) == (jax.yaw, jax.pitch)


def test_camera_rig_reference_kinematics():
    """input_system.cpp:53 and :104-148, as tests/test_input.py holds the
    JAX rig: a speed a millisecond, and a 90-degree yaw."""
    rig = CameraRig()
    p0 = rig.position.copy()
    rig.handle_keys({"w"}, dt_ms=16.0)
    np.testing.assert_allclose(rig.position, p0 + rig.forward * MOVEMENT_SPEED * 16.0, atol=1e-9)
    rig.handle_mouse(90.0 / (MOUSE_SENSITIVITY * 10.0), 0.0, dt_ms=10.0)
    np.testing.assert_allclose(rig.forward, [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(rig.right, [0.0, 0.0, -1.0], atol=1e-6)


@pytest.mark.parametrize("preset", ["cornell", "colonnade"])
def test_to_camera_matches_jax(preset):
    port = CameraRig.from_camera(make_camera(preset, 32, 24))
    jax = JRig.from_camera(jmake_camera(preset, 32, 24))
    _drive(port, SEQUENCES["mixed"])
    _drive(jax, SEQUENCES["mixed"])
    cam = port.to_camera(0.04, 0.036, 24 / 32, device="cpu")
    jcam = jax.to_camera(0.04, 0.036, 24 / 32)
    for name, a, b in zip(cam._fields, cam, jcam):
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_cli_renders_a_png(tmp_path):
    out = tmp_path / "out.png"
    rc = cli.main(["--device", "cpu", "--scene", "cornell", "--width", str(S), "--height",
                   str(S), "--frames", "2", "--out", str(out)])
    assert rc == 0 and out.exists()
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (S, S, 3) and img.max() > 32 and img.min() < 224


def test_cli_needs_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--width", str(S), "--height", str(S), "--frames", "1",
                  "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()
    assert cli.main(["--device", "cpu", "--traversal", "wavefront", "--width", str(S),
                     "--height", str(S), "--frames", "1", "--out", str(tmp_path / "x.png")]) == 0
    assert (tmp_path / "x.png").exists()


def test_cli_obj_and_timings(tmp_path, capsys):
    obj = str(tmp_path / "cb.obj")
    write_obj(obj, cornell_box())
    out = tmp_path / "obj.png"
    assert cli.main(["--device", "cpu", "--obj", obj, "--width", str(S), "--height", str(S),
                     "--frames", "1", "--timings", "--exposure", "0.5", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    for name in PASS_NAMES + ("whole frame",):
        assert f"  {name} " in text
    assert out.exists()


def _cpu_session(**kw):
    session = RenderSession(S, S, options=RenderOptions(**kw), device="cpu")
    session.set_camera(make_camera("cornell", S, S))
    session.set_scene(build_scene(cornell_box()))
    return session


def test_viewer_state_steps_a_cpu_session():
    """Keys, mouse, a knob, an option flip (with its background kick),
    and a resize, each rendering a finite frame."""
    state = web.ViewerState(_cpu_session())
    img, ms, moved = state.step([], 0, 0)
    assert img.shape == (S, S, 3) and np.isfinite(img).all() and ms > 0 and not moved
    p0 = state.rig.position.copy()
    img, _, moved = state.step(["w"], 0, 0)
    assert moved and not np.array_equal(state.rig.position, p0)
    state.step([], 5.0, -3.0, settings_updates={"exposure": 0.3, "bogus": 1})
    assert state.session.settings.exposure == float(np.float32(0.3))
    img, _, _ = state.step([], 0, 0, option_updates={"output": 1, "bogus": 2})
    assert state.session.options.output == 1 and np.isfinite(img).all()
    thread = state.session._bg_thread
    if thread is not None:
        thread.join(timeout=60)
        assert not thread.is_alive()
    assert state.session.bg_served is None  # the kick's default request
    img, _, _ = state.step([], 0, 0, resize=[24, 12])
    assert img.shape == (12, 24, 3) and state.aspect == 0.5
    assert state.session.state.frame_count == 1


class _FakeSession:
    """Enough of a session for ViewerState, rendering at once."""

    def __init__(self):
        self.width = self.height = 8
        self.camera = make_camera("cornell", 8, 8)
        self.settings = default_settings()
        self.options = RenderOptions()
        self.device = torch.device("cpu")

    def render(self, camera=None):
        return np.zeros((8, 8, 3), np.float32)


def test_fps_cap_paces_frames():
    """With a 50 fps cap consecutive frames are held 20 ms apart; with the
    cap off the deadline follows the clock (tests/test_viewer_web.py)."""
    st = web.ViewerState(_FakeSession())
    st.step([], 0, 0, fps_cap=50)
    t0 = time.perf_counter()
    st.step([], 0, 0)
    assert time.perf_counter() - t0 >= 0.019 and st.fps_cap == 50
    st.step([], 0, 0, fps_cap=0)
    assert st.fps_cap == 0 and st._next_frame <= time.perf_counter()


def test_page_polls_the_timings_and_jpeg_encodes():
    assert "refreshTimings" in web._PAGE and "setInterval" in web._PAGE
    assert 'id="tlive"' in web._PAGE and "/timings" in web._PAGE
    data = web._encode_jpeg(np.full((8, 8, 3), 0.5, np.float32))
    assert data[:2] == b"\xff\xd8"
