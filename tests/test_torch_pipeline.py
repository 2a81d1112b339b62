"""The port's whole frame (render_frame on the CPU path) against the JAX
package's, at 32x32.

Two JAX frame sequences are compiled once each for the module (traversal
"brute", the oracle its CPU pipeline uses): the Cornell box with default
RenderOptions (the spatial gather on), 3 frames; and the textured Cornell
box with lowres_indirect=True and spp=2, 2 frames. The port renders the
same frames from identical inputs: every PassOutputs field is compared,
hit ids equal except on edge pixels (at most 1% of them), images to rtol
1e-3 / atol 1e-4, and the display to RMSE <= 1e-3 (BASELINE.json's
accuracy bar). A further case starts the port from the JAX FrameState
after frame 1."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops.camera import Camera as JCamera
from capsaicin_tpu.render import pipeline as jpipe
from capsaicin_tpu.render.settings import RenderOptions as JOptions
from capsaicin_tpu.render.settings import default_settings as jdefault_settings
from capsaicin_tpu.render.traversal import make_traversal as jmake_traversal
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import cornell_box as jcornell_box
from capsaicin_tpu.scene.procedural import cornell_box_textured as jcornell_box_textured
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu.scene.textures import blue_noise_256
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.render import passes as tpasses
from capsaicin_tpu_torch.render import pipeline as tpipe
from capsaicin_tpu_torch.render import shading as tshading
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.render.traversal import build_accel, make_traversal
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, cornell_box_textured, make_camera
from torch_threads import share_cores

share_cores()

W = H = 32
FRAMES = 3
TOL = dict(rtol=1e-3, atol=1e-4)
RMSE_BAR = 1e-3


def _numpy_tree(x):
    if isinstance(x, JCamera):
        return JCamera(*[np.asarray(leaf) for leaf in x])
    if isinstance(x, tuple):
        return type(x)(*[_numpy_tree(leaf) for leaf in x])
    return np.asarray(x)


LOWRES = dict(lowres_indirect=True, spp=2)


def _jax_frames(host_scene, frames, **kw):
    """(display, PassOutputs, state after the frame) of each frame, all
    numpy."""
    options = JOptions(eaw_fused="0", eaw_bf16=False, **kw)
    scene = jax.device_put(host_scene)
    closest, any_hit = jmake_traversal(scene, "brute")

    @jax.jit
    def frame(scene, camera, state, settings, noise):
        return jpipe.render_frame(scene, closest, any_hit, camera, state, settings, noise,
                                  W, H, options, collect_aux=True)

    camera = jmake_camera("cornell", W, H)
    state = jpipe.init_state(W, H, camera, options)
    noise = jnp.asarray(blue_noise_256())
    out = []
    for _ in range(frames):
        display, state, aux = frame(scene, camera, state, jdefault_settings(), noise)
        out.append((np.asarray(display), _numpy_tree(aux), _numpy_tree(state)))
    return out


@pytest.fixture(scope="module")
def jax_frames():
    """The Cornell box, default options."""
    return _jax_frames(jbuild_scene(jcornell_box()), FRAMES)


@pytest.fixture(scope="module")
def jax_lowres_frames():
    """The textured Cornell box, lowres_indirect=True and spp=2."""
    return _jax_frames(jbuild_scene(*jcornell_box_textured()), 2, **LOWRES)


def _port(host_scene, **kw):
    """The port's frame inputs, converted from the JAX package's values."""
    scene = convert.scene_from_numpy(host_scene)
    closest, any_hit = make_traversal("static", build_accel(scene, "static"))
    return dict(
        scene=tshading.shading_scene(scene), closest=closest, any_hit=any_hit,
        camera=convert.camera_from_numpy(jmake_camera("cornell", W, H)),
        settings=convert.settings_from_numpy(jdefault_settings()),
        noise=torch.from_numpy(blue_noise_256()),
        options=RenderOptions(**kw),
    )


@pytest.fixture(scope="module")
def port():
    return _port(jbuild_scene(jcornell_box()))


def _render(port, state):
    return tpipe.render_frame(port["scene"], port["closest"], port["any_hit"], port["camera"],
                              state, port["settings"], port["noise"], W, H, port["options"],
                              collect_aux=True)


def _check_frame(display, aux, want_display, want_aux, frame_count=0, lowres=False):
    """Pass by pass; the half-resolution passes of lowres_indirect on the
    interleave phase's subsample of the hit-id mask."""
    bary, prim = aux.gbuffer_bary.numpy(), aux.gbuffer_prim.numpy()
    diff = prim != want_aux.gbuffer_prim
    edge = np.zeros_like(diff)
    for p, b in ((prim, bary), (want_aux.gbuffer_prim, want_aux.gbuffer_bary)):
        u, v = b[..., 0], b[..., 1]
        edge |= (p >= 0) & ((u < 1e-5) | (v < 1e-5) | (1.0 - u - v < 1e-5))
    assert not np.any(diff & ~edge)
    assert diff.mean() <= 0.01
    same = ~diff
    ox, oy = tpasses.interleave_offset(frame_count)
    for field in tpipe.PassOutputs._fields:
        got = getattr(aux, field).numpy()
        want = getattr(want_aux, field)
        assert got.shape == want.shape, field
        mask = same[oy::2, ox::2] if got.shape[:2] != same.shape else same
        np.testing.assert_allclose(got[mask], want[mask], err_msg=field, **TOL)
    rmse = float(np.sqrt(np.mean((display.numpy() - want_display) ** 2)))
    assert rmse <= RMSE_BAR
    assert np.isfinite(display.numpy()).all()


def test_frames_match_jax(jax_frames, port):
    state = tpipe.init_state(W, H, port["camera"], port["options"])
    for want_display, want_aux, want_state in jax_frames:
        display, state, aux = _render(port, state)
        _check_frame(display, aux, want_display, want_aux)
        assert state.frame_count == int(want_state.frame_count)
        np.testing.assert_allclose(state.moments_history.numpy(), want_state.moments_history,
                                   **TOL)


def test_frames_from_jax_state_match_jax(jax_frames, port):
    state = convert.state_from_numpy(jax_frames[0][2])
    assert state.frame_count == 1
    for want_display, want_aux, _ in jax_frames[1:]:
        display, state, aux = _render(port, state)
        _check_frame(display, aux, want_display, want_aux)


def test_lowres_spp_textured_frames_match_jax(jax_lowres_frames):
    port = _port(jbuild_scene(*jcornell_box_textured()), **LOWRES)
    state = tpipe.init_state(W, H, port["camera"], port["options"])
    for want_display, want_aux, want_state in jax_lowres_frames:
        frame_count = state.frame_count
        display, state, aux = _render(port, state)
        assert aux.indirect_raw.shape == (H // 2, W // 2, 3)
        _check_frame(display, aux, want_display, want_aux, frame_count, lowres=True)
        np.testing.assert_allclose(state.moments_history.numpy(), want_state.moments_history,
                                   **TOL)


def test_session_renders_the_same_frames(jax_frames):
    session = RenderSession(W, H, device="cpu")
    session.set_camera(make_camera("cornell", W, H))
    session.set_scene(build_scene(cornell_box()))
    for want_display, _, _ in jax_frames:
        image = session.render()
        assert image.shape == (H, W, 3)
        assert float(np.sqrt(np.mean((image - want_display) ** 2))) <= RMSE_BAR
    sky = np.float32([0.7, 0.7, 0.85]) ** (1.0 / 2.2)
    np.testing.assert_allclose(image[0, 0], sky, atol=1e-3)
    assert session.state.frame_count == FRAMES


def _render_16(options, scene, frames=2):
    session = RenderSession(16, 16, options=options, device="cpu")
    session.set_camera(make_camera("cornell", 16, 16))
    session.set_scene(scene)
    for _ in range(frames):
        image = session.render()
    return image


@pytest.mark.parametrize("kw", [
    dict(), dict(lowres_indirect=True), dict(spp=4), dict(eaw_fused="13"), dict(eaw_bf16=True),
], ids=["gather", "lowres", "spp", "eaw_fused", "eaw_bf16"])
def test_session_raises_on_unported_options(kw):
    """Every option value renders (the gather on in each): finite pixels
    and the sky in the corner at 16x16 on the CPU."""
    image = _render_16(RenderOptions(**kw), build_scene(cornell_box()))
    assert image.shape == (16, 16, 3) and np.isfinite(image).all()
    np.testing.assert_allclose(image[0, 0], np.float32([0.7, 0.7, 0.85]) ** (1.0 / 2.2),
                               atol=1e-3)


def test_session_renders_textured_scenes_and_every_traversal():
    """The wavefront and cull traversals render a finite 16x16 Cornell frame
    with the sky in the corner; a textured scene (from the JAX package's
    host Scene, with either atlas) renders."""
    from capsaicin_tpu.scene.scene import quantize_atlas as jquantize_atlas

    for mode in ("wavefront", "cull"):
        session = RenderSession(16, 16, device="cpu", traversal=mode)
        session.set_camera(make_camera("cornell", 16, 16))
        session.set_scene(build_scene(cornell_box()))
        assert session._mode == mode
        image = session.render()
        assert image.shape == (16, 16, 3) and np.isfinite(image).all()
        np.testing.assert_allclose(image[0, 0], np.float32([0.7, 0.7, 0.85]) ** (1.0 / 2.2),
                                   atol=1e-3)
    textured = jbuild_scene(*jcornell_box_textured())
    images = [_render_16(RenderOptions(), scene, frames=1)
              for scene in (textured, jquantize_atlas(textured))]
    assert np.isfinite(images[0]).all()
    np.testing.assert_array_equal(images[0], images[1])
    plain = _render_16(RenderOptions(), build_scene(cornell_box()), frames=1)
    assert np.abs(images[0] - plain).max() > 0.05  # the checker floor shows


def test_session_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        RenderSession(W, H)


def test_frame_opens_a_profiler_range_per_pass(tmp_path):
    """The ranges render.profiling attributes kernels to: one
    user_annotation span per pass in the exported trace, in the pass
    order, among the program's other spans (session.queue around them,
    gi.feedback_fetch inside indirect_gi)."""
    from capsaicin_tpu_torch.render.profiling import profile_frames

    session = RenderSession(16, 16, device="cpu")
    session.set_camera(make_camera("cornell", 16, 16))
    session.set_scene(build_scene(cornell_box()))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        session.render_async()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert [name for name in spans if name in tpipe.PASS_NAMES] == list(tpipe.PASS_NAMES)
    with pytest.raises(ValueError):  # device time needs a CUDA session
        profile_frames(session)


def test_profile_summary_attributes_kernels_to_passes():
    """Busy time is the union of the device intervals; a kernel counts
    toward the pass whose range was open when it was launched, with the
    part of it that no earlier interval covers, so the passes add up to
    the busy time."""
    from capsaicin_tpu_torch.render.profiling import summarize_trace

    def span(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                **({"args": {"correlation": corr}} if corr else {})}

    events = [
        span("user_annotation", "trace_primary", 0, 10),
        span("user_annotation", "denoise", 10, 10),
        span("cpu_op", "aten::mul", 2, 5),
        span("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        span("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=2),
        span("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=3),
        span("kernel", "static_trace_kernel", 20, 1000, corr=1),
        span("kernel", "eaw_stage_kernel", 1500, 600, corr=2),
        span("kernel", "eaw_stage_kernel", 1800, 600, corr=3),  # overlaps the one before
    ]
    r = summarize_trace(events, frames=1, wall_ms=4.0)
    assert r["busy_ms"] == pytest.approx(1.0 + 0.9)
    assert r["idle_share"] == pytest.approx(1.0 - 1.9 / 4.0)
    assert r["passes_ms"] == {**dict.fromkeys(tpipe.PASS_NAMES, 0.0),
                              "trace_primary": pytest.approx(1.0), "denoise": pytest.approx(0.9)}
    assert [(row["name"], row["calls"]) for row in r["top"]] == [
        ("eaw_stage_kernel", 2), ("static_trace_kernel", 1)]
