"""The port's session API on the CPU at 16x16: render_loop's chunk means,
the options switches (use_options keeps the history, set_options resets
it), resize, and the viewer panel's variants against the JAX package's.
Frames of one session are deterministic, so two sessions fed the same
calls give bit-equal images; means are compared at atol 1e-6 (a float32
sum over a chunk)."""

import dataclasses

import numpy as np
import pytest
import torch

from capsaicin_tpu.render.session import RenderSession as JSession
from capsaicin_tpu.render.settings import RenderOptions as JOptions
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera
from torch_threads import share_cores

share_cores()

S = 16


def _session(**kw):
    session = RenderSession(S, S, options=RenderOptions(**kw), device="cpu")
    session.set_camera(make_camera("cornell", S, S))
    session.set_scene(build_scene(cornell_box()))
    return session


@pytest.mark.parametrize("frames, chunk", [(4, 2), (5, 3)], ids=["multiple", "remainder"])
def test_render_loop_returns_the_last_chunks_mean(frames, chunk):
    """With accumulate, the mean display of the last chunk (of the
    remainder frames when `frames % chunk` is not 0); without, the last
    frame. The state advances by `frames` either way."""
    ref = _session()
    displays = [ref.render_async() for _ in range(frames)]
    last = frames % chunk or chunk
    mean = torch.stack(displays[-last:]).sum(0) / last
    looped = _session()
    got = looped.render_loop(frames, chunk=chunk, accumulate=True)
    assert looped.state.frame_count == frames
    torch.testing.assert_close(got, mean, rtol=0, atol=1e-6)
    plain = _session()
    assert torch.equal(plain.render_loop(frames, chunk=chunk), displays[-1])
    with pytest.raises(ValueError):
        plain.render_loop(0)


def test_use_options_keeps_history_set_options_resets():
    session = _session()
    for _ in range(2):
        session.render_async()
    session.use_options(RenderOptions(eaw_fused="1", eaw_bf16=True))
    assert session.state.frame_count == 2  # history kept
    session.render_async()
    assert session.options.eaw_fused == "1" and session.state.frame_count == 3
    session.use_options(RenderOptions(history_dtype="float16"))
    assert session.state.frame_count == 0  # the history changes type: reset
    assert session.state.color_history.dtype == torch.float16
    session.render_async()
    session.set_options(RenderOptions(gather=False))
    assert session.state.frame_count == 0 and not session.options.gather
    assert np.isfinite(session.render()).all()


def test_resize_refits_the_sensor_and_resets():
    session = _session()
    session.render_async()
    state = session.state
    session.resize(S, S)  # the same size: nothing changes
    assert session.state is state
    sensor = session.camera.sensor_size.clone()
    session.resize(24, 12)
    assert (session.width, session.height, session.state.frame_count) == (24, 12, 0)
    torch.testing.assert_close(session.camera.sensor_size,
                               torch.stack([sensor[0], sensor[0] * 12 / 24]), rtol=0, atol=0)
    assert session.state.color_history.shape == (12, 24, 4)
    assert session.render().shape == (12, 24, 3)


def test_panel_variants_match_jax():
    base = dict(eaw_fused="0", eaw_bf16=False, num_diffuse_bounces=2, taa=False)
    want = JSession.panel_variants(type("S", (), {"options": JOptions(**base)})())
    got = _session(**base).panel_variants()
    assert [dataclasses.asdict(v) for v in got] == [dataclasses.asdict(v) for v in want]


@pytest.mark.parametrize("bf16", [None, "0", "1", "x"])
@pytest.mark.parametrize("fused", [None, "", "0", "1", "13", "x"])
def test_eaw_defaults_from_the_environment_match_jax(monkeypatch, fused, bf16):
    """RenderOptions() takes its EAW variants from CAPSAICIN_EAW_FUSED and
    CAPSAICIN_EAW_BF16 as the JAX package does: equal defaults, or a
    ValueError from both."""
    for name, value in (("CAPSAICIN_EAW_FUSED", fused), ("CAPSAICIN_EAW_BF16", bf16)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    results = []
    for options in (RenderOptions, JOptions):
        try:
            results.append(dataclasses.asdict(options()))
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]
    if "x" not in (fused, bf16):
        assert results[0]["eaw_fused"] == (fused or "0")
        assert results[0]["eaw_bf16"] == (bf16 == "1")
