"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips, with the reason, where CUDA is unavailable
(the decision is taken inside the fixture, never at import). On a machine
with an NVIDIA GPU and nvcc, run

    CAPSAICIN_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -p no:cacheprovider

(CAPSAICIN_TEST_TPU=1 keeps tests/conftest.py from importing JAX, which
that machine need not have.)"""

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch import kernels
from capsaicin_tpu_torch.ops import camera as cam
from capsaicin_tpu_torch.ops import lookup, static, stencil
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions, default_settings
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    kernels.load()
    return torch.device("cuda")


def _session(w, h, device):
    s = RenderSession(w, h, options=RenderOptions(gather=False), device=device)
    s.set_camera(make_camera("cornell", w, h))
    s.set_scene(build_scene(cornell_box()))
    return s


def test_static_trace_and_hit_attributes(dev):
    w, h = 160, 90
    s = _session(w, h, dev)
    o, d = cam.create_primary_rays(s.camera, cam.pixel_grid(w, h, dev), (w, h), 2)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    tmax = torch.full((o.shape[0],), 1e6, device=dev)
    tmax[::5] = -1.0
    before = static.K1.launches
    t, u, v, prim = static.static_trace(s.accel, o, d, 0.0, tmax, False)
    assert static.K1.launches == before + 1
    tp, up, vp, pp = static.static_trace_plain(s.accel.tris, o, d, 0.0, tmax, False)
    assert torch.equal(prim, pp)
    torch.testing.assert_close(t, tp, rtol=0, atol=1e-5)
    hit = static.static_trace(s.accel, o, d, 0.0, tmax, True)
    assert torch.equal(hit, pp >= 0)
    got = lookup.hit_attributes(s.attr_table, prim, u, v)
    want = lookup.hit_attributes_plain(s.attr_table, prim, u, v)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 3, 5, 7])
def test_eaw_kernels(dev, stride):
    rng = np.random.default_rng(stride)
    h, w = 67, 129
    color4 = torch.from_numpy(rng.random((h, w, 4), dtype=np.float32) * 2).to(dev)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.random((h, w), dtype=np.float32) * 20 + 1
    depth[rng.random((h, w)) < 0.1] = 0
    geo = torch.from_numpy(np.concatenate([n, depth[..., None]], -1)).to(dev)
    mom = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)).to(dev)
    mom[..., 2] = torch.from_numpy(rng.integers(0, 20, (h, w)).astype(np.float32)).to(dev)
    s = default_settings()
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    torch.testing.assert_close(stencil.eaw_disocclusion(color4, geo, mom, *sig),
                               stencil.eaw_disocclusion_plain(color4, geo, mom, *sig),
                               rtol=1e-3, atol=1e-4)
    for use_variance in (True, False):
        torch.testing.assert_close(
            stencil.eaw_stage(color4, geo, stride, use_variance, *sig),
            stencil.eaw_stage_plain(color4, geo, stride, use_variance, *sig),
            rtol=1e-3, atol=1e-4)


def test_render_async_never_waits_for_the_device(dev):
    """After the first frame has uploaded the per-device constants, a frame
    makes no call that synchronises with the device."""
    s = _session(64, 48, dev)
    s.render_async()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(9):  # past the 8-entry Halton cycle
            s.render_async()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_profile_attributes_device_time_to_passes(dev):
    from capsaicin_tpu_torch.render.profiling import profile_frames

    r = profile_frames(_session(160, 90, dev), frames=2, warmup=1, top=1000)
    assert 0.0 < r["busy_ms"] <= r["wall_ms"]
    for name in ("trace_primary", "indirect_gi", "denoise"):
        assert r["passes_ms"][name] > 0.0, name
    assert sum(r["passes_ms"].values()) <= r["busy_ms"] + 1e-6  # one stream: no overlap
    assert any(row["name"].startswith("eaw_stage_kernel") for row in r["top"])


def test_cuda_frames_match_cpu_frames(dev):
    images = {}
    for device in (dev, "cpu"):
        s = _session(48, 32, device)
        for _ in range(3):
            images[str(device)] = s.render()
    assert np.sqrt(np.mean((images["cuda"] - images["cpu"]) ** 2)) <= 1e-3
