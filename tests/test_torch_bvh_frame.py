"""The port's BVH frame on the CPU against the JAX package's, at 32x32 on
the reduced colonnade (colonnade(target_tris=2000): 4,966 triangles) with
the colonnade camera and default options, 3 frames.

The JAX frames come from one module-scoped RenderSession(32, 32,
traversal="bvh"): its scene, BVH and trace functions (the stackless walk)
in one jitted frame that also returns the PassOutputs.
The port renders the same frames through ops/bvh.py (kernel K7's plain
version on CPU tensors) with its own ray-sorting wrappers, and again
through ops/stream.py (K10's and K11's plain versions, traversal="stream",
the JAX package's stream trace functions): the JAX package holds its
stream frame to its BVH frame, so one JAX fixture serves both. Every
PassOutputs field is compared as tests/test_torch_pipeline.py compares
them: hit ids equal except on edge pixels (at most 1%), images to rtol
1e-3 / atol 1e-4 elsewhere, and the display to RMSE <= 1e-3, with one
allowance: on up to 5% of the pixels an image may differ by up to 0.02.
Those are bounce hits on the spheres whose NEE shadow ray flips under one
ulp of its origin (many bounce NEE rays of frames 1 and 2 do, in either
package alone): the JAX package rounds u and v of a hit, or the
interpolated position, an ulp otherwise than the port, and a ray that
leaves a faceted sphere near its terminator is occluded or not by the
next facet. Every trace call itself agrees. Port-only checks: "brute" frames equal
"static" frames, the bounce-ray sort changes no pixel, the stream's block
size changes no pixel, and "auto" takes the BVH above 128 triangles."""

import jax
import numpy as np
import pytest

from capsaicin_tpu.render import pipeline as jpipe
from capsaicin_tpu.render.session import RenderSession as JRenderSession
from capsaicin_tpu.render.settings import RenderOptions as JOptions
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import colonnade as jcolonnade
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu_torch.ops import brute, bvh, stream
from capsaicin_tpu_torch.render import pipeline as tpipe
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.render.traversal import resolve_mode
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box, make_camera
from torch_threads import share_cores

share_cores()

W = H = 32
FRAMES = 3
SMALL = 2000
TOL = dict(rtol=1e-3, atol=1e-4)
RMSE_BAR = 1e-3
FLIP_SHARE, FLIP_MAX = 0.05, 0.02  # the shadow-ray flips (module doc)


@pytest.fixture(scope="module")
def jax_frames():
    """(display, PassOutputs) of each of FRAMES frames, numpy."""
    options = JOptions(eaw_fused="0", eaw_bf16=False)
    js = JRenderSession(W, H, options=options, traversal="bvh")
    js.set_camera(jmake_camera("colonnade", W, H))
    js.set_scene(jbuild_scene(jcolonnade(target_tris=SMALL)))
    assert js._resolved_mode == "bvh"

    @jax.jit
    def frame(scene, bvh, state, camera, settings, noise):
        # the session's frame step with the PassOutputs, less its bounce-ray
        # sort and pixel-block ray order: permutations of the rays that
        # change no result and lengthen the compile
        closest, any_hit, _, _ = js._trace_fns(scene, bvh, options, "bvh")
        return jpipe.render_frame(scene, closest, any_hit, camera, state, settings, noise,
                                  W, H, options, collect_aux=True)

    state, out = js.state, []
    for _ in range(FRAMES):
        display, state, aux = frame(js.scene_dev, js.bvh, state, js.camera, js.settings, js.noise)
        out.append((np.asarray(display), type(aux)(*[np.asarray(x) for x in aux])))
    return out


def _session(w, h, **kw):
    options = RenderOptions(**kw.pop("options", {}))
    return RenderSession(w, h, options=options, device="cpu", **kw)


def _hold_frames(s, jax_frames, any_hit=None):
    """The session's frames, with its sorted trace functions, against the
    JAX frames, pass by pass. `any_hit` replaces the direct-shadow trace."""
    closest, plain_any = s._trace
    any_hit = any_hit or plain_any
    bounce, bounce_any = s._sorted_trace
    state = s.state
    for want_display, want_aux in jax_frames:
        display, state, aux = tpipe.render_frame(
            s.shade, closest, any_hit, s.camera, state, s.settings, s.noise, W, H, s.options,
            collect_aux=True, closest_bounce_fn=bounce, any_bounce_fn=bounce_any)
        bary, prim = aux.gbuffer_bary.numpy(), aux.gbuffer_prim.numpy()
        diff = prim != want_aux.gbuffer_prim
        edge = np.zeros_like(diff)
        for p, b in ((prim, bary), (want_aux.gbuffer_prim, want_aux.gbuffer_bary)):
            u, v = b[..., 0], b[..., 1]
            edge |= (p >= 0) & ((u < 1e-5) | (v < 1e-5) | (1.0 - u - v < 1e-5))
        assert not np.any(diff & ~edge)
        assert diff.mean() <= 0.01
        assert (prim >= 0).mean() > 0.5  # the camera sees the hall
        for field in tpipe.PassOutputs._fields:
            got, want = getattr(aux, field).numpy(), getattr(want_aux, field)
            assert got.shape == want.shape, field
            got, want = got[~diff], want[~diff]
            off = ~np.isclose(got, want, **TOL)
            off = off.reshape(len(off), -1).any(-1)  # pixels beyond TOL
            assert off.mean() <= FLIP_SHARE, (field, off.mean())
            np.testing.assert_allclose(got[off], want[off], rtol=0, atol=FLIP_MAX, err_msg=field)
        img = display.numpy()
        assert np.isfinite(img).all()
        assert float(np.sqrt(np.mean((img - want_display) ** 2))) <= RMSE_BAR


def _colonnade_session(**kw):
    s = _session(W, H, **kw)
    s.set_camera(make_camera("colonnade", W, H))
    s.set_scene(build_scene(colonnade(target_tris=SMALL)))
    return s


def test_bvh_frames_match_jax(jax_frames):
    s = _colonnade_session(traversal="bvh")
    assert isinstance(s.accel, bvh.DeviceBVH)
    _hold_frames(s, jax_frames)


def test_stream_frames_match_jax(jax_frames, monkeypatch):
    """The stream mode's frames (the plain K10 and K11, the sorted and
    balanced bounce traces, the octant-sorted direct shadow rays) against
    the JAX package's BVH frames: the JAX package holds its stream frame
    to its BVH frame (tests/test_stream.py), so that frame is the
    reference here too."""
    calls = []
    count = stream.stream_count_plain
    monkeypatch.setattr(stream, "stream_count_plain", lambda *a: calls.append(1) or count(*a))
    s = _colonnade_session(traversal="stream")
    assert isinstance(s.accel, stream.StreamBVH) and s.accel.block_tris == stream.BLOCK_TRIS
    _hold_frames(s, jax_frames, any_hit=s._sorted_shadow)
    assert len(calls) == FRAMES  # the bounce closest-hit trace was balanced


def test_stream_block_size_changes_no_pixel():
    images = {}
    for block in (32, 64):
        s = _session(16, 16, traversal="stream", stream_block_tris=block)
        s.set_camera(make_camera("colonnade", 16, 16))
        s.set_scene(build_scene(colonnade(target_tris=SMALL)))
        assert s.accel.block_tris == block
        images[block] = [s.render() for _ in range(2)]
    np.testing.assert_allclose(np.stack(images[32]), np.stack(images[64]), rtol=0, atol=1e-6)


def test_brute_frames_equal_static_frames(monkeypatch):
    calls = []
    plain = brute.brute_trace_plain
    monkeypatch.setattr(brute, "brute_trace_plain", lambda *a: calls.append(1) or plain(*a))
    images = {}
    for mode in ("static", "brute"):
        s = _session(16, 16, traversal=mode)
        s.set_camera(make_camera("cornell", 16, 16))
        s.set_scene(build_scene(cornell_box()))
        images[mode] = [s.render() for _ in range(2)]
    assert len(calls) == 8  # the brute frames traced through ops.brute, 4 a frame
    np.testing.assert_array_equal(np.stack(images["brute"]), np.stack(images["static"]))


def test_bounce_ray_sort_changes_no_pixel():
    """The sort is a permutation of the rays, and use_options flips it on
    the next frame: the Cornell box through the BVH mode (a short walk),
    16x16, the same frames either way."""
    images = {}
    for sort in (True, False):
        s = _session(16, 16, traversal="bvh", options=dict(sort_bounce_rays=sort))
        s.set_camera(make_camera("cornell", 16, 16))
        s.set_scene(build_scene(cornell_box()))
        images[sort] = [s.render() for _ in range(2)]
        s.use_options(RenderOptions(sort_bounce_rays=not sort))
        images[sort].append(s.render())
    assert s._sorted_trace is not None
    np.testing.assert_allclose(np.stack(images[True]), np.stack(images[False]), rtol=0, atol=1e-6)


def test_auto_takes_the_bvh_above_128_triangles():
    assert resolve_mode("auto", 128) == "static"
    assert resolve_mode("auto", 129) == "bvh"
    assert resolve_mode("auto", 249_190) == "bvh"
    for mode in ("brute", "bvh", "static", "stream", "wavefront", "cull"):
        assert resolve_mode(mode, 40) == mode
    s = _session(8, 8, traversal="auto")
    s.set_scene(build_scene(colonnade(target_tris=SMALL)))
    assert isinstance(s.accel, bvh.DeviceBVH) and s._sorted_trace is not None
    assert s.accel.leaf_size == bvh.LEAF_SIZE
    with pytest.raises(ValueError):
        resolve_mode("walk", 40)
