"""Multi-device rendering of the port (capsaicin_tpu_torch.parallel and
RenderSession(mesh=...)) on a mesh of 8 x "cpu" in one process: the
counterpart of tests/test_multichip.py and its _multichip_*impl.py.

The plain versions are deterministic and every per-pixel operation sees
the same values in a row block as in the whole image, so the mesh frame is
held BIT-EQUAL to the unsharded port frame (no bar is needed: at a width
that is a multiple of 16 no element falls on a vectorised loop's scalar
tail in one layout and not in the other). Against the JAX package's
single-device frame the bar is the port's parity bar (display RMSE
<= 1e-3, BASELINE.json). The stream traversal's bounce sub-packets differ
per block, so its closest hits may differ on exact ties: held to the
display bar, with the primary hit ids (whose sub-packets coincide) equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from capsaicin_tpu.render.session import RenderSession as JSession
from capsaicin_tpu.render.settings import RenderOptions as JOptions
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import cornell_box as jcornell_box
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.ops import bvh, stencil, stream
from capsaicin_tpu_torch.ops.camera import tilted
from capsaicin_tpu_torch.parallel import sharding as sh
from capsaicin_tpu_torch.render import passes
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions, default_settings
from capsaicin_tpu_torch.render.traversal import build_accel
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import (colonnade, cornell_box, cornell_box_textured,
                                                  make_camera)
from torch_threads import share_cores

share_cores()

N_DEV = 8
W = H = 64
RMSE_BAR = 1e-3
MESH = sh.make_mesh(["cpu"] * N_DEV)
CORNELL = build_scene(cornell_box())


def _session(mesh=None, width=W, height=H, scene=CORNELL, camera="cornell", traversal="bvh",
             **options):
    s = RenderSession(width, height, options=RenderOptions(**options), device="cpu",
                      traversal=traversal, mesh=mesh)
    s.set_camera(make_camera(camera, width, height))
    s.set_scene(scene)
    return s


def _pair(**kw):
    return _session(**kw), _session(mesh=MESH, **kw)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2)))


def _states_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "prev_camera":
            assert all(torch.equal(p, q) for p, q in zip(x, y)), f
        elif f == "frame_count":
            assert x == y
        else:
            assert torch.equal(x, sh.gather_rows(y, "cpu")), f


def test_mesh_session_is_bit_equal_to_the_unsharded_over_three_frames():
    """The default options at 64x64 through the BVH on 8 blocks of 8 rows
    (the EAW chain's halo of 35 rows takes 5 hops): three frames, the
    third with a camera whose reprojection drift passes 0.01 px in some
    blocks only, so the static-camera test must be the mesh's max."""
    ref, mesh = _pair()
    assert mesh.sharding.devices == MESH.devices
    assert [b.rows for b in mesh.sharding.blocks] == [8] * N_DEV
    for frame in range(3):
        if frame == 2:
            camera, prev = tilted(ref.camera, H), ref.state.prev_camera
            ref.set_camera(camera)
            mesh.set_camera(camera)
        want, got = ref.render(), mesh.render()
        if frame == 2:  # the frame's own reprojection, block by block
            geo = passes.reprojection(camera, prev, ref.state.prev_nd_depth, W, H)
            drift = [float(geo["drift"][b.start:b.stop].max()) for b in mesh.sharding.blocks]
            assert min(drift) < 1e-2 < max(drift), drift
        np.testing.assert_array_equal(got, want, err_msg=f"frame {frame}")
        _states_equal(ref.state, mesh.state)
    assert mesh.state.frame_count == 3
    assert all(len(getattr(mesh.state, f)) == N_DEV for f in ("color_history", "prev_nd_depth"))


@pytest.fixture(scope="module")
def jax_frame(tmp_path_factory):
    """A JAX session's first frame at 64x64 (default options, the brute
    traversal: the JAX package's CPU oracle), and its save_state after it."""
    options = JOptions(eaw_fused="0", eaw_bf16=False)
    sess = JSession(W, H, options=options, traversal="brute", camera=jmake_camera("cornell", W, H))
    sess.set_scene(jbuild_scene(jcornell_box()))
    display = sess.render()
    path = str(tmp_path_factory.mktemp("jax") / "state.npz")
    sess.save_state(path)
    return display, path


def test_mesh_frame_matches_the_jax_single_device_frame(jax_frame):
    want, _ = jax_frame
    got = _session(mesh=MESH).render()
    assert got.shape == want.shape == (H, W, 3)
    assert _rmse(got, want) <= RMSE_BAR


def test_jax_state_resumes_on_a_mesh_as_on_one_device(jax_frame):
    _, path = jax_frame
    ref, mesh = _pair()
    for s in (ref, mesh):
        s.load_state(path)
        assert s.state.frame_count == 1
    for frame in range(2):
        np.testing.assert_array_equal(mesh.render(), ref.render(), err_msg=f"frame {frame}")


def test_state_moves_between_a_mesh_and_one_device(tmp_path):
    """save_state of a mesh session loads into an unsharded one, and the
    reverse; the next frames are equal."""
    ref, mesh = _pair(traversal="static", eaw5=False)
    for _ in range(2):
        ref.render_async()
        mesh.render_async()
    for src, dst in ((mesh, _session(traversal="static", eaw5=False)),
                     (ref, _session(mesh=MESH, traversal="static", eaw5=False))):
        path = str(tmp_path / "state.npz")
        src.save_state(path)
        dst.load_state(path)
        assert dst.state.frame_count == 2
        np.testing.assert_array_equal(dst.render(), src.render())


def test_measure_pass_timings_on_a_mesh():
    s = _session(mesh=MESH, width=32, height=16, eaw5=False, taa=False)
    s.render()
    t = s.measure_pass_timings(iters=1)
    assert "TAA" not in t and "Spatial gather" in t and "whole frame" in t, sorted(t)
    assert all(v >= 0.0 for v in t.values())
    assert s.state.frame_count == 1  # the timed frames leave the state


def _rays(n, seed=7):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    return o + torch.tensor([0.0, 1.0, 0.0]), d


@pytest.mark.parametrize("mode, fn", [
    ("bvh", lambda a, o, d, t0, t1: bvh.bvh_closest(a, o, d, t0, t1)),
    ("bvh", lambda a, o, d, t0, t1: bvh.bvh_any(a, o, d, t0, t1)),
    ("stream", lambda a, o, d, t0, t1: stream.stream_closest(a, o, d, t0, t1)),
    ("stream", lambda a, o, d, t0, t1: stream.stream_closest(a, o, d, t0, t1, balance=True)),
], ids=["bvh_closest", "bvh_any", "stream_closest", "stream_balanced"])
def test_shard_trace_equals_the_unsharded_trace(mode, fn):
    """K7's and K10's plain versions (K10 balanced by K11's count too) on
    64 rays a device: the sharded trace is the unsharded one's result, in
    the caller's order; per-ray tmax is cut with the rays."""
    accel = build_accel(convert.scene_from_numpy(CORNELL), mode)
    o, d = _rays(64 * N_DEV)
    tmax = torch.where(torch.arange(o.shape[0]) % 5 == 0, -1.0, 1e6)
    want = fn(accel, o, d, 1e-4, tmax)
    got = sh.shard_trace(MESH, sh.replicated(MESH, accel),
                         lambda a: lambda oo, dd, t0, t1: fn(a, oo, dd, t0, t1))(o, d, 1e-4, tmax)
    if isinstance(want, dict):
        for k in ("t", "u", "v", "prim"):
            assert torch.equal(got[k], want[k]), k
        assert int((want["prim"] >= 0).sum()) > 100
    else:
        assert torch.equal(got, want) and 0 < int(want.sum()) < want.numel()


def _stencil_inputs(h, w, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.0, hi=1.0: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, shape).astype(np.float32))
    color4 = f(h, w, 4)
    moments4 = torch.cat([f(h, w, 2), torch.zeros(h, w, 1), f(h, w, 1, lo=1.0, hi=20.0)], -1)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal = torch.from_numpy(n / np.linalg.norm(n, axis=-1, keepdims=True))
    depth = f(h, w, lo=1.0, hi=5.0)
    depth[3, 5] = depth[h - 1, 7] = 0.0  # background pixels, next to the edges
    return color4, normal, depth, moments4


@pytest.mark.parametrize("variant", [dict(), dict(eaw_fused="1"), dict(eaw_bf16=True)],
                         ids=["eaw5", "eaw_fused1", "eaw_bf16"])
def test_halo_map_denoise_chain_on_8_row_blocks(variant):
    """The 5-stage chain (K3, then strides 1, 3, 5, 7 as K4 or K6 launches)
    per block with the halo of its reach, 35 rows, on blocks of 8 rows (5
    hops): the unsharded chain's result, bit for bit (the JAX test's bars
    are atol 1e-3, and 5e-2 with RMSE 5e-3 under bf16)."""
    options = RenderOptions(**{"eaw_fused": "0", "eaw_bf16": False, **variant})
    settings = default_settings()
    inputs = _stencil_inputs(H, W)
    want = stencil.denoise_chain(*inputs, settings, options)
    sharding = sh.row_sharding(MESH, H)
    reach = stencil.chain_reach(options)
    assert reach == 35 > sharding.blocks[0].rows
    got = sh.halo_map(sharding, lambda *x: stencil.denoise_chain(*x, settings, options), reach,
                      *[sh.shard_rows(sharding, x) for x in inputs])
    assert torch.equal(sh.gather_rows(got, "cpu"), want)


@pytest.mark.parametrize("edge", ["zero", "clamp"])
@pytest.mark.parametrize("reach", [0, 3, 35])
def test_halo_blocks_are_the_padded_image_rows(edge, reach):
    """Each extended block is the image's rows [start - reach, stop +
    reach), padded past the top and bottom with zero or edge rows."""
    x = torch.arange(H * 3, dtype=torch.float32).reshape(H, 3) + 1.0
    sharding = sh.row_sharding(MESH, H)
    pad = (torch.zeros(reach, 3), torch.zeros(reach, 3)) if edge == "zero" else (
        x[:1].expand(reach, 3), x[-1:].expand(reach, 3))
    padded = torch.cat([pad[0], x, pad[1]])
    for b, ext in zip(sharding.blocks, sh.halo_blocks(sh.shard_rows(sharding, x), reach, edge)):
        assert torch.equal(ext, padded[b.start:b.stop + 2 * reach])
    with pytest.raises(ValueError):
        sh.halo_blocks([x], 1, "wrap")


def test_taa_aabb_takes_a_clamped_halo():
    """TAA's 5x5 AABB takes clamped taps: per block with a clamped halo of
    2 rows it is the unsharded AABB; a zero halo differs at the image's
    top and bottom rows only."""
    rng = np.random.default_rng(5)
    combined = torch.from_numpy(rng.uniform(0, 4, (H, W, 3)).astype(np.float32))
    scale = torch.from_numpy(np.where(rng.uniform(size=(H, W)) < 0.5, 5.0, 0.75)
                             .astype(np.float32))
    want = passes.neighbourhood_aabb(combined, scale)
    sharding = sh.row_sharding(MESH, H)
    parts = [sh.shard_rows(sharding, x) for x in (combined, scale)]
    for edge in ("clamp", "zero"):
        got = sh.halo_map(sharding, passes.neighbourhood_aabb, passes.TAA_REACH, *parts,
                          edge=edge)
        got = [sh.gather_rows([g[k] for g in got], "cpu") for k in (0, 1)]
        if edge == "clamp":
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            rows = torch.nonzero((got[0] != want[0]).any(-1).any(-1)).flatten().tolist()
            assert rows and set(rows) <= {0, 1, H - 2, H - 1}, rows


def test_lowres_spp2_textured_on_odd_half_res_blocks():
    """lowres_indirect with spp=2 on the textured box at 64x24: blocks of
    2 and 4 rows, 1 and 2 half-resolution rows (the UPSCALE2X fetch's
    halo crosses blocks, its edge blend only at the image's bottom)."""
    scene = build_scene(*cornell_box_textured())
    ref, mesh = _pair(height=24, scene=scene, traversal="static", lowres_indirect=True, spp=2)
    assert [b.rows for b in mesh.sharding.blocks] == [2, 4] * 4
    for frame in range(2):
        np.testing.assert_array_equal(mesh.render(), ref.render(), err_msg=f"frame {frame}")


def test_colonnade_stream_mesh():
    """colonnade(target_tris=20000) through the stream traversal at 32x32,
    one 128-ray sub-packet a block of primary rays: the primary hits equal,
    the display within the bar (the bounce packets differ per block)."""
    scene = build_scene(colonnade(target_tris=20_000))
    ref, mesh = _pair(width=32, height=32, scene=scene, camera="colonnade", traversal="stream")
    assert mesh.accel.n_blocks > 600
    for frame in range(2):
        (want, ref.state, want_aux), (got, mesh.state, got_aux) = (
            s.frame(collect_aux=True) for s in (ref, mesh))
        assert torch.equal(got_aux.gbuffer_prim, want_aux.gbuffer_prim)
        assert float((want_aux.gbuffer_prim >= 0).float().mean()) > 0.5
        assert _rmse(got, want) <= RMSE_BAR, frame


def test_render_loop_and_resize_on_a_mesh():
    ref, mesh = _pair(width=32, height=32, traversal="static", eaw5=False)
    torch.testing.assert_close(mesh.render_loop(4, chunk=2, accumulate=True),
                               ref.render_loop(4, chunk=2, accumulate=True), rtol=0, atol=0)
    assert mesh.state.frame_count == 4
    for s in (ref, mesh):
        s.resize(32, 16)
    assert [b.rows for b in mesh.sharding.blocks] == [2] * N_DEV
    np.testing.assert_array_equal(mesh.render(), ref.render())
    with pytest.raises(ValueError):
        mesh.resize(32, 12)  # 12 rows do not divide by 8
    assert (mesh.width, mesh.height) == (32, 16)


def test_precompile_variants_on_a_mesh():
    s = _session(mesh=MESH, width=32, height=16, traversal="static")
    variants = [s.options, dataclasses.replace(s.options, history_dtype="float16")]
    assert s.precompile_variants(variants) == 2
    assert s.state.frame_count == 0


def test_mesh_errors():
    with pytest.raises(ValueError, match="must divide by mesh size"):
        RenderSession(W, 60, device="cpu", mesh=MESH)
    with pytest.raises(ValueError):
        sh.make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError):
        RenderSession(W, H, device="cuda", mesh=MESH)
    if not torch.cuda.is_available():
        for devices in (None, ["cuda:0"] * 2):
            with pytest.raises(RuntimeError):
                sh.make_mesh(devices)


@pytest.mark.parametrize("height, n, rows", [
    (1080, 8, [132, 136, 136, 136] * 2), (272, 8, [32, 36] * 4), (64, 8, [8] * 8),
    (24, 8, [2, 4] * 4), (8, 8, [2] * 4), (63, 3, [20, 20, 23]), (1, 1, [1]),
    (1080, 2, [540, 540]), (544, 8, [68] * 8),
])
def test_row_sharding(height, n, rows):
    """Contiguous blocks covering the rows, none empty, every boundary even
    (at a multiple of 4 where there are 4 rows a device)."""
    sharding = sh.row_sharding(sh.make_mesh(["cpu"] * n), height)
    assert [b.rows for b in sharding.blocks] == rows
    assert sharding.blocks[0].start == 0 and sharding.blocks[-1].stop == height
    unit = 4 if height >= 4 * n else 2
    assert all(a.stop == b.start and a.stop % unit == 0
               for a, b in zip(sharding.blocks, sharding.blocks[1:]))
