"""The port's CUDA kernels against their plain versions on the card, in
float32 (rtol 1e-3, atol 1e-4) and in bf16 storage (max abs err <= 2e-2
and mean abs err <= 1e-3: a float32 sum taken in another order can flip a
bf16 rounding by an ulp), the launches of a default-options frame, and
frames free of host syncs. K3, K4 and K5 also on images smaller than a
tile and on the edge cases of their tap (s_normal = 0, equal luminances, an
all-background image, depth 0 on the border; K3 also every history at
least 8 and zero normals). K1 is held bit-equal to its plain version with
1, 40 and 128 triangles. The intersectors (K7 BVH walk, K8 brute force)
are held to hit ids equal except at equal t (rtol 1e-4) or on triangle
edges, t/u/v within 1e-5 where the ids agree, and K7 also bit-equal to
its own walk's plain version (the ordered walk), on a persistent grid's
edges too; K8 also bit-equal to its plain version over several tiles of
triangles; the walk benchmark (K9) exactly, at 50 and at 4096 steps; the stream traversal (K10, K11), which pops blocks in the order
of its plain version, to hit ids and counts equal and t/u/v within 1e-5;
K11 also on the edges of its grouping of sub-packets. K6 also on images
smaller than its tile and on the tap's edge cases.

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
from capsaicin_tpu_torch.ops import brute, bvh, lookup, static, stencil, stream, traverse
from capsaicin_tpu_torch.ops import camera as cam
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions, default_settings
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box, make_camera
from capsaicin_tpu_torch.tools import microstep

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    kernels.load()
    return torch.device("cuda")


def _session(w, h, device, scene="cornell", traversal="auto", **kw):
    """A session on the Cornell box, or with scene="colonnade" on the
    reduced colonnade (4,966 triangles, so "auto" takes the BVH)."""
    s = RenderSession(w, h, options=RenderOptions(**kw), device=device, traversal=traversal)
    s.set_camera(make_camera(scene, w, h))
    s.set_scene(build_scene(colonnade(target_tris=2000) if scene == "colonnade" else cornell_box()))
    return s


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 1e-3, (float(err.max()),
                                                                    float(err.mean()))


def _disocc_close(got, want, moments, msg=""):
    """K3 against its plain version: colour as every stencil (float32 rtol
    1e-3, atol 1e-4; bf16 as _bf16_close); the variance, 8 / hist_len *
    |m2 - m1^2| of the blurred moments, which cancels, within 1e-4 plus
    1e-3 of itself (bf16 2^-7, an ulp) plus 1e-3 of its terms before the
    difference (stencil.disocc_variance_scale)."""
    if got.dtype == torch.bfloat16:
        _bf16_close(got[..., :3], want[..., :3])
    else:
        torch.testing.assert_close(got[..., :3], want[..., :3], rtol=1e-3, atol=1e-4, msg=msg)
    err = (got[..., 3].float() - want[..., 3].float()).abs()
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-3
    bar = 1e-4 + rel * want[..., 3].float().abs() + 1e-3 * stencil.disocc_variance_scale(moments)
    assert bool((err <= bar).all()), (msg, float((err - bar).max()))


def _stencil_inputs(dev, h, w, seed):
    rng = np.random.default_rng(seed)
    color4 = torch.from_numpy(rng.random((h, w, 4), dtype=np.float32) * 2).to(dev)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.random((h, w), dtype=np.float32) * 20 + 1
    depth[rng.random((h, w)) < 0.1] = 0
    geo = torch.from_numpy(np.concatenate([n, depth[..., None]], -1)).to(dev)
    mom = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)).to(dev)
    mom[..., 2] = torch.from_numpy(rng.integers(0, 20, (h, w)).astype(np.float32)).to(dev)
    return color4, geo, mom


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
    got = lookup.hit_attributes(s.shade.table, prim, u, v)
    want = lookup.hit_attributes_plain(s.shade.table, prim, u, v)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6)


# K4's and K5's edge cases: the inputs of _stencil_inputs changed as the CPU
# model of their tap is tested (tests/test_torch_stencil_plan.py)
TAP_CASES = ("random", "s_normal0", "equal_luma", "background", "border0")


def _tap_case(color4, geo, sig, case):
    """(color4, geo, sigmas) of an edge case; ndot <= 0 is in every case
    (random normals)."""
    color4, geo = color4.clone(), geo.clone()
    if case == "equal_luma":
        color4[..., :3] = 0.5
        geo[..., :3] = geo[0, 0, :3].clone()
    if case == "background":
        geo[..., 3] = 0.0
    if case == "border0":
        geo[[0, -1], :, 3] = 0.0
        geo[:, [0, -1], 3] = 0.0
    return color4, geo, ((0.0,) + tuple(sig[1:]) if case == "s_normal0" else sig)


@pytest.mark.parametrize("stride", [1, 3, 5, 7])
def test_eaw_kernels(dev, stride):
    """K3 and K4 at an odd size; K4 also on images smaller than one tile,
    heights under 4 * stride, sizes not multiples of the stride and the
    edge cases, with and without the variance, float32 and bf16, one launch
    a call."""
    h, w = 67, 129
    color4, geo, mom = _stencil_inputs(dev, h, w, stride)
    s = default_settings()
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    _disocc_close(stencil.eaw_disocclusion(color4, geo, mom, *sig),
                  stencil.eaw_disocclusion_plain(color4, geo, mom, *sig), mom)
    for use_variance in (True, False):
        torch.testing.assert_close(
            stencil.eaw_stage(color4, geo, stride, use_variance, *sig),
            stencil.eaw_stage_plain(color4, geo, stride, use_variance, *sig),
            rtol=1e-3, atol=1e-4)
    for hh, ww in ((1, 1), (5, 3), (4 * stride - 1, 37), (2 * stride + 1, 3 * stride + 2),
                   (19, 70)):
        c0, g0, _ = _stencil_inputs(dev, hh, ww, hh * ww + stride)
        for case in TAP_CASES:
            c, g, cs = _tap_case(c0, g0, sig, case)
            for use_variance in (True, False):
                before = stencil.K4.launches
                got = stencil.eaw_stage(c, g, stride, use_variance, *cs)
                assert stencil.K4.launches == before + 1
                torch.testing.assert_close(
                    got, stencil.eaw_stage_plain(c, g, stride, use_variance, *cs),
                    rtol=1e-3, atol=1e-4, msg=f"{hh}x{ww} {case} variance={use_variance}")
            cb, gb = c.bfloat16(), g.bfloat16()
            _bf16_close(stencil.eaw_stage(cb, gb, stride, True, *cs),
                        stencil.eaw_stage_plain(cb, gb, stride, True, *cs))


@pytest.mark.parametrize("hw", [(67, 129), (540, 960)], ids=["odd", "lowres1080"])
def test_spatial_gather_kernel(dev, hw):
    """K5 at odd sizes and at the half-resolution shape of a 1080p frame;
    with the odd size, also on images smaller than one tile and the edge
    cases, one launch a call."""
    h, w = hw
    color4, geo, _ = _stencil_inputs(dev, h, w, h)
    indirect = color4[..., :3].contiguous()
    s = default_settings()
    sig = (s.gather_normal_sigma, s.gather_depth_sigma, s.gather_luma_sigma)
    before = stencil.K5.launches
    got = stencil.spatial_gather(indirect, geo, *sig)
    assert stencil.K5.launches == before + 1
    torch.testing.assert_close(got, stencil.spatial_gather_plain(indirect, geo, *sig),
                               rtol=1e-3, atol=1e-4)
    ib, gb = indirect.bfloat16(), geo.bfloat16()
    _bf16_close(stencil.spatial_gather(ib, gb, *sig), stencil.spatial_gather_plain(ib, gb, *sig))
    shapes = ((1, 1), (5, 3), (7, 40), (h, w)) if h < 100 else ()
    for hh, ww in shapes:
        c0, g0, _ = _stencil_inputs(dev, hh, ww, hh + ww)
        for case in TAP_CASES:
            c, g, cs = _tap_case(c0, g0, sig, case)
            ind = c[..., :3].contiguous()
            before = stencil.K5.launches
            got = stencil.spatial_gather(ind, g, *cs)
            assert stencil.K5.launches == before + 1
            torch.testing.assert_close(got, stencil.spatial_gather_plain(ind, g, *cs),
                                       rtol=1e-3, atol=1e-4, msg=f"{hh}x{ww} {case}")
            _bf16_close(stencil.spatial_gather(ind.bfloat16(), g.bfloat16(), *cs),
                        stencil.spatial_gather_plain(ind.bfloat16(), g.bfloat16(), *cs))


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (33, 65), (540, 960)],
                         ids=["1x1", "7x13", "33x65", "lowres1080"])
def test_disocclusion_kernel(dev, hw):
    """K3 in float32 and bf16 on the edge cases of its tap, with histories
    shorter and longer than 8 (blocks that blur and blocks that only pass
    through), every history at least 8, and zero normals (tw = 0); one
    launch a call."""
    h, w = hw
    color4, geo, mom = _stencil_inputs(dev, h, w, h + w)
    s = default_settings()
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    for case in TAP_CASES + ("hist8", "tw0"):
        c, g, cs = _tap_case(color4, geo, sig, case)
        mo = mom.clone()
        if case == "hist8":
            mo[..., 2] += 8.0
        if case == "tw0":
            g[::3, ::2, :3] = 0.0
        before = stencil.K3.launches
        got = stencil.eaw_disocclusion(c, g, mo, *cs)
        assert stencil.K3.launches == before + 1
        _disocc_close(got, stencil.eaw_disocclusion_plain(c, g, mo, *cs), mo, f"{h}x{w} {case}")
        if case == "hist8":  # every pixel passes through: exact
            assert torch.equal(got, stencil.eaw_disocclusion_plain(c, g, mo, *cs))
        b = (c.bfloat16(), g.bfloat16(), mo.bfloat16())
        _disocc_close(stencil.eaw_disocclusion(*b, *cs), stencil.eaw_disocclusion_plain(*b, *cs),
                      b[2], f"{h}x{w} {case} bf16")


def _static_scene_rays(dev, n_tris, n_rays, seed):
    """The first n_tris of the Cornell box's 40 triangles, then random ones
    inside the box; rays from inside and outside the box, a quarter aimed at
    triangle vertices and edge midpoints, every 9th dead."""
    rng = np.random.default_rng(seed)
    sc = build_scene(cornell_box())
    tris = np.stack([sc.tri_v0, sc.tri_v1, sc.tri_v2], 1).astype(np.float32)[:n_tris]
    if n_tris > len(tris):
        c = rng.uniform([-0.8, 0.1, -0.8], [0.8, 1.9, 0.8], (n_tris - len(tris), 1, 3))
        tris = np.concatenate([tris, c + rng.normal(size=(len(c), 3, 3)) * 0.2]).astype(np.float32)
    o = rng.uniform([-1.0, 0.0, -4.0], [1.0, 2.0, 0.9], (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    k = rng.integers(0, n_tris, n_rays // 4)
    st = rng.choice([0.0, 0.5, 1.0], (n_rays // 4, 2))
    st[:, 1] = np.where(st.sum(1) > 1.0, 0.0, st[:, 1])
    target = tris[k, 0] + st[:, :1] * (tris[k, 1] - tris[k, 0]) + st[:, 1:] * (tris[k, 2] - tris[k, 0])
    d[: n_rays // 4] = target - o[: n_rays // 4]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n_rays, 1e6, np.float32)
    tmax[::9] = -1.0
    return (static.build_static(torch.from_numpy(tris).to(dev)),
            *(torch.from_numpy(x).to(dev) for x in (o, d, tmax)))


@pytest.mark.parametrize("n_tris", [1, 40, 128])
def test_static_trace_bit_equal_to_plain(dev, n_tris):
    """K1 bit-equal to its plain version (t, u, v, prim; the any-hit mask)
    with 1, 40 and 128 triangles, a ray count that is not a multiple of
    the block, dead rays, rays through vertices and edges, tmin 0 and 1e-4."""
    scene, o, d, tmax = _static_scene_rays(dev, n_tris, 20_011, n_tris)
    for tmin in (0.0, 1e-4):
        got = static.static_trace(scene, o, d, tmin, tmax, False)
        want = static.static_trace_plain(scene.tris, o, d, tmin, tmax, False)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(static.static_trace(scene, o, d, tmin, tmax, True),
                           static.static_trace_plain(scene.tris, o, d, tmin, tmax, True)[3] >= 0)
    assert int((want[3] >= 0).sum()) > 1000 and not bool((want[3][::9] >= 0).any())


@pytest.mark.parametrize("strides", [(1, 3), (5, 7), (2, 9)])
def test_eaw_pair_and_bf16_kernels(dev, strides):
    """K6 against two plain stages (the intermediate in float32) at an odd
    size, on images smaller than its tile, of one pixel, of several tiles
    with ragged edges, on the tap's edge cases, with and without the
    variance, float32 and bf16, one launch a call; a stride_b its plan
    refuses raises. And the bf16 instances of K3 and K4 against their bf16
    plain versions."""
    h, w = 67, 129
    color4, geo, mom = _stencil_inputs(dev, h, w, strides[1])
    s = default_settings()
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    for use_variance in (True, False):
        before = stencil.K6.launches
        got = stencil.eaw_pair(color4, geo, *strides, use_variance, *sig)
        assert stencil.K6.launches == before + 1
        torch.testing.assert_close(
            got, stencil.eaw_pair_plain(color4, geo, *strides, use_variance, *sig),
            rtol=1e-3, atol=1e-4)
    for hh, ww in ((1, 1), (5, 3), (4 * strides[1] - 1, 37), (131, 257)):
        c0, g0, _ = _stencil_inputs(dev, hh, ww, hh * ww + strides[0])
        for case in TAP_CASES:
            c, g, cs = _tap_case(c0, g0, sig, case)
            for use_variance in (True, False):
                torch.testing.assert_close(
                    stencil.eaw_pair(c, g, *strides, use_variance, *cs),
                    stencil.eaw_pair_plain(c, g, *strides, use_variance, *cs),
                    rtol=1e-3, atol=1e-4, msg=f"{hh}x{ww} {case} variance={use_variance}")
            cb, gb = c.bfloat16(), g.bfloat16()
            _bf16_close(stencil.eaw_pair(cb, gb, *strides, True, *cs),
                        stencil.eaw_pair_plain(cb, gb, *strides, True, *cs))
    with pytest.raises(ValueError):
        stencil.eaw_pair(color4, geo, 1, 23, True, *sig)
    cb, gb, mb = color4.bfloat16(), geo.bfloat16(), mom.bfloat16()
    _bf16_close(stencil.eaw_pair(cb, gb, *strides, True, *sig),
                stencil.eaw_pair_plain(cb, gb, *strides, True, *sig))
    _bf16_close(stencil.eaw_stage(cb, gb, strides[1], True, *sig),
                stencil.eaw_stage_plain(cb, gb, strides[1], True, *sig))
    _bf16_close(stencil.eaw_disocclusion(cb, gb, mb, *sig),
                stencil.eaw_disocclusion_plain(cb, gb, mb, *sig))


@pytest.mark.parametrize("kw, per_frame", [
    (dict(), dict(static_trace=4, hit_attributes=3, spatial_gather=1, eaw_disocclusion=1,
                  eaw_stage=4, eaw_pair=0)),
    (dict(eaw_fused="1"), dict(eaw_stage=0, eaw_pair=2)),
    (dict(eaw_fused="13", eaw_bf16=True), dict(eaw_stage=2, eaw_pair=1, spatial_gather=1)),
    (dict(lowres_indirect=True, spp=2), dict(static_trace=6, hit_attributes=5,
                                              spatial_gather=1)),
    (dict(scene="colonnade"), dict(bvh_trace=4, hit_attributes=3, static_trace=0,
                                   brute_trace=0)),
    (dict(traversal="brute"), dict(brute_trace=4, static_trace=0, bvh_trace=0)),
    (dict(scene="colonnade", traversal="stream"), dict(stream_trace=4, stream_count=1,
                                                      bvh_trace=0, hit_attributes=3)),
], ids=["default", "fused1", "fused13_bf16", "lowres_spp2", "colonnade", "brute",
        "colonnade_stream"])
def test_frame_launch_counts(dev, kw, per_frame):
    s = _session(64, 48, dev, **kw)
    kernels.reset_counts()
    for _ in range(2):
        s.render_async()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY}
    for name, n in per_frame.items():
        assert launches[name] == 2 * n, (name, launches)


@pytest.mark.parametrize("kw", [dict(gather=False), dict(), dict(lowres_indirect=True, spp=2),
                                dict(scene="colonnade"),
                                dict(scene="colonnade", traversal="stream")],
                         ids=["no_gather", "default", "lowres_spp2", "colonnade",
                              "colonnade_stream"])
def test_render_async_never_waits_for_the_device(dev, kw):
    """After the first frame has uploaded the per-device constants, a frame
    makes no call that synchronises with the device."""
    s = _session(64, 48, dev, **kw)
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
    for name in ("trace_primary", "indirect_gi", "spatial_gather", "denoise"):
        assert r["passes_ms"][name] > 0.0, name
    assert sum(r["passes_ms"].values()) <= r["busy_ms"] + 1e-6  # one stream: no overlap
    # kernel templates are named by their signature, "void eaw_stage_kernel<float>(...)"
    assert any("eaw_stage_kernel" in row["name"] for row in r["top"])


def test_cuda_frames_match_cpu_frames(dev):
    images = {}
    for device in (dev, "cpu"):
        s = _session(48, 32, device)
        for _ in range(3):
            images[str(device)] = s.render()
    assert np.sqrt(np.mean((images["cuda"] - images["cpu"]) ** 2)) <= 1e-3


def _hall_rays(dev, n, seed):
    """Rays from inside the colonnade's hall in random directions; every
    7th dead (tmax = -1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-17.0, 0.5, -9.0], [17.0, 7.0, 9.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, 1e6, np.float32)
    tmax[::7] = -1.0
    return [torch.from_numpy(x).to(dev) for x in (o, d, tmax)]


def _hits_agree(got, want, bar=1e-3):
    """got/want (t, u, v, prim): ids equal except at equal t or edges."""
    t, u, v, prim = got
    tw, uw, vw, pw = want
    diff = prim != pw
    edge = torch.zeros_like(diff)
    for p_, u_, v_ in ((prim, u, v), (pw, uw, vw)):
        edge |= (p_ >= 0) & ((u_ < 1e-5) | (v_ < 1e-5) | (1.0 - u_ - v_ < 1e-5))
    tie = (prim >= 0) & (pw >= 0) & ((t - tw).abs() <= 1e-4 * t.abs())
    assert not bool((diff & ~edge & ~tie).any())
    assert float(diff.float().mean()) <= bar
    same = ~diff
    for a, b in ((t, tw), (u, uw), (v, vw)):
        torch.testing.assert_close(a[same], b[same], rtol=0, atol=1e-5)


def _ordered_equal(got, host, o, d, tmin, tmax, any_hit):
    """K7's result bit-equal to its walk's plain version (the ordered walk)."""
    want = traverse.ordered_walk(host, o, d, tmin, tmax, any_hit)
    if any_hit:
        assert torch.equal(got, want["prim"] >= 0)
    else:
        assert all(torch.equal(a, want[k]) for a, k in zip(got, ("t", "u", "v", "prim")))


@pytest.mark.parametrize("leaf_size", [4, 8, 32])
def test_bvh_and_brute_kernels(dev, leaf_size):
    """K7 against its walk's plain version (the ordered walk: bit-equal),
    the stackless walk and K8, and K8 against its plain version (the
    chunked oracle), on a 49,774-triangle colonnade."""
    host = build_scene(colonnade(target_tris=50_000))
    tris = torch.from_numpy(np.stack([host.tri_v0, host.tri_v1, host.tri_v2], 1))
    accel = bvh.build_bvh(tris, leaf_size, device=dev)
    scene = static.pack_triangles(tris.to(dev))
    o, d, tmax = _hall_rays(dev, 4096, leaf_size)
    before = bvh.K7.launches
    k7 = bvh.bvh_trace(accel, o, d, 0.0, tmax, False)
    assert bvh.K7.launches == before + 1
    _ordered_equal(k7, accel.host, o, d, 0.0, tmax, False)
    plain = traverse.bvh_closest(accel.host, o, d, 0.0, tmax)
    _hits_agree(k7, tuple(plain[k] for k in ("t", "u", "v", "prim")))
    k8 = brute.brute_trace(scene, o, d, 0.0, tmax, False)
    k8_plain = brute.brute_trace_plain(scene.tris, o, d, 0.0, tmax, False)
    assert torch.equal(k8[3], k8_plain[3])
    for a, b in zip(k8[:3], k8_plain[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    hit = k8[3] >= 0
    assert int(hit.sum()) > 1000
    assert bool((k8[0][~hit] == 1e30).all()) and bool((k7[0][~hit] == tmax[~hit]).all())
    _hits_agree(k7, tuple(torch.where(hit, x, y) for x, y in zip(k8, (tmax, 0, 0, -1))))
    any7 = bvh.bvh_trace(accel, o, d, 1e-4, tmax, True)
    _ordered_equal(any7, accel.host, o, d, 1e-4, tmax, True)
    assert torch.equal(any7, traverse.bvh_any(accel.host, o, d, 1e-4, tmax))
    assert torch.equal(any7, brute.brute_trace(scene, o, d, 1e-4, tmax, True))
    assert torch.equal(any7, brute.brute_trace_plain(scene.tris, o, d, 1e-4, tmax, True))


@pytest.mark.parametrize("case", ["no_rays", "one_ray", "ragged", "all_dead", "two_leaves"])
def test_bvh_kernel_persistent_grid_edges(dev, case):
    """K7's persistent grid at its edges, held bit-equal to the ordered walk
    and to the CPU path: 0 rays, 1 ray, a count that is not a multiple of
    32 (nor of a block), every ray dead, and a tree of 2 leaves (a single
    two-wide record, once an octant)."""
    if case == "two_leaves":
        tris = np.array([[[-1, -1, 3], [1, -1, 3], [0, 1, 3]], [[-1, -1, 5], [1, -1, 5], [0, 1, 5]],
                         [[2, -1, 4], [4, -1, 4], [3, 1, 4]]], np.float32)
        accel = bvh.build_bvh(tris, 2, device=dev)
        assert accel.n_leaves == 2 and accel.wide.shape[0] == 8  # one record an octant
    else:
        host = build_scene(colonnade(target_tris=2000))
        accel = bvh.build_bvh(np.stack([host.tri_v0, host.tri_v1, host.tri_v2], 1), device=dev)
    n = {"no_rays": 0, "one_ray": 1, "ragged": 1000, "all_dead": 333, "two_leaves": 257}[case]
    o, d, tmax = _hall_rays(dev, max(n, 1), 3)
    o, d, tmax = o[:n], d[:n], tmax[:n]
    if case == "two_leaves":  # from near the origin, towards the triangles
        o = o * 0.05
        ahead = torch.tensor([0.0, 0.0, 1.0], device=dev)
        d = torch.nn.functional.normalize(0.3 * d + ahead, dim=1)
    if case == "all_dead":
        tmax = torch.full_like(tmax, -1.0)
    for any_hit, tmin in ((False, 0.0), (True, 1e-4)):
        before = bvh.K7.launches
        got = bvh.bvh_trace(accel, o, d, tmin, tmax, any_hit)
        assert bvh.K7.launches == before + 1
        _ordered_equal(got, accel.host, o, d, tmin, tmax, any_hit)
        cpu = bvh.bvh_trace(accel, o.cpu(), d.cpu(), tmin, tmax.cpu(), any_hit)
        if any_hit:
            assert torch.equal(got.cpu(), cpu)
        elif n:
            _hits_agree(tuple(x.cpu() for x in got), cpu)
        if case == "two_leaves" and not any_hit:
            assert int((got[3] >= 0).sum()) > n // 4
    info = bvh.kernel_info(dev.index or 0, False, accel.depth)
    assert info["local_bytes"] == 0 and info["warps_per_sm"] >= 8, info


def test_hit_attributes_large_table(dev):
    """K2 reads a table above 128 rows from device memory."""
    rng = np.random.default_rng(5)
    rows = 20_000
    table = torch.from_numpy(rng.uniform(-1, 1, (rows, 29)).astype(np.float32)).to(dev)
    table[:, 27:29] = torch.from_numpy(rng.integers(-1, 8, (rows, 2)).astype(np.float32)).to(dev)
    n = 50_000
    prim = torch.from_numpy(rng.integers(-1, rows, n).astype(np.int32)).to(dev)
    u = torch.from_numpy(rng.random(n, dtype=np.float32) * 0.5).to(dev)
    v = torch.from_numpy(rng.random(n, dtype=np.float32) * 0.5).to(dev)
    before = lookup.K2.launches
    got = lookup.hit_attributes(table, prim, u, v)
    assert lookup.K2.launches == before + 1
    want = lookup.hit_attributes_plain(table, prim, u, v)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", microstep.VARIANTS)
def test_microstep_kernel(dev, variant):
    rays, nodes = microstep.make_inputs(3, seed=1, device=dev)
    before = microstep.K9.launches
    got = microstep.microstep(variant, rays, nodes, 50)
    assert microstep.K9.launches == before + 1
    assert torch.equal(got, microstep.microstep_plain(variant, rays, nodes, 50))


@pytest.mark.parametrize("variant", microstep.VARIANTS)
def test_microstep_kernel_full_steps(dev, variant):
    """K9 at the benchmark's 4096 steps: its walk wraps many times; out
    exactly the plain walk's; no local memory."""
    rays, nodes = microstep.make_inputs(2, seed=2, device=dev)
    got = microstep.microstep(variant, rays, nodes, microstep.STEPS)
    assert torch.equal(got, microstep.microstep_plain(variant, rays, nodes, microstep.STEPS))
    info = microstep.kernel_info(variant, dev.index or 0)
    assert info["local_bytes"] == 0, info


@pytest.mark.parametrize("n_tris", [4978, 4975, 257])
def test_brute_kernel_across_tiles(dev, n_tris):
    """K8 bit-equal to its plain version (t, u, v, prim; the any-hit mask)
    over several tiles of 256: the reduced colonnade with duplicates of 12
    of its first 1,024 triangles appended (ties cross tiles), cut to
    n_tris (the last tile padded, or one triangle past a tile), rays from
    the hall and aimed at the duplicates (a count that is not a multiple of
    the block), t_best starting at a hit's exact t and one ulp above it;
    every ray dead; no local memory."""
    from test_torch_brute_plan import colonnade_case, with_ties

    packed, o, d, tmax = colonnade_case()
    packed = packed[:n_tris]
    scene = static.StaticScene(packed.to(dev))
    for tm in (tmax, with_ties(packed, o, d, tmax), torch.full_like(tmax, -1.0)):
        args = [x.to(dev) for x in (o, d)]
        for any_hit, tmin in ((False, 0.0), (True, 1e-4)):
            before = brute.K8.launches
            got = brute.brute_trace(scene, *args, tmin, tm.to(dev), any_hit)
            assert brute.K8.launches == before + 1
            want = brute.brute_trace_plain(packed, o, d, tmin, tm, any_hit)
            if any_hit:
                assert torch.equal(got.cpu(), want)
            else:
                for a, b in zip(got, want):
                    assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                if tm is tmax:
                    assert int((want[3] >= 0).sum()) > 300
    for any_hit in (False, True):
        info = brute.kernel_info(any_hit, n_tris, dev.index or 0)
        assert info["local_bytes"] == 0 and info["warps_per_sm"] >= 32, info


@pytest.mark.parametrize("block_tris", [32, 64])
def test_stream_kernels(dev, block_tris):
    """K10 and K11 against their plain versions on the four ray sets of a
    reduced-colonnade frame (64x48, the second frame), and the balanced
    closest-hit trace against the unbalanced one."""
    s = RenderSession(64, 48, options=RenderOptions(sort_bounce_rays=False), device=dev,
                      traversal="stream", stream_block_tris=block_tris)
    s.set_camera(make_camera("colonnade", 64, 48))
    s.set_scene(build_scene(colonnade(target_tris=2000)))
    assert s.accel.block_tris == block_tris
    calls = []

    def record(any_hit, fn):
        def traced(o, d, tmin, tmax):
            calls.append((any_hit, o.contiguous(), d.contiguous(), tmin, tmax))
            return fn(o, d, tmin, tmax)
        return traced

    closest, any_fn = s._trace
    s._trace = (record(False, closest), record(True, any_fn))
    for _ in range(2):
        calls.clear()
        s.render_async()
    assert [c[0] for c in calls] == [False, True, False, True]
    for any_hit, o, d, tmin, tmax in calls:
        tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(o.shape[0])
        tmax = tmax.contiguous()
        before = (stream.K10.launches, stream.K11.launches)
        got = stream.stream_trace(s.accel, o, d, tmin, tmax, any_hit)
        counts = stream.count_candidates(s.accel, o, d, tmin, tmax)
        assert (stream.K10.launches, stream.K11.launches) == (before[0] + 1, before[1] + 1)
        plain = stream.stream_trace_plain(s.accel, o, d, tmin, tmax, any_hit)
        assert torch.equal(counts.long(), plain["candidates"])
        reverse = torch.arange(counts.shape[0] - 1, -1, -1, dtype=torch.int32, device=dev)
        if any_hit:
            assert torch.equal(got, plain["hit"])
            assert torch.equal(stream.stream_trace(s.accel, o, d, tmin, tmax, True, reverse), got)
            continue
        assert torch.equal(got[3], plain["prim"])
        for a, k in zip(got[:3], ("t", "u", "v")):
            torch.testing.assert_close(a, plain[k], rtol=0, atol=1e-5)
        bal = stream.stream_closest(s.accel, o, d, tmin, tmax, balance=True)
        assert all(torch.equal(bal[k], x) for k, x in zip(("t", "u", "v", "prim"), got))


def _sub_packet_rays(dev, rng, n):
    """n rays on `dev` in sub-packets of 128: of every four, two fans from a
    point in the colonnade's hall about one direction, a fan of level rays
    and a scattered packet; every ninth ray dead, every fifth short (also
    K11's model's rays in tests/test_torch_stream_plan.py)."""
    o, d = [], []
    for i in range(-(-n // 128)):
        if i % 4 == 3:
            o.append(rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0], (128, 3)))
            d.append(rng.normal(size=(128, 3)))
        elif i % 4 == 2:  # level rays: the y directions straddle 0, x and z not
            o.append(rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0]) +
                     rng.normal(scale=0.05, size=(128, 3)))
            d.append(np.array([0.6, 0.0, 0.8]) + rng.normal(scale=0.1, size=(128, 3)))
        else:
            o.append(rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0]) +
                     rng.normal(scale=0.05, size=(128, 3)))
            d.append(rng.normal(size=3) + rng.normal(scale=0.15, size=(128, 3)))
    o, d = np.concatenate(o)[:n], np.concatenate(d)[:n]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e6, np.float32)
    tmax[::5] = rng.uniform(0.5, 8.0, len(tmax[::5]))
    tmax[::9] = -1.0
    return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (o, d, tmax)]


@pytest.mark.parametrize("case", ["ragged", "dead_sub_packet", "group_tail", "odd_blocks",
                                  "blocks_32768", "unordered", "one_direction"])
def test_stream_count_kernel_edges(dev, case):
    """K11's counts torch.equal to its plain version's with N not a multiple
    of 128, an all-dead sub-packet, a group of sub-packets cut short,
    n_blocks not a multiple of the 128 threads that take the boxes, 32,768
    blocks, valid boxes whose faces are not ordered (the plain test's
    path) and rays of one direction (a directional light's shadow rays),
    one launch a call."""
    rng = np.random.default_rng(sum(map(ord, case)))
    target, block_tris = (20_000, 1) if case == "blocks_32768" else (2000, 8)
    scene = build_scene(colonnade(target_tris=target))
    tris = np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1).astype(np.float32)
    sbvh = stream.build_stream_bvh(tris, block_tris, device=dev)
    n = {"ragged": 128 * 9 + 37, "group_tail": 128 * 70 - 5, "blocks_32768": 384}.get(case, 1280)
    o, d, tmax = _sub_packet_rays(dev, rng, n)
    if case == "dead_sub_packet":
        tmax[128 * 3: 128 * 4] = -1.0
    if case == "one_direction":
        d[:] = torch.tensor([0.3, 0.8, -0.52], device=dev)
    if case == "odd_blocks":
        nb = 128 * (sbvh.n_blocks // 128 - 1) + 77
        sbvh = stream.StreamBVH(sbvh.boxes[:nb].contiguous(),
                                sbvh.tris[: nb * block_tris].contiguous(), nb, block_tris)
    if case == "unordered":
        boxes = sbvh.boxes.clone()
        valid = torch.nonzero(boxes[:, 3] > 0)[:, 0]
        for ax, sel in ((1, valid[::7]), (2, valid[3::11])):
            boxes[sel, ax], boxes[sel, 4 + ax] = boxes[sel, 4 + ax].clone(), boxes[sel, ax].clone()
        sbvh = stream.StreamBVH(boxes, sbvh.tris, sbvh.n_blocks, block_tris)
    before = stream.K11.launches
    got = stream.count_candidates(sbvh, o, d, 0.0, tmax)
    assert stream.K11.launches == before + 1
    want = stream.stream_count_plain(sbvh, o, d, 0.0, tmax)
    assert torch.equal(got, want) and int(want.sum()) > 0


@pytest.mark.parametrize("target_tris,n_blocks", [(20_000, 1 << 15), (80_000, 1 << 17)])
def test_stream_trace_beyond_shared_memory(dev, target_tris, n_blocks):
    """K10 on more blocks than one thread block's shared memory could list
    (the first design's limit was 16,384): reduced colonnades at blocks of
    one triangle, 2^15 and 2^17 blocks, against its plain version on 1024
    rays (fans from points in the hall and scattered rays, some dead),
    closest and any-hit, balanced or not."""
    scene = build_scene(colonnade(target_tris=target_tris))
    tris = np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1).astype(np.float32)
    sbvh = stream.build_stream_bvh(tris, 1, device=dev)
    assert sbvh.n_blocks == n_blocks
    rng = np.random.default_rng(9)
    o, d = [], []
    for _ in range(6):
        c = rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0])
        o.append(c + rng.normal(scale=0.05, size=(128, 3)))
        d.append(rng.normal(size=3) + rng.normal(scale=0.15, size=(128, 3)))
    o.append(rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0], (256, 3)))
    d.append(rng.normal(size=(256, 3)))
    o = torch.from_numpy(np.concatenate(o).astype(np.float32)).to(dev)
    d = np.concatenate(d)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)).to(dev)
    tmax = torch.full((o.shape[0],), 1e6, device=dev)
    tmax[::11] = -1.0
    t, u, v, prim = stream.stream_trace(sbvh, o, d, 0.0, tmax, False)
    plain = stream.stream_trace_plain(sbvh, o, d, 0.0, tmax, False)
    assert torch.equal(prim, plain["prim"]) and int((prim >= 0).sum()) > 500
    for a, k in zip((t, u, v), ("t", "u", "v")):
        torch.testing.assert_close(a, plain[k], rtol=0, atol=1e-5)
    bal = stream.stream_closest(sbvh, o, d, 0.0, tmax, balance=True)
    assert all(torch.equal(bal[k], x) for k, x in zip(("t", "u", "v", "prim"), (t, u, v, prim)))
    hit = stream.stream_trace(sbvh, o, d, 1e-4, tmax, True)
    assert torch.equal(hit, stream.stream_trace_plain(sbvh, o, d, 1e-4, tmax, True)["hit"])
