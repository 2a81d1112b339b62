"""The port's stream traversal (ops/stream.py: the plain versions of K10
and K11 on CPU tensors) against the JAX package's (capsaicin_tpu/ops/
stream.py, its Pallas kernels in interpret mode), on the reduced colonnade
(colonnade(target_tris=2000): 4,966 triangles).

Both packages get the same numpy triangles and rays. The builds must be
equal array for array. The JAX kernels run four times in all (count,
closest and any-hit at block 32, closest at block 64; each takes seconds in
interpret mode), on one set of 640 rays: five sub-packets, four of them
coherent fans from points in the hall and one scattered, every ninth ray
dead. Hit ids must be equal except on equal-t or edge rays, t to rtol
1e-5, u and v to atol 1e-5, the miss t 1e30, the any-hit flags and the
candidate counts exactly. The rest is port-only: the plain stream against
the port's brute force, the balanced trace against the unbalanced one, the
balance permutation against the JAX package's (jnp only), an all-dead
sub-packet and scenes of fewer than 128 blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops import stream as jstream
from capsaicin_tpu.ops.pallas_traverse import pack_rays_tiled
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.ops import brute, static, stream
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box
from torch_threads import share_cores

share_cores()

SMALL = 2000
N_RAYS = 640  # five sub-packets


def _tris(scene):
    return np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1).astype(np.float32)


@pytest.fixture(scope="module")
def tris():
    return _tris(build_scene(colonnade(target_tris=SMALL)))


@pytest.fixture(scope="module")
def rays():
    """(origins, dirs, tmax) numpy: four fans of 128 rays, each from a
    point in the hall about one direction, then 128 scattered rays."""
    rng = np.random.default_rng(7)
    o, d = [], []
    for _ in range(4):
        c = rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0])
        axis = rng.normal(size=3)
        o.append(c + rng.normal(scale=0.05, size=(128, 3)))
        d.append(axis / np.linalg.norm(axis) + rng.normal(scale=0.15, size=(128, 3)))
    o.append(rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0], (128, 3)))
    d.append(rng.normal(size=(128, 3)))
    o = np.concatenate(o).astype(np.float32)
    d = np.concatenate(d).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(N_RAYS, 1e6, np.float32)
    tmax[::9] = -1.0
    return o, d, tmax


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


def _jax_closest(tris, rays, block_tris):
    o, d, tmax = rays
    out = jstream.stream_closest(jstream.build_stream_bvh(tris, block_tris), jnp.asarray(o),
                                 jnp.asarray(d), 0.0, jnp.asarray(tmax))
    return {k: np.asarray(x) for k, x in out.items()}


@pytest.fixture(scope="module")
def jax_results(tris, rays):
    """The JAX package's counts, closest and any-hit at block 32 (three
    interpret-mode kernel runs)."""
    o, d, tmax = (jnp.asarray(x) for x in rays)
    sbvh = jstream.build_stream_bvh(tris)
    tiled, _ = pack_rays_tiled(o, d, 0.0, tmax)
    return {"counts": np.asarray(jstream._count_candidates(sbvh, tiled)),
            "closest": _jax_closest(tris, rays, jstream.BLOCK_TRIS),
            "any": np.asarray(jstream.stream_any(sbvh, o, d, 1e-4, tmax))}


def _hold_closest(got, want, min_hits=100):
    """Hit ids equal except on equal-t or edge rays; t, u, v close."""
    prim, wp = got["prim"].numpy(), want["prim"]
    diff = prim != wp
    edge = np.zeros_like(diff)
    for p, u, v in ((prim, got["u"].numpy(), got["v"].numpy()), (wp, want["u"], want["v"])):
        edge |= (p >= 0) & ((u < 1e-5) | (v < 1e-5) | (1.0 - u - v < 1e-5))
    t, wt = got["t"].numpy(), want["t"]
    tie = (prim >= 0) & (wp >= 0) & np.isclose(t, wt, rtol=1e-4, atol=0)
    assert not np.any(diff & ~edge & ~tie)
    same = ~diff
    np.testing.assert_allclose(t[same], wt[same], rtol=1e-5, atol=0)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k].numpy()[same], want[k][same], rtol=0, atol=1e-5)
    assert np.all(t[wp < 0] == 1e30) and np.all(wt[wp < 0] == np.float32(1e30))
    assert (wp >= 0).sum() >= min_hits  # the rays do hit the scene


@pytest.mark.parametrize("block_tris", [32, 64])
def test_build_matches_jax(tris, block_tris):
    """Leaf boxes, validity, each block's ids and v0/e1/e2 equal the JAX
    build's; the JAX arrays carried across equal the port's build."""
    got = stream.build_stream_bvh(tris, block_tris)
    want = jstream.build_stream_bvh(tris, block_tris)
    b = want.n_blocks
    assert (got.n_blocks, got.block_tris) == (b, block_tris)
    boxes = np.asarray(want.boxes)
    g = got.boxes.numpy()
    np.testing.assert_array_equal(g[:, 0:3], boxes[0:3, :b].T)
    np.testing.assert_array_equal(g[:, 4:7], boxes[3:6, :b].T)
    np.testing.assert_array_equal(g[:, 3], boxes[6, :b])
    assert 0 < g[:, 3].sum() < b  # the colonnade leaves empty blocks
    rec = np.asarray(want.tris)[:, :, :80].reshape(b * block_tris, 10)
    slots = got.tris.numpy()
    np.testing.assert_array_equal(slots.view(np.int32)[:, 3], rec[:, 9].astype(np.int32) - 1)
    for f in range(3):
        np.testing.assert_array_equal(slots[:, 4 * f:4 * f + 3], rec[:, 3 * f:3 * f + 3])
    carried = convert.stream_bvh_from_numpy(boxes, np.asarray(want.tris), b, block_tris)
    assert torch.equal(carried.boxes, got.boxes)
    assert torch.equal(carried.tris.view(torch.int32), got.tris.view(torch.int32))


def test_count_matches_jax(tris, rays, jax_results):
    o, d, tmax = _torch(*rays)
    got = stream.count_candidates(stream.build_stream_bvh(tris), o, d, 0.0, tmax)
    want = jax_results["counts"][:N_RAYS // stream.LANE]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert len(set(want.tolist())) > 2  # the sub-packets differ in work


def test_closest_matches_jax(tris, rays, jax_results):
    o, d, tmax = _torch(*rays)
    got = stream.stream_closest(stream.build_stream_bvh(tris), o, d, 0.0, tmax)
    _hold_closest(got, jax_results["closest"])


def test_any_matches_jax(tris, rays, jax_results):
    o, d, tmax = _torch(*rays)
    got = stream.stream_any(stream.build_stream_bvh(tris), o, d, 1e-4, tmax)
    np.testing.assert_array_equal(got.numpy(), jax_results["any"])
    assert not got[::9].any()  # dead rays report no hit


def test_block64_closest_matches_jax(tris, rays):
    o, d, tmax = _torch(*rays)
    got = stream.stream_closest(stream.build_stream_bvh(tris, 64), o, d, 0.0, tmax)
    _hold_closest(got, _jax_closest(tris, rays, 64))


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_work_counts(tris, rays, jax_results, any_hit):
    """K10's work as the plain version counts it: a warp pops at most the
    candidates; box tests at most its live lanes x its pops; triangle tests
    at most the box tests x block_tris, and fewer than every live lane
    against every slot of its warp's pops (the per-ray box test skips
    blocks); the results those of the JAX package."""
    o, d, tmax = _torch(*rays)
    sbvh = stream.build_stream_bvh(tris)
    tmin = 1e-4 if any_hit else 0.0
    out = stream.stream_trace_plain(sbvh, o, d, tmin, tmax, any_hit)
    assert out["streamed"].shape == (N_RAYS // stream.LANE, stream.WARPS)
    assert bool((out["streamed"] <= out["candidates"][:, None]).all())
    live = (tmax >= tmin).reshape(-1, stream.WARPS, stream.WARP).sum(2)
    lane_pops = (live * out["streamed"]).sum(1)
    slots = lane_pops * sbvh.block_tris
    assert bool((out["box_tests"] <= lane_pops).all())
    assert bool((out["tests"] <= out["box_tests"] * sbvh.block_tris).all())
    assert bool((out["tests"] <= slots).all()) and int(out["tests"].sum()) > 0
    assert int(out["tests"].sum()) < int(slots.sum())
    if any_hit:
        np.testing.assert_array_equal(out["hit"].numpy(), jax_results["any"])
    else:
        _hold_closest(out, jax_results["closest"])


def _brute_rays(rng, n, lo, hi, spread):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e6, np.float32)
    tmax[::3] = rng.uniform(0.5, 2.0 * spread, len(tmax[::3]))
    tmax[::7] = -1.0
    return _torch(o, d, tmax)


@pytest.mark.parametrize("scene", ["cornell", "random"])
def test_plain_stream_matches_brute_force(scene):
    """The plain stream against the port's brute force (the oracle of
    K8), on the Cornell box (2 blocks) and on 300 random triangles, with a
    partial last sub-packet and dead rays."""
    rng = np.random.default_rng(3)
    if scene == "cornell":
        tris = _tris(build_scene(cornell_box()))
    else:
        tris = (rng.uniform(-3, 3, (300, 1, 3)) + rng.normal(scale=0.4, size=(300, 3, 3)))
        tris = tris.astype(np.float32)
    sbvh = stream.build_stream_bvh(tris)
    assert sbvh.n_blocks < stream.LANE
    if scene == "cornell":  # rays from inside the box
        o, d, tmax = _brute_rays(rng, 333, [-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], 1.0)
    else:
        o, d, tmax = _brute_rays(rng, 333, -3.5, 3.5, 3.5)
    packed = static.pack_triangles(torch.from_numpy(tris))
    bt, bu, bv, bp = brute.brute_trace_plain(packed.tris, o, d, 0.0, tmax, False)
    got = stream.stream_closest(sbvh, o, d, 0.0, tmax)
    _hold_closest(got, {"t": bt.numpy(), "u": bu.numpy(), "v": bv.numpy(), "prim": bp.numpy()},
                  min_hits=50)
    np.testing.assert_array_equal(stream.stream_any(sbvh, o, d, 1e-4, tmax).numpy(),
                                  brute.brute_trace_plain(packed.tris, o, d, 1e-4, tmax, True))
    for any_hit in (False, True):  # the tests done: at most the popped slots x 32 rays a warp
        work = stream.stream_trace_plain(sbvh, o, d, 0.0, tmax, any_hit)
        assert bool((work["streamed"] <= work["candidates"][:, None]).all())
        slots = work["streamed"].sum(1) * stream.WARP * sbvh.block_tris
        assert bool((work["tests"] <= slots).all()) and int(work["tests"].sum()) > 0
    assert torch.equal(work["candidates"].int(), stream.count_candidates(sbvh, o, d, 0.0, tmax))


def test_balance_equals_unbalanced(tris, rays):
    o, d, tmax = _torch(*rays)
    sbvh = stream.build_stream_bvh(tris)
    a = stream.stream_closest(sbvh, o, d, 0.0, tmax, balance=True)
    b = stream.stream_closest(sbvh, o, d, 0.0, tmax, balance=False)
    for k in ("t", "u", "v", "prim"):
        assert torch.equal(a[k], b[k]), k


def test_balance_permutation_matches_jax():
    """The order by descending count, ties in index order, against the
    JAX package's _balance on tiled rays: the sub-packets it moves and its
    inverse."""
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 6, 40).astype(np.int32)  # 5 gangs, many ties
    rays = rng.normal(size=(8, 40 * stream.LANE)).astype(np.float32)
    tiled = jnp.asarray(rays.reshape(8, 5, 8, stream.LANE).transpose(1, 0, 2, 3))
    jrays, jinv = jstream._balance(tiled, jnp.asarray(counts, jnp.float32))
    order = stream.balance_order(torch.from_numpy(counts))
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(np.argsort(order.numpy()), np.asarray(jinv))
    got = rays.T.reshape(40, stream.LANE, 8)[order.numpy()].reshape(-1, 8)
    want = np.asarray(jrays).transpose(1, 0, 2, 3).reshape(8, -1).T
    np.testing.assert_array_equal(got, want)


def test_all_dead_sub_packet(tris, rays):
    """A sub-packet with no live ray culls nothing and pops nothing."""
    o, d, tmax = _torch(*rays)
    tmax = tmax.clone()
    tmax[128:256] = -1.0
    sbvh = stream.build_stream_bvh(tris)
    for any_hit in (False, True):
        out = stream.stream_trace_plain(sbvh, o, d, 1e-4, tmax, any_hit)
        assert int(out["candidates"][1]) == 0 and int(out["streamed"][1].sum()) == 0
        assert int(out["box_tests"][1]) == 0 and int(out["tests"][1]) == 0
        assert bool((out["candidates"][[0, 2, 3, 4]] > 0).all())
        if any_hit:
            assert not out["hit"][128:256].any()
        else:
            assert bool((out["prim"][128:256] == -1).all())
            assert bool((out["t"][128:256] == 1e30).all())
