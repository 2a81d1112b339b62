"""The port's BVH path on the CPU against the JAX package: the colonnade
scene and camera, the morton codes and both builds (exactly equal
arrays), the card layout's near/far codes, the ray sort's order, and the
traversal (ops/bvh.py's wrappers, which run kernel K7's plain version,
ops/traverse.py, on CPU tensors) against the brute-force oracle, the JAX
stackless walk and, once, the Pallas packet kernel in interpret mode.

Hit ids must be equal except where two triangles are hit at the same t
(to rtol 1e-4): the walks visit leaves in other orders than the oracle's
index order (as tests/test_pallas_traverse.py allows). Where the ids are
equal, t agrees to rtol 1e-5 and u/v to atol 1e-5; any-hit is equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops import intersect as jintersect
from capsaicin_tpu.ops import lbvh as jlbvh
from capsaicin_tpu.ops import pallas_traverse as jpt
from capsaicin_tpu.ops import traverse as jtraverse
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import colonnade as jcolonnade
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu_torch import kernels
from capsaicin_tpu_torch.ops import bvh, lbvh
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, make_camera

SMALL = 2000  # colonnade(target_tris=SMALL) has 4,966 triangles


@pytest.fixture(scope="module")
def small_colonnade():
    return build_scene(colonnade(target_tris=SMALL))


def _tris(scene):
    return np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1).astype(np.float32)


def _random_tris(rng, n, spread=4.0):
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rng.uniform(-0.4, 0.4, size=(n, 3, 3))).astype(np.float32)


def _random_rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_colonnade_and_camera_match_jax(small_colonnade):
    want = jbuild_scene(jcolonnade(target_tris=SMALL))
    assert small_colonnade.num_triangles == want.num_triangles == 4966
    for field in small_colonnade._fields:
        np.testing.assert_array_equal(getattr(small_colonnade, field), np.asarray(getattr(want, field)),
                                      err_msg=field)
    got_cam, want_cam = make_camera("colonnade", 64, 48), jmake_camera("colonnade", 64, 48)
    for field in got_cam._fields:
        np.testing.assert_array_equal(getattr(got_cam, field).numpy(),
                                      np.asarray(getattr(want_cam, field)), err_msg=field)


def test_morton_codes_and_lbvh_match_jax(rng):
    tris = _random_tris(rng, 1000)
    pts = tris.mean(1)
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_array_equal(
        lbvh.morton_codes(torch.from_numpy(pts), torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
        np.asarray(jlbvh.morton_codes(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi))))
    got = lbvh.build_lbvh(torch.from_numpy(tris), leaf_size=4)
    want = jax.jit(jlbvh.build_lbvh, static_argnums=1)(jnp.asarray(tris), 4)
    for field, x in zip(got._fields, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("leaf_size", [4, 8, 32])
def test_median_bvh_and_pair_codes_match_jax(small_colonnade, leaf_size):
    tris = _tris(small_colonnade)
    got = lbvh.build_median_bvh(tris, leaf_size)
    want = jlbvh.build_median_bvh(tris, leaf_size, to_device=False)
    for field, x in zip(got._fields, got):
        np.testing.assert_array_equal(x, np.asarray(getattr(want, field)), err_msg=field)
    assert got.n_leaves == {4: 2048, 8: 1024, 32: 256}[leaf_size]
    # the sibling-pair code is column 6 of the TPU layout's pair rows
    packed = jpt.pack_bvh(want._replace(**{f: jnp.asarray(getattr(want, f)) for f in want._fields}))
    np.testing.assert_array_equal(bvh.pair_codes(got), np.asarray(packed.nodes)[:, 6])
    nodes = bvh.pack_nodes(got)
    np.testing.assert_array_equal(nodes[1:, 3], bvh.pair_codes(got)[1:])
    empty = got.nodes_min[:, 0] > got.nodes_max[:, 0]
    np.testing.assert_array_equal(nodes[1:, 7], empty[2::2] + 2 * empty[3::2])
    rows = bvh.pack_tris(got)
    np.testing.assert_array_equal(rows.view(np.int32)[:, 3], got.tri_id)


@pytest.mark.parametrize("dir_grid", [0, 4])
def test_ray_sort_order_matches_jax(rng, dir_grid):
    o, d = _random_rays(rng, 999, -1.5, 1.5)
    dead = np.arange(999) % 7 == 0
    order, inverse = bvh.sort_rays_for_traversal(torch.from_numpy(o), torch.from_numpy(d),
                                                 dead=torch.from_numpy(dead), dir_grid=dir_grid)
    want, _ = jpt.sort_rays_for_traversal(jnp.asarray(o), jnp.asarray(d),
                                          dead=jnp.asarray(dead), dir_grid=dir_grid)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want))
    np.testing.assert_array_equal(order.numpy()[inverse.numpy()], np.arange(999))
    assert dead[order.numpy()[-int(dead.sum()):]].all()  # dead rays last


def _check(got, want):
    """Closest-hit results (numpy dicts): ids equal except at equal t."""
    same = got["prim"] == want["prim"]
    np.testing.assert_allclose(got["t"][~same], want["t"][~same], rtol=1e-4)
    hit = (want["prim"] >= 0) & same
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-5)
    np.testing.assert_allclose(got["u"][hit], want["u"][hit], atol=1e-5)
    np.testing.assert_allclose(got["v"][hit], want["v"][hit], atol=1e-5)
    return same


@pytest.mark.parametrize("scene", ["random", "colonnade"])
def test_bvh_traversal_matches_oracle_and_jax_walk(rng, small_colonnade, scene):
    if scene == "random":
        tris = _random_tris(rng, 700)
        o, d = _random_rays(rng, 250, -3.0, 3.0)
    else:
        tris = _tris(small_colonnade)
        o, d = _random_rays(rng, 300, [-17.0, 0.5, -9.0], [17.0, 7.0, 9.0])
    tmax = np.full(len(o), 1e6, np.float32)
    tmax[::7] = -1.0  # dead rays
    accel = bvh.build_bvh(tris)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    before = bvh.K7.launches
    got = {k: x.numpy() for k, x in bvh.bvh_closest(accel, *args, 0.0, torch.from_numpy(tmax)).items()}
    got_any = bvh.bvh_any(accel, *args, 1e-4, torch.from_numpy(tmax)).numpy()
    assert bvh.K7.launches == before  # CPU tensors take the plain version
    jo, jd, jt, jtmax = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), jnp.asarray(tmax)
    oracle = {k: np.asarray(x) for k, x in
              jintersect.brute_force_closest(jo, jd, jt, 0.0, jtmax).items()}
    jbvh = jlbvh.build_lbvh(jt, leaf_size=4)
    walk = {k: np.asarray(x) for k, x in jtraverse.bvh_closest(jbvh, jo, jd, 0.0, jtmax).items()}
    hits = oracle["prim"] >= 0
    assert 30 < hits.sum() < len(o)
    assert np.all(got["prim"][::7] == -1) and np.all(got["t"][::7] == -1.0)  # dead: t = tmax
    miss = ~hits
    np.testing.assert_array_equal(got["t"][miss], tmax[miss])  # a miss returns tmax
    for want in (oracle, walk):
        _check(got, want)
    want_any = np.asarray(jintersect.brute_force_any(jo, jd, jt, 1e-4, jtmax))
    np.testing.assert_array_equal(got_any, want_any)
    np.testing.assert_array_equal(got_any, np.asarray(jtraverse.bvh_any(jbvh, jo, jd, 1e-4, jtmax)))
    assert bvh.K7 in kernels.REGISTRY


def test_bvh_traversal_matches_pallas_packet_kernel(small_colonnade, rng):
    """One packet's worth of rays through the Pallas kernel in interpret
    mode (its production build: median BVH, 32-triangle leaves)."""
    tris = _tris(small_colonnade)
    o, d = _random_rays(rng, 256, [-17.0, 0.5, -9.0], [17.0, 7.0, 9.0])
    packed = jpt.build_packed_bvh(jnp.asarray(tris))
    want = {k: np.asarray(x) for k, x in
            jpt.bvh_closest(packed, jnp.asarray(o), jnp.asarray(d), 0.0, 1e6).items()}
    want_any = np.asarray(jpt.bvh_any(packed, jnp.asarray(o), jnp.asarray(d), 1e-4, 1e6))
    accel = bvh.build_bvh(tris)
    got = {k: x.numpy() for k, x in
           bvh.bvh_closest(accel, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e6).items()}
    assert (want["prim"] >= 0).sum() > 50
    _check(got, want)
    np.testing.assert_array_equal(
        bvh.bvh_any(accel, torch.from_numpy(o), torch.from_numpy(d), 1e-4, 1e6).numpy(), want_any)
