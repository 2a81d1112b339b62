"""The port's small-scene intersector (ops/static.py, kernel K1's plain
version on the CPU) against the JAX package's Pallas static kernel (run in
interpret mode off the TPU) and its brute-force oracle.

Hit ids must be equal except on edge rays (barycentric u, v or 1-u-v
below 1e-5 in either result) and on ties (both hit at the same t to 1e-6:
coplanar triangles such as the tall box's base on the floor), where float
rounding may pick the other triangle; t/u/v must agree to 1e-5 where the
ids agree. A miss follows the static kernel's contract (t = tmax), so t is
compared with the oracle only where there is a hit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops import intersect, pallas_static
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import cornell_box as jcornell_box
from capsaicin_tpu_torch import kernels
from capsaicin_tpu_torch.ops import static
from torch_threads import share_cores

share_cores()

N_RAYS = 3001  # not a multiple of the TPU kernel's 1024-ray packets


@pytest.fixture(scope="module")
def rays():
    """Rays from the camera side and from inside the box; every 7th dead."""
    rng = np.random.default_rng(7)
    scene = jbuild_scene(jcornell_box())
    tris = scene.triangles().astype(np.float32)
    o = np.concatenate([
        rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N_RAYS // 2, 3)),
        rng.uniform([-1.5, 0.0, -4.0], [1.5, 2.0, -3.0], (N_RAYS - N_RAYS // 2, 3)),
    ]).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d[N_RAYS // 2:, 2] = np.abs(d[N_RAYS // 2:, 2]) + 1.0  # outside rays look in
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(N_RAYS, 1e6, np.float32)
    tmax[::7] = -1.0
    return tris, o, d, tmax


def _edge(prim, u, v):
    return (prim >= 0) & ((u < 1e-5) | (v < 1e-5) | (1.0 - u - v < 1e-5))


def _allowed(got, want):
    """Rays whose hit id may differ: edge rays and ties."""
    t, u, v, prim = got
    tie = (prim >= 0) & (want["prim"] >= 0) & (np.abs(t - want["t"]) <= 1e-6 * np.abs(t))
    return _edge(prim, u, v) | _edge(want["prim"], want["u"], want["v"]) | tie


def _port(tris, o, d, tmin, tmax, any_hit):
    scene = static.build_static(torch.from_numpy(tris))
    return static.static_trace(scene, torch.from_numpy(o), torch.from_numpy(d), tmin,
                               torch.from_numpy(tmax), any_hit)


def test_closest_matches_pallas_static(rays):
    tris, o, d, tmax = rays
    packed = pallas_static.build_static(jnp.asarray(tris))
    want = pallas_static.static_closest(packed, jnp.asarray(o), jnp.asarray(d), 0.0,
                                        jnp.asarray(tmax))
    want = {k: np.asarray(x) for k, x in want.items()}
    t, u, v, prim = got = [x.numpy() for x in _port(tris, o, d, 0.0, tmax, False)]
    diff = prim != want["prim"]
    assert not np.any(diff & ~_allowed(got, want))
    assert diff.mean() <= 1e-3
    same = ~diff
    assert (prim >= 0).sum() > N_RAYS // 3  # the rays do hit the box
    assert np.all(prim[::7] == -1) and np.all(t[::7] == -1.0)  # dead rays: t = tmax
    for arr, key in ((t, "t"), (u, "u"), (v, "v")):
        np.testing.assert_allclose(arr[same], want[key][same], rtol=0, atol=1e-5)


def test_closest_matches_brute_force(rays):
    tris, o, d, tmax = rays
    want = intersect.brute_force_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
                                         0.0, jnp.asarray(tmax))
    want = {k: np.asarray(x) for k, x in want.items()}
    t, u, v, prim = got = [x.numpy() for x in _port(tris, o, d, 0.0, tmax, False)]
    diff = prim != want["prim"]
    assert not np.any(diff & ~_allowed(got, want))
    hit = (prim >= 0) & ~diff
    np.testing.assert_allclose(t[hit], want["t"][hit], rtol=0, atol=1e-5)
    assert np.all(want["t"][prim < 0] == np.float32(1e30))  # the oracle's own miss value


def test_any_hit_matches_pallas_static_and_brute_force(rays):
    tris, o, d, tmax = rays
    tmax = tmax.copy()
    tmax[1::2] = np.where(tmax[1::2] < 0, tmax[1::2], 1.5)  # short shadow rays too
    packed = pallas_static.build_static(jnp.asarray(tris))
    want_static = np.asarray(pallas_static.static_any(
        packed, jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(tmax)))
    want_brute = np.asarray(intersect.brute_force_any(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), 1e-4, jnp.asarray(tmax)))
    got = _port(tris, o, d, 1e-4, tmax, True).numpy()
    assert got.dtype == np.bool_
    assert (got != want_static).sum() <= 1e-4 * N_RAYS + 1
    assert (got != want_brute).sum() <= 1e-4 * N_RAYS + 1
    assert not got[::7].any()


def test_cpu_tensors_take_the_plain_version(rays):
    """A CPU tensor never launches K1; a tensor on another device raises."""
    tris, o, d, tmax = rays
    before = static.K1.launches
    _port(tris, o, d, 0.0, tmax, False)
    assert static.K1.launches == before
    scene = static.build_static(torch.from_numpy(tris))
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        static.static_trace(scene, meta, meta, 0.0, 1e6, False)
    assert static.K1 in kernels.REGISTRY
