"""The port's brute-force intersector (ops/brute.py, kernel K8's plain
version on the CPU) against the JAX package's oracle
(ops/intersect.py) and its Pallas brute-force kernels (run in interpret
mode off the TPU), on 150 random triangles and 700 rays: hit ids equal,
t to rtol 1e-5 and u/v to atol 1e-5 where there is a hit, any-hit equal,
t = 1e30 on a miss. Also the tmin/tmax cases of the Pallas kernel's
tests, and brute against the static kernel (K1's plain version) on the
Cornell box, where both test every triangle in index order and must
agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops import intersect
from capsaicin_tpu.ops import pallas_intersect as pi
from capsaicin_tpu_torch import kernels
from capsaicin_tpu_torch.ops import brute, static
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box
from torch_threads import share_cores

share_cores()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    base = rng.uniform(-2, 2, size=(150, 1, 3))
    tris = (base + rng.uniform(-0.5, 0.5, size=(150, 3, 3))).astype(np.float32)
    n = 700
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tris, o, d


def _port(tris, o, d, tmin, tmax, any_hit):
    scene = static.pack_triangles(torch.from_numpy(tris))
    fn = brute.brute_force_any if any_hit else brute.brute_force_closest
    out = fn(scene, torch.from_numpy(o), torch.from_numpy(d), tmin, tmax)
    return out.numpy() if any_hit else {k: x.numpy() for k, x in out.items()}


@pytest.mark.parametrize("reference", ["oracle", "pallas"])
def test_brute_force_matches_jax(case, reference):
    tris, o, d = case
    closest, any_hit = ((intersect.brute_force_closest, intersect.brute_force_any)
                        if reference == "oracle" else (pi.brute_force_closest, pi.brute_force_any))
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris)
    want = {k: np.asarray(x) for k, x in closest(jo, jd, jt).items()}
    got = _port(tris, o, d, 0.0, 1e6, False)
    np.testing.assert_array_equal(got["prim"], want["prim"])
    hit = want["prim"] >= 0
    assert 50 < hit.sum() < len(hit)  # hits and misses both
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-5)
    np.testing.assert_allclose(got["u"][hit], want["u"][hit], atol=1e-5)
    np.testing.assert_allclose(got["v"][hit], want["v"][hit], atol=1e-5)
    assert np.all(got["t"][~hit] == np.float32(1e30))  # the oracle's miss value, not tmax
    np.testing.assert_array_equal(_port(tris, o, d, 1e-4, 1e6, True),
                                  np.asarray(any_hit(jo, jd, jt)))


def test_brute_force_respects_tmin_tmax():
    tris = np.array([[[-1, -1, 2.0], [1, -1, 2.0], [0, 1, 2.0]]], np.float32)
    o = np.zeros((4, 3), np.float32)
    d = np.array([[0, 0, 1]] * 4, np.float32)
    assert np.all(_port(tris, o, d, 0.0, 10.0, False)["prim"] == 0)
    assert np.all(_port(tris, o, d, 3.0, 10.0, False)["prim"] == -1)
    assert np.all(_port(tris, o, d, 0.0, 1.0, False)["prim"] == -1)
    assert _port(tris, o, d, 0.0, 10.0, True).all()
    assert not _port(tris, o, d, 0.0, 1.0, True).any()
    tmax = torch.tensor([10.0, 1.0, -1.0, 10.0])  # per-ray tmax; -1 is a dead ray
    np.testing.assert_array_equal(_port(tris, o, d, 0.0, tmax, False)["prim"], [0, -1, -1, 0])


def test_brute_force_equals_static_on_the_cornell_box():
    rng = np.random.default_rng(11)
    scene = build_scene(cornell_box())
    tris = torch.from_numpy(np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1))
    n = 1500
    o = torch.from_numpy(rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tmax = torch.full((n,), 1e6)
    tmax[::9] = -1.0
    before = brute.K8.launches
    got = brute.brute_force_closest(static.pack_triangles(tris), o, d, 0.0, tmax)
    assert brute.K8.launches == before  # a CPU tensor takes the plain version
    want = static.static_closest(static.build_static(tris), o, d, 0.0, tmax)
    assert torch.equal(got["prim"], want["prim"])
    hit = want["prim"] >= 0
    for key in ("t", "u", "v"):
        assert torch.equal(got[key][hit], want[key][hit])
    assert torch.equal(brute.brute_force_any(static.pack_triangles(tris), o, d, 1e-4, tmax),
                       static.static_any(static.build_static(tris), o, d, 1e-4, tmax))
    assert brute.K8 in kernels.REGISTRY
