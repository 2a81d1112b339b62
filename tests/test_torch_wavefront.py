"""The port's wavefront traversal (capsaicin_tpu_torch/ops/wavefront.py) on
the CPU.

- Its leaf-8 median BVH and its tables bit-equal to the JAX package's, on
  the Cornell box and on colonnade(target_tris=3000).
- Closest and any-hit traces of one seeded batch of 513 rays (a partial
  packet, per-ray tmax, every 7th ray dead) on the Cornell box against the
  JAX package's (the JAX side computed once, in a module fixture), at the
  bars of tests/test_cull.py: prim equal except on equal-t rays, t/u/v
  within 1e-5 where it matches, any-hit equal.
- The vectorised phase-B step bit-equal to the JAX package's sequential
  update, triangle by triangle, with ties of equal t.
- Mixed-octant random triangles, and the continuation stages forced by
  budgets of 4 and 6 rows, against the port's brute-force oracle.
- 32x32 frames of colonnade(target_tris=2000) through traversal="wavefront"
  held per pass to the port's "bvh" frames, and on a mesh of 2 x "cpu"
  to the unsharded frame."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense as td
from capsaicin_tpu.ops import lbvh as jlbvh
from capsaicin_tpu.ops import wavefront as jwf
from capsaicin_tpu_torch.ops import lbvh
from capsaicin_tpu_torch.ops import wavefront as wf
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box
from torch_threads import share_cores

share_cores()

SEED = 13


def _scene_tris(name):
    return td.triangles(build_scene(cornell_box() if name == "cornell"
                                    else colonnade(target_tris=3000)))


@pytest.mark.parametrize("name", ["cornell", "colonnade3000"])
def test_builds_equal_jax(name):
    tris = _scene_tris(name)
    want = jlbvh.build_median_bvh(tris, leaf_size=8, to_device=False)
    got = lbvh.build_median_bvh(tris, leaf_size=8)
    for field in ("nodes_min", "nodes_max", "tri_v0", "tri_e1", "tri_e2", "tri_id"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)),
                                      err_msg=field)
    jb, tb = jwf.build_wavefront_bvh(tris), wf.build_wavefront_bvh(tris)
    assert tb.n_leaves == jb.n_leaves == got.n_leaves
    for field in ("pair_rows", "tri_rows"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(), np.asarray(getattr(jb, field)),
                                      err_msg=field)
        assert getattr(tb, field).dtype == torch.float32


@pytest.fixture(scope="module")
def cornell_traces():
    """(tris, rays, the JAX package's closest and any-hit results)."""
    tris = _scene_tris("cornell")
    o, d, tmax = td.rays(SEED)
    jb = jwf.build_wavefront_bvh(tris)
    args = (jnp.asarray(o), jnp.asarray(d))
    closest = td.numpy_hits(jwf.wavefront_closest(jb, *args, 0.0, jnp.asarray(tmax)))
    any_hit = np.asarray(jwf.wavefront_any(jb, *args, 1e-4, jnp.asarray(tmax)))
    return tris, (o, d, tmax), closest, any_hit


def test_traces_match_jax(cornell_traces):
    tris, (o, d, tmax), want, want_any = cornell_traces
    bvh = wf.build_wavefront_bvh(tris)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    got = td.numpy_hits(wf.wavefront_closest(bvh, *args, 0.0, torch.from_numpy(tmax)))
    td.hold_closest(got, want)
    assert np.all(got["prim"][::7] == -1)  # dead rays
    assert (want["prim"] >= 0).mean() > 0.2
    np.testing.assert_array_equal(wf.wavefront_any(bvh, *args, 1e-4, torch.from_numpy(tmax)).numpy(),
                                  want_any)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_step_equals_the_sequential_update(any_hit):
    """mt_step over 32 triangles at once against 32 steps of one triangle
    (the JAX package's _mt_update): the same bits, with duplicated triangles
    (equal t under other ids), padding slots and a prior best."""
    rng = np.random.default_rng(SEED)
    tris = _scene_tris("cornell")
    o, _, tmax = td.rays(SEED, n=4 * wf.LANE, dead_every=9)
    target = tris[rng.integers(0, len(tris), len(o))].mean(1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pk, _ = wf._make_packets(torch.from_numpy(o), torch.from_numpy(d), 1e-4,
                             torch.from_numpy(tmax))
    pick = rng.integers(0, len(tris), (pk.ox.shape[0], 32))
    pick[:, 20:] = pick[:, :12]  # duplicates: equal t, later slot
    t = torch.from_numpy(tris[pick])
    ids = torch.arange(32, dtype=torch.float32).expand(pick.shape) + 1.0
    ids = torch.where(torch.from_numpy(rng.random(pick.shape) < 0.1), 0.0, ids)  # padding
    tri = torch.cat([t[..., 0, :], t[..., 1, :] - t[..., 0, :], t[..., 2, :] - t[..., 0, :],
                     ids[..., None]], -1)
    p = pk.ox.shape
    prior_t = torch.where(torch.from_numpy(rng.random(p) < 0.5), 2.0, 1e30)
    best = (prior_t, torch.zeros(p), torch.zeros(p), torch.full(p, -1, dtype=torch.int32))
    got = wf.mt_step(best, pk, tri, any_hit)
    want = best
    for j in range(tri.shape[1]):
        want = wf.mt_step(want, pk, tri[:, j:j + 1], any_hit)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w)
    assert int((got[3] >= (0 if not any_hit else 1)).sum()) > p[0] * p[1] // 4  # many hits


def _check_brute(tris, o, d, tmax):
    bvh = wf.build_wavefront_bvh(tris)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    got = td.numpy_hits(wf.wavefront_closest(bvh, *args, 0.0, torch.from_numpy(tmax)))
    td.hold_closest(got, td.brute_closest(tris, o, d, 0.0, tmax))
    np.testing.assert_array_equal(wf.wavefront_any(bvh, *args, 1e-4, torch.from_numpy(tmax)).numpy(),
                                  td.brute_any(tris, o, d, 1e-4, tmax))


def test_mixed_octants_against_brute_force():
    o, d, tmax = td.rays(SEED + 1, n=700, spread=4.0)
    _check_brute(td.random_triangles(SEED), o, d, tmax)


def test_continuation_stages_against_brute_force(monkeypatch):
    """Budgets of 4 and 6 rows send packets through the compacted
    continuation stages; the results do not change."""
    monkeypatch.setattr(wf, "K_STAGE1", 4)
    monkeypatch.setattr(wf, "K_STAGE2", 6)
    monkeypatch.setattr(wf, "STATS", {"continued": 0, "stages": 0})
    o, d, tmax = td.rays(SEED + 2, n=640, spread=4.0)
    _check_brute(td.random_triangles(SEED + 1), o, d, tmax)
    assert wf.STATS["continued"] > 0 and wf.STATS["stages"] > 1


@pytest.fixture(scope="module")
def wavefront_frames():
    s = td.session("wavefront")
    assert isinstance(s.accel, wf.WavefrontBVH) and s._sorted_trace is not None
    return td.frames(s)


def test_frames_match_bvh_frames(wavefront_frames):
    td.hold_frames(wavefront_frames, td.bvh_frames())


def test_mesh_frame_matches_unsharded(wavefront_frames):
    td.hold_mesh_frame("wavefront", wavefront_frames[0])


def test_phase_b_steps_of_any_length_give_the_same_bits(monkeypatch):
    """Phase B takes as many rows a step as ELEMS_PER_CHUNK allows (all of a
    small batch's rows at once); at one packet and CHUNK rows a step the
    results are the same bits."""
    tris = td.random_triangles(SEED + 3)
    o, d, _ = (torch.from_numpy(x) for x in td.rays(SEED + 3, n=300, spread=4.0))
    tmax = torch.full((300,), 1e6)
    bvh = wf.build_wavefront_bvh(tris)
    wide = wf.wavefront_closest(bvh, o, d, 0.0, tmax), wf.wavefront_any(bvh, o, d, 1e-4, tmax)
    monkeypatch.setattr(wf, "ELEMS_PER_CHUNK", 1)
    narrow = wf.wavefront_closest(bvh, o, d, 0.0, tmax), wf.wavefront_any(bvh, o, d, 1e-4, tmax)
    for k in ("t", "u", "v", "prim"):
        assert torch.equal(wide[0][k], narrow[0][k])
    assert torch.equal(wide[1], narrow[1])
    assert int((wide[0]["prim"] >= 0).sum()) > 40
