"""The port's dense-cull traversal (capsaicin_tpu_torch/ops/cull.py) on the
CPU.

- Its tables (pair rows, triangle rows, the two level tables, n_leaves,
  depth and levels) bit-equal to the JAX package's, on the Cornell box and
  on colonnade(target_tris=3000).
- Coherent and incoherent closest and any-hit traces of one seeded batch
  of 513 rays (a partial packet, per-ray tmax, every 7th ray dead) on
  colonnade(target_tris=3000) against the JAX package's (computed once, in
  a module fixture), at the bars of tests/test_cull.py.
- Against the port's brute-force oracle: budgets of 2 frontier slots and 4
  rows, which send packets through the 4x retrace and the rescue sweep
  (both counted); a scene so small that stage 1 tests the leaf rows;
  mixed-octant random triangles.
- 32x32 frames of colonnade(target_tris=2000) through traversal="cull"
  held per pass to the port's "bvh" frames; its bounce rays through the
  incoherent funnel even with sort_bounce_rays=False; and on a mesh of
  2 x "cpu" against the unsharded frame."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense as td
from capsaicin_tpu.ops import cull as jcull
from capsaicin_tpu_torch.ops import cull
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box
from torch_threads import share_cores

share_cores()

SEED = 31
FIELDS = ("pair_rows", "tri_rows", "coh_boxes", "inc_boxes")
SIZES = ("n_leaves", "depth", "coh_level", "inc_level")


def _scene_tris(name):
    return td.triangles(build_scene(cornell_box() if name == "cornell"
                                    else colonnade(target_tris=3000)))


@pytest.mark.parametrize("name", ["cornell", "colonnade3000"])
def test_builds_equal_jax(name):
    tris = _scene_tris(name)
    jb, tb = jcull.build_cull_bvh(tris), cull.build_cull_bvh(tris)
    for field in FIELDS:
        got = getattr(tb, field)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jb, field)), err_msg=field)
    assert [getattr(tb, k) for k in SIZES] == [getattr(jb, k) for k in SIZES]


@pytest.fixture(scope="module")
def colonnade_traces():
    """(tris, rays, {coherent: (the JAX package's closest, any-hit)})."""
    tris = _scene_tris("colonnade3000")
    o, d, tmax = td.rays(SEED, spread=5.0)
    jb = jcull.build_cull_bvh(tris)
    args = (jnp.asarray(o), jnp.asarray(d))
    want = {coh: (td.numpy_hits(jcull.cull_closest(jb, *args, 0.0, jnp.asarray(tmax),
                                                   coherent=coh)),
                  np.asarray(jcull.cull_any(jb, *args, 1e-4, jnp.asarray(tmax), coherent=coh)))
            for coh in (True, False)}
    return tris, (o, d, tmax), want


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
def test_traces_match_jax(colonnade_traces, coherent):
    tris, (o, d, tmax), want = colonnade_traces
    bvh = cull.build_cull_bvh(tris)
    args = (torch.from_numpy(o), torch.from_numpy(d))
    got = td.numpy_hits(cull.cull_closest(bvh, *args, 0.0, torch.from_numpy(tmax),
                                          coherent=coherent))
    td.hold_closest(got, want[coherent][0])
    assert np.all(got["prim"][::7] == -1)  # dead rays
    assert (want[coherent][0]["prim"] >= 0).mean() > 0.2
    np.testing.assert_array_equal(
        cull.cull_any(bvh, *args, 1e-4, torch.from_numpy(tmax), coherent=coherent).numpy(),
        want[coherent][1])


def _check_brute(tris, o, d, tmax, levels=None, **kw):
    bvh = cull.build_cull_bvh(tris, **(levels or {}))
    args = (torch.from_numpy(o), torch.from_numpy(d))
    got = td.numpy_hits(cull.cull_closest(bvh, *args, 0.0, torch.from_numpy(tmax), **kw))
    td.hold_closest(got, td.brute_closest(tris, o, d, 0.0, tmax))
    np.testing.assert_array_equal(
        cull.cull_any(bvh, *args, 1e-4, torch.from_numpy(tmax), **kw).numpy(),
        td.brute_any(tris, o, d, 1e-4, tmax))
    return bvh


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
def test_forced_retrace_and_rescue_against_brute_force(coherent, monkeypatch):
    """The scene's tree has depth 10, under the default coherent level
    (11), so the coherent funnel starts at level 6 here to descend."""
    monkeypatch.setattr(cull, "STATS", {"retraced": 0, "rescued": 0})
    o, d, tmax = td.rays(SEED + 1, n=256, spread=5.0)
    bvh = _check_brute(_scene_tris("colonnade3000"), o, d, tmax, dict(coh_level=6),
                       coherent=coherent, budget=2, k_rows=4)
    assert bvh.depth == 10 and bvh.coh_level == 6 and bvh.inc_level == 8
    assert cull.STATS["retraced"] > 0 and cull.STATS["rescued"] > 0


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
def test_tiny_scene_starts_at_the_rows(coherent):
    tris = np.random.default_rng(SEED).normal(size=(20, 3, 3)).astype(np.float32)
    o, d, tmax = td.rays(SEED + 2, n=130)
    bvh = _check_brute(tris, o, d, tmax, coherent=coherent)
    assert bvh.coh_level == bvh.inc_level == bvh.depth  # the level table is the rows


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
def test_mixed_octants_against_brute_force(coherent):
    o, d, tmax = td.rays(SEED + 3, n=1024, spread=3.5)
    _check_brute(td.random_triangles(SEED), o, d, tmax, coherent=coherent)


@pytest.fixture(scope="module")
def cull_frames():
    s = td.session("cull")
    assert isinstance(s.accel, cull.CullBVH)
    return td.frames(s)


def test_frames_match_bvh_frames(cull_frames):
    td.hold_frames(cull_frames, td.bvh_frames())


def test_bounce_rays_take_the_incoherent_funnel(cull_frames, monkeypatch):
    """With sort_bounce_rays=False the cull mode still traces bounce rays
    (closest hit and NEE) through make_bounce_fns, as the JAX package does;
    the frame is the one with the sort on."""
    calls = []
    for name in ("cull_closest", "cull_any"):
        fn = getattr(cull, name)
        monkeypatch.setattr(cull, name, lambda *a, fn=fn, name=name, **kw: calls.append(
            (name, kw.get("coherent", True))) or fn(*a, **kw))
    s = td.session("cull", sort_bounce_rays=False)
    display, _ = s.frame()
    assert sorted(calls) == [("cull_any", False), ("cull_closest", False)]
    np.testing.assert_array_equal(display.numpy(), cull_frames[0][0])


def test_mesh_frame_matches_unsharded(cull_frames):
    td.hold_mesh_frame("cull", cull_frames[0])
