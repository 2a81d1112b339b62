"""The port's BVH path on the CPU against the JAX package: the colonnade
scene and camera, the morton codes and both builds (exactly equal
arrays), the card layout's near/far codes, the ray sort's order, and the
traversal (ops/bvh.py's wrappers, which run kernel K7's plain version,
ops/traverse.py, on CPU tensors) against the brute-force oracle, the JAX
stackless walk and, once, the Pallas packet kernel in interpret mode.
Then K7's own walk: the ordered walk (traverse.ordered_walk) against the
stackless walks and a scalar Python loop, and the four-wide records
(bvh.pack_wide_nodes) against the binary tree, whose leaf order a scalar
loop over them, written as the kernel is, reproduces.

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
from capsaicin_tpu_torch.ops import bvh, lbvh, traverse
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, make_camera
from torch_threads import share_cores

share_cores()

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


# K7's walk, one ray at a time in float32 scalars, in the kernel's order of
# operations: the binary walk of the kernel's first design and the
# four-wide walk of csrc/bvh_trace.cu. Each returns the hit [t, u, v,
# prim], the leaves it tested in order and its work (box tests, triangle
# tests, records).
F32 = np.float32


def _ray(o, d, tmin):
    inv = tuple(F32(1e12 if x >= 0 else -1e12) if abs(x) < F32(1e-12) else F32(1) / x
                for x in d)
    return tuple(map(F32, o)), tuple(map(F32, d)), inv, F32(tmin)


def _slab(ray, lo, hi, t_best):
    o, _, inv, tmin = ray
    t0 = [(F32(lo[a]) - o[a]) * inv[a] for a in range(3)]
    t1 = [(F32(hi[a]) - o[a]) * inv[a] for a in range(3)]
    t_near = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])), min(t0[2], t1[2]))
    t_far = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])), max(t0[2], t1[2]))
    return bool(t_near <= t_far and t_far >= tmin and t_near <= t_best), t_near


def _leaf(host, leaf, ray, best, any_hit, work):
    """The leaf's triangles in slot order; True on an any-hit."""
    (ox, oy, oz), (dx, dy, dz), _, tmin = ray
    for s in range(leaf * host.leaf_size, (leaf + 1) * host.leaf_size):
        tid = int(host.tri_id[s])
        if tid < 0:
            break
        work[1] += 1
        ax, ay, az = host.tri_v0[s]
        (e1x, e1y, e1z), (e2x, e2y, e2z) = host.tri_e1[s], host.tri_e2[s]
        px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = abs(det) > F32(1e-12)
        inv_det = F32(1) / det if det_ok else F32(0)
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx, qy, qz = tvy * e1z - tvz * e1y, tvz * e1x - tvx * e1z, tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        if det_ok and u >= 0 and v >= 0 and u + v <= 1 and t > tmin and t < best[0]:
            best[:] = [t, u, v, tid]
            if any_hit:
                return True
    return False


def _binary_walk(host, codes, ray, tmax, any_hit):
    best, leaves, work = [F32(tmax), F32(0), F32(0), -1], [], [0, 0, 0]
    empty = host.nodes_min[:, 0] > host.nodes_max[:, 0]
    stack, k = [], 1
    while True:
        work[2] += 1
        c0 = 2 * k
        hit, t_near = [False, False], [F32(0), F32(0)]
        for j in (0, 1):
            if not empty[c0 + j]:
                work[0] += 1
                hit[j], t_near[j] = _slab(ray, host.nodes_min[c0 + j], host.nodes_max[c0 + j],
                                          best[0])
        code = int(codes[k])
        near_left = (ray[1][code & 3] > 0) == (code >= 4)
        near, far = (0, 1) if near_left else (1, 0)
        if c0 >= host.n_leaves:
            if hit[near]:
                leaves.append(c0 + near - host.n_leaves)
                if _leaf(host, leaves[-1], ray, best, any_hit, work):
                    break
            if hit[far] and t_near[far] <= best[0]:
                leaves.append(c0 + far - host.n_leaves)
                if _leaf(host, leaves[-1], ray, best, any_hit, work):
                    break
        elif hit[near]:
            if hit[far]:
                stack.append(c0 + far)
            k = c0 + near
            continue
        elif hit[far]:
            k = c0 + far
            continue
        if not stack:
            break
        k = stack.pop()
    return best, leaves, work


def _wide_walk(records, host, ray, tmax, any_hit, hold=False):
    """csrc/bvh_trace.cu's walk over the octant records. With `hold`, as a
    lane of the kernel walks when its warp lets it: it holds the first leaf
    it reaches and walks on to the next one (or the end) before testing
    it, then tests it only if its entry distance is still no farther than
    the best hit."""
    best, leaves, work = [F32(tmax), F32(0), F32(0), -1], [], [0, 0, 0]
    octant = sum(int(ray[1][a] > 0) << a for a in range(3))
    records = records.reshape(8, -1, bvh.WIDE_FLOATS)[octant]
    refs = records.view(np.int32)[:, 24:28]
    stack = []

    def pop():
        while stack:
            ref, t_near = stack.pop()
            if t_near <= best[0]:
                return ref, t_near
        return None, F32(0)

    pop_next = "pop"  # a leaf is tested before the walk pops its next entry
    (cur, t_cur), held = (0, F32(0)), None
    while True:
        while cur not in (None, pop_next) and (cur >= 0 or (hold and held is None)):
            if cur < 0:  # a leaf, and none held: hold it and walk on
                held, t_held = cur, t_cur
                cur, t_cur = pop()
                continue
            work[2] += 1
            rec, passed = records[cur], []
            for s, ref in enumerate(refs[cur]):
                if ref != bvh.EMPTY_SLOT:
                    work[0] += 1
                    ok, t_near = _slab(ray, rec[[s, 4 + s, 8 + s]], rec[[12 + s, 16 + s, 20 + s]],
                                       best[0])
                    if ok:
                        passed.append((int(ref), t_near))
            stack += passed[:0:-1]
            cur, t_cur = passed[0] if passed else pop()
        if not hold and cur is not None:  # the leaf just reached
            held, t_held, cur = cur, t_cur, pop_next
        if held is not None:
            if t_held <= best[0]:
                leaves.append(~held)
                if _leaf(host, ~held, ray, best, any_hit, work):
                    break
            held = None
        if cur == pop_next:
            cur, t_cur = pop()
        elif cur is None:
            break
    return best, leaves, work


def _colonnade_rays(rng, n):
    return _random_rays(rng, n, [-17.0, 0.5, -9.0], [17.0, 7.0, 9.0])


@pytest.mark.parametrize("leaf_size", [4, 8])
@pytest.mark.parametrize("scene", ["random", "colonnade"])
def test_ordered_walk_matches_stackless_and_jax_walks(rng, small_colonnade, scene, leaf_size):
    """K7's walk (near first) against the stackless walks (left first) on
    the same median tree: bit-equal hits, except where two triangles are
    hit at bit-equal t (a tie the two orders break differently) or where
    brute force confirms the ordered walk's hit."""
    if scene == "random":
        tris = _random_tris(rng, 700)
        o, d = _random_rays(rng, 160, -3.0, 3.0)
    else:
        tris = _tris(small_colonnade)
        o, d = _colonnade_rays(rng, 160)
    tmax = np.full(len(o), 1e6, np.float32)
    tmax[::7] = -1.0  # dead rays
    host = lbvh.build_median_bvh(tris, leaf_size)
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.0, torch.from_numpy(tmax))
    got = {k: x.numpy() for k, x in traverse.ordered_walk(host, *args, False).items()}
    stackless = {k: x.numpy() for k, x in traverse.traverse(host, *args, False).items()}
    jhost = jlbvh.build_median_bvh(tris, leaf_size, to_device=False)
    jhost = jhost._replace(**{f: jnp.asarray(getattr(jhost, f)) for f in jhost._fields})
    jo, jd, jt, jtmax = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris), jnp.asarray(tmax)
    walk = {k: np.asarray(x) for k, x in jtraverse.bvh_closest(jhost, jo, jd, 0.0, jtmax).items()}
    assert 30 < (got["prim"] >= 0).sum() < len(o) - len(o) // 7
    for want in (stackless, walk):
        diff = got["prim"] != want["prim"]
        tie = diff & (got["t"].view(np.int32) == want["t"].view(np.int32))
        if (diff & ~tie).any():  # brute force settles the rest
            oracle = np.asarray(jintersect.brute_force_closest(jo, jd, jt, 0.0, jtmax)["prim"])
            assert (got["prim"] == oracle)[diff & ~tie].all(), np.nonzero(diff & ~tie)
        assert diff.sum() <= 2, (diff.sum(), tie.sum())
    for key in ("t", "u", "v"):  # the same triangle: the same arithmetic
        same = got["prim"] == stackless["prim"]
        np.testing.assert_array_equal(got[key][same], stackless[key][same])
    _check(got, walk)
    got_any = traverse.ordered_walk(host, *args[:2], 1e-4, args[3], True)["prim"].numpy() >= 0
    want_any = np.asarray(jtraverse.bvh_any(jhost, jo, jd, 1e-4, jtmax))
    np.testing.assert_array_equal(got_any, want_any)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("leaf_size", [4, 8])
def test_ordered_walk_counts_and_wide_walk_match_scalar_walks(rng, small_colonnade, leaf_size,
                                                              any_hit):
    """On 40 rays: the vectorised ordered walk's hits and counts equal the
    scalar binary walk's, and the scalar four-wide walk over the octant
    records (the kernel's algorithm), with or without a held leaf, tests the
    same leaves in the same order, so its hits are bit-equal too; the
    vectorised four-wide walk (traverse.wide_walk) has its hits and its
    counts."""
    host = lbvh.build_median_bvh(_tris(small_colonnade), leaf_size)
    records, codes = bvh.pack_octant_records(host), bvh.pair_codes(host)
    o, d = _colonnade_rays(rng, 40)
    tmin = 1e-4 if any_hit else 0.0
    tmax = np.full(40, 1e6, np.float32)
    tmax[::9] = -1.0
    args = (torch.from_numpy(o), torch.from_numpy(d), tmin, torch.from_numpy(tmax), any_hit)
    got = traverse.ordered_walk(host, *args, counts=True)
    got_wide = traverse.wide_walk(records, host, *args, counts=True)
    for key in ("t", "u", "v", "prim"):
        assert torch.equal(got_wide[key], got[key])
    n_hits = 0
    for i in range(40):
        if tmax[i] < tmin:  # a dead ray does no work
            assert int(got["prim"][i]) == -1 and float(got["t"][i]) == tmax[i]
            assert int(got["boxes"][i]) == int(got["records"][i]) == 0
            continue
        ray = _ray(o[i], d[i], tmin)
        best, leaves, work = _binary_walk(host, codes, ray, tmax[i], any_hit)
        w_best, w_leaves, w_work = _wide_walk(records, host, ray, tmax[i], any_hit)
        assert w_leaves == leaves and w_best == best
        assert _wide_walk(records, host, ray, tmax[i], any_hit, hold=True)[:2] == (best, leaves)
        assert w_work[1] == work[1] and w_work[2] < work[2]
        assert [int(got_wide[k][i]) for k in ("boxes", "tris", "records")] == w_work
        assert [int(got[k][i]) for k in ("boxes", "tris", "records")] == work
        assert int(got["prim"][i]) == best[3]
        if not any_hit:
            assert [got[k][i].item() for k in ("t", "u", "v")] == [float(x) for x in best[:3]]
        n_hits += best[3] >= 0
    assert n_hits >= 5


def _dfs_leaves(children, root):
    order, stack = [], [root]
    while stack:
        node = stack.pop()
        if isinstance(node, tuple):
            order.append(node[1])
        else:
            stack += children(node)[::-1]
    return order


@pytest.mark.parametrize("scene, leaf_size", [("colonnade", 4), ("colonnade", 8),
                                              ("colonnade", 32), ("two_leaves", 4),
                                              ("four_leaves", 1)])
def test_pack_wide_nodes_keeps_boxes_and_leaf_order(small_colonnade, rng, scene, leaf_size):
    """Every slot of the wide records holds its node's box from the binary
    tree (the nodes at even depth below the root, and the leaves), the odd
    depths' boxes being their slots' union; for each of the 8 octants of
    direction signs the slots' order, and the octant's copy of the records
    (pack_octant_records: the same slots, reordered), walk the leaves in
    the binary walk's order (empty nodes skipped in all)."""
    tris = {"colonnade": _tris(small_colonnade), "two_leaves": _random_tris(rng, 5),
            "four_leaves": _random_tris(rng, 3)}[scene]
    host = lbvh.build_median_bvh(tris, leaf_size)
    n_leaves, depth = host.n_leaves, host.depth
    wide = bvh.pack_wide_nodes(host)
    records = bvh.pack_octant_records(host).reshape(8, -1, bvh.WIDE_FLOATS)
    ints = wide.view(np.int32)
    heads = bvh.wide_heads(n_leaves)
    assert wide.shape == (heads.size, bvh.WIDE_FLOATS) == ((4 ** ((depth + 1) // 2) - 1) // 3, 32)
    assert depth == {("colonnade", 4): 11, ("colonnade", 8): 10, ("colonnade", 32): 8,
                     ("two_leaves", 4): 1, ("four_leaves", 1): 2}[scene, leaf_size]
    empty = host.nodes_min[:, 0] > host.nodes_max[:, 0]
    node_of = {}  # (record, slot) -> heap index of the slot's node
    for w, k in enumerate(heads):
        width = 2 if 2 * k >= n_leaves else 4
        first, step = int(ints[w, 24]), (1 if ints[w, 24] >= 0 else -1)
        for s in range(4):
            if s >= width:
                assert ints[w, 26] >> s & 1
                continue
            c = width * k + s
            node_of[w, s] = c
            assert bool(ints[w, 26] >> s & 1) == empty[c]
            np.testing.assert_array_equal(wide[w, [s, 4 + s, 8 + s]], host.nodes_min[c])
            np.testing.assert_array_equal(wide[w, [12 + s, 16 + s, 20 + s]], host.nodes_max[c])
            ref = first + s * step
            assert (ref == ~(c - n_leaves)) if c >= n_leaves else heads[ref] == c
    covered = set(node_of.values())
    assert covered == {k for k in range(2, 2 * n_leaves)
                       if (int(k).bit_length() - 1) % 2 == 0 or k >= n_leaves}
    codes = bvh.pair_codes(host)
    for octant in range(8):
        def binary(k):
            code = int(codes[k])
            kids = [2 * k, 2 * k + 1][::1 if ((octant >> (code & 3)) & 1) == (code >= 4) else -1]
            return [("leaf", c - n_leaves) if c >= n_leaves else c for c in kids if not empty[c]]

        def four_wide_slots(w):
            masks = int(ints[w, 25])
            left = [0, 1] if masks >> (8 + octant) & 1 else [1, 0]
            right = [2, 3] if masks >> (16 + octant) & 1 else [3, 2]
            return left + right if masks >> octant & 1 else right + left

        def four_wide(w):
            first = int(ints[w, 24])
            step = 1 if first >= 0 else -1
            return [("leaf", ~(first + s * step)) if first < 0 else first + s * step
                    for s in four_wide_slots(w) if not ints[w, 26] >> s & 1]

        def octant_copy(w):
            refs = records[octant, w].view(np.int32)[24:28]
            return [("leaf", ~int(r)) if r < 0 else int(r) for r in refs if r != bvh.EMPTY_SLOT]

        want = _dfs_leaves(binary, 1)
        assert _dfs_leaves(four_wide, 0) == want == _dfs_leaves(octant_copy, 0)
        assert sorted(want) == [j for j in range(n_leaves) if not empty[n_leaves + j]]
        # each copy's slots are the record's slots, reordered
        order = np.array([[s for s in four_wide_slots(w)] for w in range(heads.size)])
        for f in range(6):
            np.testing.assert_array_equal(records[octant, :, 4 * f:4 * f + 4],
                                          np.take_along_axis(wide[:, 4 * f:4 * f + 4], order, 1))
