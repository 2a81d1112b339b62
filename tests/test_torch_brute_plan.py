"""K8's tile loop (csrc/brute_trace.cu), on the CPU.

K8 runs K1's pair test (csrc/mt_test.cuh: a division-free prefilter, then
the plain version's exact test on the pairs it keeps) over tiles of
triangles staged in shared memory, the last tile padded to a multiple of 4
with degenerate (all-zero) triangles, the best hit and the prefilter's
bound above it carried from tile to tile, a miss returned as t = 1e30. A
float32 torch model of that loop (the prefilter's reciprocal at both ends
of its error and exact; within a tile the running best is a cumulative
minimum, which is the kernel's sequence wherever the prefilter drops
nothing, and the model counts what it drops) must be bit-equal to
`brute_trace_plain` (t, u, v, prim; the any-hit mask) on rays made with
numpy from a seed: K1's adversarial Cornell set in tiles of 8 (the
duplicates of triangles 5 and 17 lie three and four tiles later, so ties
cross tiles) and the reduced colonnade in K8's own tiles of 256, with
duplicates appended past the first tiles and rays aimed at their vertices,
edges and centres; with t_best starting at a hit's exact t and one ulp
above it. Also `static.any_hit_tests` (the bound's count of an any-hit
trace on a scene of any size, in chunks of triangles) against the plain
version's first hits."""

import math
import os
import re

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch.ops import brute, static
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade
from test_torch_static_plan import (DET_HI, MARGIN, RCP_ERR, SUM_HI, TINY, adversarial,
                                    exact_accepts, prefilter, t_hi)

STEP = 4  # MT_STEP: a tile is padded to a multiple of it
MISS_T = np.float32(1e30)


def numerators(o, d, tris):
    """det and the numerators of u, v and t of every pair [rays, tris], in
    the plain version's order of operations."""
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tris[None, :, i] for i in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    un = tvx * px + tvy * py + tvz * pz
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vn = dx * qx + dy * qy + dz * qz
    tn = e2x * qx + e2y * qy + e2z * qz
    return det, un, vn, tn


def k8_model(packed, o, d, tmin, tmax, any_hit, rcp_err, tile):
    """K8 in float32 torch over tiles of `tile` triangles. Returns ((t, u,
    v, prim) with t = 1e30 on a miss, or the hit mask), the pairs the exact
    test accepts that the prefilter dropped, and the padding triangles
    staged."""
    n, n_tris = o.shape[0], packed.shape[0]
    t_best = tmax.clone()
    u = torch.zeros_like(t_best)
    v = torch.zeros_like(t_best)
    prim = torch.full((n,), -1, dtype=torch.int64)
    live = tmax > tmin
    rows = torch.arange(n)
    dropped = padded = 0
    for base in range(0, n_tris, tile):
        blk = packed[base:base + tile]
        n_pad = -(-blk.shape[0] // STEP) * STEP
        padded += n_pad - blk.shape[0]
        blk = torch.cat([blk, torch.zeros(n_pad - blk.shape[0], 9)])
        det, un, vn, tn = numerators(o, d, blk)
        first, second, small, at_lo = prefilter(det, un, vn, tn, tmin, rcp_err)
        ok, uu, vv, tt = exact_accepts(det, un, vn, tn, tmin, math.inf)  # all but t < t_best
        ok &= live[:, None]
        # the best before each pair: the carried one, then the exact hits of the tile
        if any_hit:
            before = t_best[:, None].expand(n, n_pad)
        else:
            cand = torch.where(ok, tt, math.inf)
            before = torch.cat([t_best[:, None], cand[:, :-1]], 1).cummin(1).values
        accept = ok & (tt < before)
        if any_hit:  # it stops at its first hit
            accept &= accept.int().cumsum(1) == 1
        reject = first | second | (small & (at_lo > t_hi(before)))
        dropped += int((accept & reject).sum())
        # each accepted pair improves on the one before: the last is the best
        has = accept.any(1)
        j = n_pad - 1 - accept.flip(1).int().argmax(1)
        t_best = torch.where(has, tt[rows, j], t_best)
        u = torch.where(has, uu[rows, j], u)
        v = torch.where(has, vv[rows, j], v)
        prim = torch.where(has, base + j, prim)
        if any_hit:
            live &= ~has
    if any_hit:
        return prim >= 0, dropped, padded
    t = torch.where(prim >= 0, t_best, torch.tensor(MISS_T))
    return (t, u, v, prim.int()), dropped, padded


def _normalized(d):
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def colonnade_case(seed=7, n=1200):
    """(packed [T,9], origins, dirs, tmax): the reduced colonnade (4,966
    triangles) plus duplicates of 12 of its triangles appended (so a tie
    crosses tiles of 256), rays from inside the hall in random directions,
    rays aimed at the duplicated triangles' vertices, edge midpoints and
    centres, every 7th ray dead."""
    rng = np.random.default_rng(seed)
    host = build_scene(colonnade(target_tris=2000))
    tris = np.stack([host.tri_v0, host.tri_v1, host.tri_v2], 1).astype(np.float32)
    dup = rng.choice(1024, 12, replace=False)
    tris = np.concatenate([tris, tris[dup]])
    o = [rng.uniform([-17.0, 0.5, -9.0], [17.0, 7.0, 9.0], (n, 3))]
    d = [rng.normal(size=(n, 3))]
    st = np.float32([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5], [0.5, 0.5], [1 / 3, 1 / 3]])
    k = np.repeat(dup, len(st) * 3)
    sv = np.tile(np.repeat(st, 3, 0), (len(dup), 1))
    p = tris[k, 0] + sv[:, :1] * (tris[k, 1] - tris[k, 0]) + sv[:, 1:] * (tris[k, 2] - tris[k, 0])
    dd = _normalized(rng.normal(size=(len(k), 3)))
    o.append(p - dd * rng.uniform(0.5, 4.0, (len(k), 1)))
    d.append(dd)
    o = np.concatenate(o).astype(np.float32)
    d = _normalized(np.concatenate(d))
    tmax = np.full(len(o), 1e6, np.float32)
    tmax[::7] = -1.0
    return (static.pack_triangles(torch.from_numpy(tris)).tris, torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(tmax))


def with_ties(packed, o, d, tmax):
    """tmax where t_best starts at the exact t of a ray's closest hit (the
    strict t < t_best drops that hit) on even rays, one ulp above it (the
    hit again) on odd ones."""
    t, _, _, prim = brute.brute_trace_plain(packed, o, d, 0.0, tmax, False)
    hit = prim >= 0
    above = torch.nextafter(t, torch.tensor(math.inf))
    tie = torch.where(torch.arange(len(t)) % 2 == 0, t, above)
    return torch.where(hit, tie, tmax)


@pytest.fixture(scope="module")
def cases():
    tris, o, d, tmax = adversarial()
    cornell = (static.pack_triangles(tris).tris, o, d, torch.from_numpy(tmax))
    return {"cornell": (cornell, 8), "colonnade": (colonnade_case(), brute.TILE)}


@pytest.mark.parametrize("rcp_err", RCP_ERR, ids=["rcp-lo", "rcp-exact", "rcp-hi"])
@pytest.mark.parametrize("scene", ["cornell", "colonnade"])
def test_k8_model_is_bit_equal_to_plain(cases, scene, rcp_err):
    (packed, o, d, tmax), tile = cases[scene]
    n_tris = packed.shape[0]
    assert n_tris > 4 * tile and n_tris % tile % STEP  # several tiles, the last one padded
    for tm in (tmax, with_ties(packed, o, d, tmax)):
        for any_hit, tmin in ((False, 0.0), (True, 1e-4)):
            want = brute.brute_trace_plain(packed, o, d, tmin, tm, any_hit)
            got, dropped, padded = k8_model(packed, o, d, tmin, tm, any_hit, rcp_err, tile)
            assert dropped == 0, f"the prefilter dropped {dropped} pairs the exact test accepts"
            assert padded == STEP - n_tris % STEP
            if any_hit:
                assert torch.equal(got, want)
                assert 0 < int(want.sum()) < len(o)
            else:
                for a, b in zip(got, want):
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
                assert int((want[3] >= 0).sum()) > len(o) // 8  # the rays do hit


def test_ties_cross_tiles(cases):
    """The duplicates lose every tie to their originals in earlier tiles,
    and rays do reach them."""
    dups_of = {"cornell": torch.tensor([40, 41]), "colonnade": torch.arange(4966, 4978)}
    for scene, dups in dups_of.items():
        (packed, o, d, tmax), tile = cases[scene]
        same = (packed[:int(dups.min()), None, :] == packed[None, dups, :]).all(-1)
        originals = torch.nonzero(same.any(1))[:, 0]
        assert len(originals) == len(dups)
        assert int(originals.max()) // tile < int(dups.min()) // tile  # copies in later tiles
        _, _, _, prim = brute.brute_trace_plain(packed, o, d, 0.0, tmax, False)
        assert not bool(torch.isin(prim, dups).any())
        assert int(torch.isin(prim, originals).sum()) > 20


def test_any_hit_tests_count_the_first_hit(cases):
    """static.any_hit_tests, the bound's count of an any-hit trace on a
    scene of any size (chunks of triangles): the first hit's index plus 1
    in index order (the model's any-hit stops there), n_tris on a miss, 0
    on a dead ray, as the plain version's any-hit finds it a triangle at a
    time; static.first_hits is that index, -1 where the ray finds none."""
    for scene in ("cornell", "colonnade"):
        (packed, o, d, tmax), tile = cases[scene]
        tests = static.any_hit_tests(packed, o, d, 1e-4, tmax)
        first = static.static_trace_plain(packed, o, d, 1e-4, tmax, True)[3].long()
        want = torch.where(tmax > 1e-4, torch.where(first >= 0, first + 1, packed.shape[0]), 0)
        assert torch.equal(tests, want)
        assert torch.equal(static.first_hits(packed, o, d, 1e-4, tmax), first)
        assert torch.equal(first >= 0, brute.brute_trace_plain(packed, o, d, 1e-4, tmax, True))


def test_constants_match_the_cuda_sources():
    """The models' constants are the kernels': the prefilter's margins and
    the loop's step (csrc/mt_test.cuh), K8's block and tile
    (csrc/brute_trace.cu), as the wrapper and these tests take them."""
    csrc = os.path.join(os.path.dirname(static.__file__), "..", "csrc")

    def defines(name):
        with open(os.path.join(csrc, name)) as f:
            return dict(re.findall(r"^#define (\w+) (\S+)", f.read(), re.M))

    mt, k8 = defines("mt_test.cuh"), defines("brute_trace.cu")
    assert int(mt["MT_STEP"]) == STEP
    for name, want in (("MT_MARGIN", MARGIN), ("MT_TINY", TINY), ("MT_SUM_HI", SUM_HI),
                       ("MT_DET_HI", DET_HI)):
        assert np.float32(mt[name].rstrip("f")) == np.float32(want), name
    assert (int(k8["BRUTE_BLOCK"]), int(k8["BRUTE_TILE"])) == (brute.BLOCK, brute.TILE)
