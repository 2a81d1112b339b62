"""K1's prefilter (csrc/mt_test.cuh, which K1 and K8 run), on the CPU.

K1 runs the plain version's exact Moller-Trumbore test only on the pairs
that a division-free prefilter keeps: the numerators of u, v and t times an
approximate reciprocal of det (rcp.approx, within 2^-22 of 1/det), held
against -1e-30, 1 + 2^-14 and tmin and t_best with a margin of 2^-14 of
|t| (the last three only where |det| < 2^126, below which the reciprocal
is not flushed to 0). A float32 torch model of the kernel (the plain version's arithmetic in
its order, the prefilter's reciprocal at both ends of its error and exact)
must be bit-equal to `static_trace_plain` (t, u, v, prim; the any-hit mask
and its test counts, `any_hit_tests`) on adversarial rays made with numpy
from a seed: rays through triangle vertices and edges, det near +-1e-12,
t equal to tmin and to t_best, ties between duplicate triangles, grazing
rays, dead rays; and on every pair the exact test accepts, the prefilter
must have kept it. The prefilter's compares alone are also held
conservative on numerators drawn across the float range, with underflow
to -0.0, infinities and NaN."""

import math

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch.ops import static
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box
from torch_threads import share_cores

share_cores()

MARGIN = 2.0 ** -14  # MT_MARGIN
TINY = np.float32(1e-30)  # MT_TINY
SUM_HI = np.float32(1.0 + 2.0 ** -14)  # MT_SUM_HI
DET_HI = np.float32(2.0 ** 126)  # MT_DET_HI
RCP_ERR = (-2.0 ** -22, 0.0, 2.0 ** -22)  # the ends of rcp.approx's error, and none


def _f32_up(x):
    """float64 -> the least float32 not below it."""
    f = x.float()
    return torch.where(f.double() < x, torch.nextafter(f, torch.tensor(math.inf)), f)


def _f32_down(x):
    f = x.float()
    return torch.where(f.double() > x, torch.nextafter(f, torch.tensor(-math.inf)), f)


def t_hi(t_best):
    """mt_t_hi: fmaf_ru(|t|, 2^-20, t), then + 1e-30 rounded up."""
    t = t_best.double()
    return _f32_up(_f32_up(t.abs() * 2.0 ** -20 + t).double() + float(TINY))


def tmin_lo(tmin):
    """mt_tmin_lo, the host's bound below tmin."""
    t = torch.tensor(float(np.float32(tmin)), dtype=torch.float64)
    return _f32_down(t - t.abs() * 2.0 ** -20 - 1e-30)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def prefilter(det, un, vn, tn, tmin, rcp_err):
    """The prefilter on float32 numerators, its reciprocal 1/det * (1 +
    rcp_err) rounded to float32 and flushed to 0 below 2^-126, as
    rcp.approx.ftz returns it: (stage 1 rejects, stage 2 rejects whatever
    t_best is, where the bound above t_best applies (|det| < 2^126), and
    the approximate t's lower edge that is held against that bound)."""
    r = (1.0 / det.double() * (1.0 + rcp_err)).float()
    r = torch.where(r.abs() < 2.0 ** -126, 0.0 * r, r)  # .ftz: a subnormal result is 0
    au, av, at = un * r, vn * r, tn * r
    first = ~(det.abs() > 1e-12) | (au < -TINY)
    small = det.abs() < DET_HI
    second = (av < -TINY) | (small & (
        (au + av > SUM_HI) | (_fma(torch.full_like(at, MARGIN), at.abs(), at) < tmin_lo(tmin))))
    return first, second, small, _fma(torch.full_like(at, -MARGIN), at.abs(), at)


def rejects(det, un, vn, tn, tmin, t_best, rcp_err):
    """(stage 1 rejects, stage 2 rejects) of the prefilter on float32
    numerators against t_best."""
    first, second, small, at_lo = prefilter(det, un, vn, tn, tmin, rcp_err)
    return first, second | (small & (at_lo > t_hi(t_best)))


def exact_accepts(det, un, vn, tn, tmin, t_best):
    """The plain version's test on numerators (det_ok included)."""
    det_ok = det.abs() > 1e-12
    inv = torch.where(det_ok, torch.reciprocal(torch.where(det_ok, det, 1.0)), 0.0)
    uu, vv, tt = un * inv, vn * inv, tn * inv
    ok = det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > tmin) & (tt < t_best)
    return ok, uu, vv, tt


def k1_model(tris, origins, dirs, tmin, tmax, any_hit, rcp_err):
    """K1 in float32 torch: the plain version's numerators in its order, the
    prefilter, the exact test on what it keeps. Returns (t, u, v, prim),
    and the pairs the exact test accepts but the prefilter dropped."""
    ox, oy, oz = origins.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    t_best = tmax.clone()
    u = torch.zeros_like(t_best)
    v = torch.zeros_like(t_best)
    prim = torch.full(t_best.shape, -1, dtype=torch.int32)
    live = tmax > tmin
    dropped = 0
    for k, row in enumerate(tris.unbind(0)):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.unbind(0)
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
        first, second = rejects(det, un, vn, tn, tmin, t_best, rcp_err)
        ok, uu, vv, tt = exact_accepts(det, un, vn, tn, tmin, t_best)
        active = live & (prim < 0) if any_hit else live
        ok = ok & active
        dropped += int((ok & (first | second)).sum())
        ok = ok & ~first & ~second
        t_best = torch.where(ok, tt, t_best)
        u = torch.where(ok, uu, u)
        v = torch.where(ok, vv, v)
        prim = torch.where(ok, k, prim)
    return (t_best, u, v, prim), dropped


def _cornell():
    scene = build_scene(cornell_box())
    return torch.from_numpy(np.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
                            .astype(np.float32))


def _normalized(d):
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def adversarial(seed=3):
    """(tris [T,3,3], origins, dirs, tmin, tmax): the Cornell box's
    triangles plus duplicates, coplanar neighbours and tiny triangles whose
    det is near +-1e-12; rays from inside and outside the box, through
    vertices and edges, grazing, with t equal to tmin or to tmax, dead."""
    rng = np.random.default_rng(seed)
    tris = _cornell().numpy()
    extra = [tris[5], tris[17]]  # exact duplicates: ties go to the lower index
    a = tris[8].copy()
    extra.append(np.stack([a[0], a[2], a[0] + (a[2] - a[1])]))  # a coplanar neighbour
    # tiny triangles in front of the box whose det for a ray along +z is
    # -1e-6 * b: one float32 below 1e-12, 1e-12 and one above (edges exact)
    c = np.float32([0.0, 0.0, -2.5])
    for b in np.float32([9.999999e-07, 1e-06, 1.0000001e-06]):
        extra.append(np.stack([c, c + np.float32([1e-6, 0, 0]), c + np.float32([0, b, 0])]))
    tris = np.concatenate([tris, np.stack(extra)]).astype(np.float32)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]

    o, d = [], []
    n = 3000  # random rays, inside and out
    o.append(rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)))
    d.append(rng.normal(size=(n, 3)))
    o.append(rng.uniform([-1.5, 0.0, -4.0], [1.5, 2.0, -3.0], (n, 3)))
    d.append(rng.normal(size=(n, 3)) * [1, 1, 0.3] + [0, 0, 1])
    # through vertices, edges and their midpoints, from both sides
    st = np.float32([[0, 0], [1, 0], [0, 1], [0.5, 0], [0, 0.5], [0.5, 0.5], [1e-7, 0.5],
                     [0.5, 0.5 - 1e-7]])
    k = np.repeat(np.arange(len(tris)), len(st) * 4)
    sv = np.tile(np.repeat(st, 4, 0), (len(tris), 1))
    p = v0[k] + sv[:, :1] * e1[k] + sv[:, 1:] * e2[k]
    dd = _normalized(rng.normal(size=(len(k), 3)))
    o.append(p - dd * rng.uniform(0.5, 3.0, (len(k), 1)))
    d.append(dd)
    # grazing: nearly in the plane of a triangle, aimed at its centroid
    k = np.repeat(np.arange(len(tris)), 6)
    nrm = _normalized(np.cross(e1[k], e2[k]))
    inplane = _normalized(e1[k] + rng.normal(size=(len(k), 3)) * 1e-3)
    eps = np.tile([1e-2, 1e-4, 1e-6, 1e-8, -1e-6, 0.0], len(tris))[:, None]
    dd = _normalized(inplane + eps * nrm)
    o.append(v0[k] + (e1[k] + e2[k]) / 3 - dd * 0.7)
    d.append(dd)
    # along +z into the tiny triangles
    xy = rng.uniform(0, 1e-6, (600, 2))
    o.append(np.concatenate([xy, np.full((600, 1), -2.9)], -1))
    d.append(np.tile([0.0, 0.0, 1.0], (600, 1)))
    o = np.concatenate(o).astype(np.float32)
    d = _normalized(np.concatenate(d))
    tmax = np.full(len(o), 1e6, np.float32)
    tmax[::11] = -1.0  # dead
    tmax[5::11] = 0.0  # dead: tmax == tmin
    return torch.from_numpy(tris), torch.from_numpy(o), torch.from_numpy(d), tmax


def _packed(tris):
    return static.pack_triangles(tris).tris


@pytest.fixture(scope="module")
def rays():
    tris, o, d, tmax = adversarial()
    packed = _packed(tris)
    # t equal to tmin and to tmax: the exact t of each ray's closest hit
    t, _, _, prim = static.static_trace_plain(packed, o, d, 0.0, torch.from_numpy(tmax), False)
    hit = (prim >= 0).numpy()
    # t_best at the start equal to the closest hit's t (strict t < t_best: no
    # hit) or one ulp above it (the hit again), on alternate rays
    tmax_tie = tmax.copy()
    above = np.nextafter(t.numpy(), np.float32(np.inf))
    tmax_tie[hit] = np.where(np.arange(len(o))[hit] % 2 == 0, t.numpy()[hit], above[hit])
    return packed, o, d, tmax, tmax_tie, t.numpy(), hit


@pytest.mark.parametrize("rcp_err", RCP_ERR, ids=["rcp-lo", "rcp-exact", "rcp-hi"])
@pytest.mark.parametrize("case", ["tmin0", "tmin_eps", "tmax_tie", "tmin_tie"])
def test_k1_model_is_bit_equal_to_plain(rays, case, rcp_err):
    packed, o, d, tmax, tmax_tie, t_hit, hit = rays
    tmin = {"tmin0": 0.0, "tmin_eps": 1e-4, "tmax_tie": 0.0}.get(case, 0.0)
    tm = torch.from_numpy(tmax_tie if case == "tmax_tie" else tmax)
    if case == "tmin_tie":  # tmin equal to a hit's t: strict tmin < t drops that hit
        tmin = float(np.median(t_hit[hit]))
    for any_hit in (False, True):
        want = static.static_trace_plain(packed, o, d, tmin, tm, any_hit)
        got, dropped = k1_model(packed, o, d, tmin, tm, any_hit, rcp_err)
        assert dropped == 0, f"the prefilter dropped {dropped} pairs the exact test accepts"
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if any_hit:
            tests = static.any_hit_tests(packed, o, d, tmin, tm)
            prim = got[3].long()
            assert torch.equal(tests, torch.where(tm > tmin, torch.where(
                prim >= 0, prim + 1, packed.shape[0]), 0))
            assert int(tests.max()) == packed.shape[0] and int(tests.min()) == 0
    assert int((want[3] >= 0).sum()) > len(o) // 8  # the rays do hit


def test_adversarial_rays_reach_the_edge_cases(rays):
    """The set holds what it is for: hits within 1e-6 of an edge, det one
    float32 either side of 1e-12 and at it, exact ties."""
    packed, o, d, tmax, _, _, _ = rays
    t, u, v, prim = static.static_trace_plain(packed, o, d, 0.0, torch.from_numpy(tmax), False)
    h = prim >= 0
    edge = h & ((u < 1e-6) | (v < 1e-6) | (1 - u - v < 1e-6))
    assert int(edge.sum()) > 50
    tiny = h & (prim >= packed.shape[0] - 3)  # the tiny triangles are last
    assert int(tiny.sum()) > 10
    e1, e2 = packed[-3:, 3:6], packed[-3:, 6:9]
    det = (e1 * torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0]).expand(3, 3), e2)).sum(-1)
    one = torch.tensor(1e-12, dtype=torch.float32)
    assert torch.equal(det.abs(), torch.stack([torch.nextafter(one, torch.tensor(0.0)), one,
                                               torch.nextafter(one, torch.tensor(1.0))]))
    assert sorted(set(prim[tiny].tolist())) == [packed.shape[0] - 1]  # only |det| > 1e-12 hits
    # the duplicates of triangles 5 and 17 (40, 41) lose every tie
    assert int(((prim == 5) | (prim == 17)).sum()) > 20
    assert int(((prim == 40) | (prim == 41)).sum()) == 0


def test_prefilter_compares_are_conservative():
    """On numerators across the float range and at its edges, no pair the
    exact test accepts is rejected, at either end of rcp.approx's error."""
    rng = np.random.default_rng(5)
    n = 400_000
    sign = lambda: rng.choice([-1.0, 1.0], n)  # noqa: E731
    det = sign() * 10.0 ** rng.uniform(-12.5, 38.5, n)
    det[:1000] = sign()[:1000] * np.float32(1e-12) * (1 + rng.uniform(-1e-6, 1e-6, 1000))
    det = np.clip(det, -3.4e38, 3.4e38).astype(np.float32)
    a = rng.uniform(-0.2, 1.2, n)
    b = rng.uniform(-0.2, 1.2, n)
    b[: n // 4] = 1.0 - a[: n // 4]  # u + v near 1
    with np.errstate(over="ignore"):  # a * det beyond float32 is inf, as it should be
        un, vn = (a * det).astype(np.float32), (b * det).astype(np.float32)
    un[n // 4: n // 4 + 5000] = -np.float32(1e-45) * np.sign(det[n // 4: n // 4 + 5000])  # u -> -0.0
    tmin = np.float32(rng.choice([0.0, 1e-4, 0.5, -2.0]))
    t = rng.choice([tmin, 1.0, 1e-30, 1e20], n) * (1 + rng.uniform(-1e-6, 1e-6, n))
    with np.errstate(over="ignore"):
        tn = (t * det).astype(np.float32)
    # a few ulps around the exact boundaries
    ulps = rng.integers(-4, 5, n).astype(np.int32)
    tn = (tn.view(np.int32) + np.where(rng.random(n) < 0.5, ulps, 0)).view(np.float32)
    vn = (vn.view(np.int32) + np.where(rng.random(n) < 0.5, ulps, 0)).view(np.float32)
    t_best = np.where(rng.random(n) < 0.5, np.float32(1e6), np.abs(t).astype(np.float32) + tmin)
    specials = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4e38])
    idx = rng.integers(0, n, 3000)
    tn[idx] = rng.choice(specials, 3000)
    det[idx[::3]] = rng.choice(specials, 1000)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (det, un, vn, tn)]
    tb = torch.from_numpy(t_best.astype(np.float32))
    ok, _, _, _ = exact_accepts(*args, float(tmin), tb)
    assert int(ok.sum()) > n // 20
    for rcp_err in RCP_ERR:
        first, second = rejects(*args, float(tmin), tb, rcp_err)
        assert not bool((ok & (first | second)).any())
        assert float((first | second).double().mean()) > 0.5  # the prefilter does reject
