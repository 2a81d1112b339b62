"""Ray traversal in plain torch, as frozen copies of the port's plain
versions: every ray against every triangle in index order
(capsaicin_tpu_torch/ops/static.py's static_trace_plain), and the
object-median BVH (ops/lbvh.py's build_median_bvh) walked near-first
with a stack (ops/traverse.py's ordered_walk). Both use the
Moller-Trumbore test with the epsilons of the port's kernels. A miss
returns t = tmax, u = v = 0, prim = -1; a dead ray (tmax < tmin) does no
work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = np.float32(3e38)
LEAF_SIZE = 4
class BVH(NamedTuple):
    """nodes_min/max [2*n_leaves, 3]; triangles in leaf order, padded to
    n_leaves*leaf_size: v0 and the edges e1 = v1-v0, e2 = v2-v0 [P,3], and
    tri_id [P] (the input triangle index, -1 for padding). Torch tensors
    from build_lbvh, numpy arrays from build_median_bvh."""

    nodes_min: object
    nodes_max: object
    tri_v0: object
    tri_e1: object
    tri_e2: object
    tri_id: object

    @property
    def n_leaves(self) -> int:
        return self.nodes_min.shape[0] // 2

    @property
    def leaf_size(self) -> int:
        return self.tri_v0.shape[0] // self.n_leaves

    @property
    def depth(self) -> int:
        return int(self.n_leaves).bit_length() - 1

def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _n_leaves(t: int, leaf_size: int) -> int:
    # at least 2 leaves, so the root is an internal node
    return max(2, _next_pow2(-(-t // leaf_size)))


def _fit_heap(leaf_min, leaf_max, cat, minimum, maximum, full):
    """Heap node boxes from leaf boxes, level by level."""
    levels_min, levels_max = [leaf_min], [leaf_max]
    cur_min, cur_max = leaf_min, leaf_max
    while cur_min.shape[0] > 1:
        cur_min = minimum(cur_min[0::2], cur_min[1::2])
        cur_max = maximum(cur_max[0::2], cur_max[1::2])
        levels_min.append(cur_min)
        levels_max.append(cur_max)
    return (cat([full(INF)] + levels_min[::-1]), cat([full(-INF)] + levels_max[::-1]))


def build_median_bvh(tris, leaf_size: int = 4) -> BVH:
    """tris [T,3,3] (numpy or tensor) -> the object-median BVH, all numpy:
    each split partitions its triangle range at the slot midpoint by
    centroid along the locally longest axis. Runs once per scene upload."""
    tris_np = tris.cpu().numpy() if isinstance(tris, torch.Tensor) else np.asarray(tris)
    t = tris_np.shape[0]
    n_leaves = _n_leaves(t, leaf_size)
    v0, v1, v2 = tris_np[:, 0], tris_np[:, 1], tris_np[:, 2]
    centroids = (v0 + v1 + v2) / 3.0

    def split(seg, slots):
        if slots <= leaf_size:
            return [seg]
        if len(seg) == 0:
            return [seg] * (slots // leaf_size)  # a run of empty leaves
        half = slots // 2
        if len(seg) <= half:  # all fit on the left; the right stays empty
            return split(seg, half) + split(seg[:0], half)
        c = centroids[seg]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = np.argpartition(c[:, axis], half - 1)
        return split(seg[part[:half]], half) + split(seg[part[half:]], half)

    order_parts, id_parts = [], []
    for leaf_seg in split(np.arange(t, dtype=np.int32), n_leaves * leaf_size):
        pad = leaf_size - len(leaf_seg)
        order_parts += [leaf_seg, np.zeros(pad, np.int32)]  # padding: triangle 0, id -1
        id_parts += [leaf_seg, np.full(pad, -1, np.int32)]
    order = np.concatenate(order_parts)
    tri_id = np.concatenate(id_parts)
    gv0, gv1, gv2 = v0[order], v1[order], v2[order]

    valid = (tri_id >= 0)[:, None]
    inf = float(INF)
    p_min = np.where(valid, np.minimum(np.minimum(gv0, gv1), gv2), inf)
    p_max = np.where(valid, np.maximum(np.maximum(gv0, gv1), gv2), -inf)
    nodes_min, nodes_max = _fit_heap(
        p_min.reshape(n_leaves, leaf_size, 3).min(axis=1),
        p_max.reshape(n_leaves, leaf_size, 3).max(axis=1),
        np.concatenate, np.minimum, np.maximum, lambda x: np.full((1, 3), float(x)))
    f32 = np.float32
    return BVH(nodes_min.astype(f32), nodes_max.astype(f32), gv0.astype(f32),
               (gv1 - gv0).astype(f32), (gv2 - gv0).astype(f32), tri_id)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    tiny = d.abs() < 1e-12
    return torch.where(tiny, torch.where(d < 0, -1e12, 1e12),
                       torch.reciprocal(torch.where(tiny, 1.0, d)))


def _mt_single(o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore, one triangle per ray (all [N,3]), with the
    arithmetic order of K1 and K7."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z = v0.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, torch.reciprocal(torch.where(det_ok, det, 1.0)), 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < tmax)
    return t, u, v, ok


def pair_codes(bvh: BVH) -> np.ndarray:
    """[n_leaves] float32: the near/far code of each sibling pair k (of
    children 2k, 2k+1), 0 at k = 0: the axis of the largest centre offset,
    plus 4 when the left child is the lower one (column 6 of the JAX
    package's `pack_bvh` rows). A ray goes to the left child first when
    its direction is positive on that axis exactly when the code has 4."""
    lo, hi = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in (bvh.nodes_min, bvh.nodes_max))
    centers = (lo + hi) * np.float32(0.5)
    diff = centers[3::2] - centers[2::2]
    axis = np.argmax(np.abs(diff), axis=1)
    low = np.take_along_axis(diff, axis[:, None], axis=1)[:, 0] >= 0
    return np.concatenate([[0.0], axis + 4 * low]).astype(np.float32)


def _slab_near(o, inv_d, lo, hi, tmin, tmax):
    """Rays against boxes (o, inv_d, lo, hi [..., 3]): the slab test, and
    the entry distance t_near."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax), t_near


def _leaf(tris, tri_id, leaf, leaf_size, ray, best, any_hit):
    """The triangles of leaves `leaf` [M] in slot order against rays `ray`
    [M, 11] with best hits `best` [M, 3] (t, u, v), as K7 tests them: the
    first slot at the smallest t below best (any-hit: the first slot
    below it). Returns (candidate [M, 3], its id [M], accepted [M], real
    triangles tested [M])."""
    slots = leaf[:, None] * leaf_size + torch.arange(leaf_size, device=leaf.device)
    tid = tri_id[slots]
    tri = tris[slots]
    r = ray[:, None]
    tt, uu, vv, ok = _mt_single(r[..., 0:3], r[..., 3:6], tri[..., 0:3], tri[..., 3:6],
                                tri[..., 6:9], r[..., 9], best[:, 0:1])
    ok = ok & (tid >= 0)
    real = (tid >= 0).sum(1)
    if any_hit:
        j = torch.where(ok.any(1), ok.long().argmax(1), 0)[:, None]
        tested = torch.where(ok.any(1), j[:, 0] + 1, real)
    else:
        j = torch.where(ok, tt, float("inf")).argmin(1, keepdim=True)
        tested = real
    cand = torch.cat([tt.gather(1, j), uu.gather(1, j), vv.gather(1, j)], 1)
    return cand, tid.gather(1, j)[:, 0], ok.gather(1, j)[:, 0], tested


def _as_tensors(bvh: BVH, device) -> BVH:
    return BVH(*[torch.as_tensor(x).to(device) for x in bvh])


def ordered_walk(bvh: BVH, origins, dirs, tmin, tmax, any_hit: bool, counts: bool = False):
    """The ordered walk (module doc) for rays [N,3]; tmin and tmax scalars
    or [N]. Returns {"t","u","v","prim"} (and "boxes", "tris", "records"
    with `counts`), as traverse does."""
    dev = origins.device
    codes = torch.from_numpy(pair_codes(bvh)).to(dev).long()
    bvh = _as_tensors(bvh, dev)
    n = origins.shape[0]
    n_leaves, leaf_size, depth = bvh.n_leaves, bvh.leaf_size, bvh.depth
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    tmin = torch.as_tensor(tmin, **f32).expand(n)
    tmax = torch.as_tensor(tmax, **f32).expand(n)
    lo, hi = bvh.nodes_min, bvh.nodes_max
    empty = lo[:, 0] > hi[:, 0]
    tris = torch.cat([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], 1)
    tri_id = bvh.tri_id.long()

    hit = torch.stack([tmax, torch.zeros(n, **f32), torch.zeros(n, **f32)], 1)
    prim = torch.full((n,), -1, **i64)
    work = torch.zeros((n, 3), **i64)  # box tests, real triangle tests, records
    ids = torch.nonzero(tmax >= tmin).squeeze(1)
    ray = torch.cat([origins[ids], dirs[ids], _safe_inv(dirs[ids]), tmin[ids, None],
                     tmax[ids, None]], 1)
    w_hit, w_prim, w_work = hit[ids], prim[ids], work[ids]
    k = torch.ones_like(ids)
    stack = torch.zeros((ids.numel(), max(depth, 1)), **i64)
    sp = torch.zeros_like(ids)
    done = torch.zeros_like(ids, dtype=torch.bool)

    while ids.numel():
        live = ~done
        c0 = 2 * k
        t_near, hits = [], []
        for c in (c0, c0 + 1):
            ok, tn = _slab_near(ray[:, 0:3], ray[:, 6:9], lo[c], hi[c], ray[:, 9], w_hit[:, 0])
            hits.append(ok & ~empty[c] & live)
            t_near.append(tn)
            w_work[:, 0] += (~empty[c] & live).long()
        w_work[:, 2] += live.long()
        code = codes[k]
        d_pos = ray[:, 3:6].gather(1, (code & 3)[:, None])[:, 0] > 0
        near_left = d_pos == (code >= 4)
        near = torch.where(near_left, c0, c0 + 1)
        far = torch.where(near_left, c0 + 1, c0)
        hit_near = torch.where(near_left, hits[0], hits[1])
        hit_far = torch.where(near_left, hits[1], hits[0])
        t_far = torch.where(near_left, t_near[1], t_near[0])
        at_leaves = c0 >= n_leaves

        # leaf children: the near leaf, then the far one if its box is still
        # no farther than the best hit
        for leaf_of, is_far in ((near, False), (far, True)):
            test = (at_leaves & hit_far & (t_far <= w_hit[:, 0]) & ~done if is_far
                    else at_leaves & hit_near)
            rows = torch.nonzero(test).squeeze(1)
            if rows.numel():
                cand, tid, acc, tested = _leaf(tris, tri_id, leaf_of[rows] - n_leaves, leaf_size,
                                               ray[rows], w_hit[rows], any_hit)
                w_hit[rows] = torch.where(acc[:, None], cand, w_hit[rows])
                w_prim[rows] = torch.where(acc, tid, w_prim[rows])
                w_work[rows, 1] += tested
                if any_hit:
                    done[rows] |= acc

        # internal children: descend to the near (pushing the far) or far one
        inner = live & ~at_leaves & ~done
        push = inner & hit_near & hit_far
        rows = torch.nonzero(push).squeeze(1)
        stack[rows, sp[rows]] = far[rows]
        sp = sp + push.long()
        k = torch.where(inner & hit_near, near, torch.where(inner & hit_far, far, k))
        pop = live & ~done & (at_leaves | ~(hit_near | hit_far))
        done |= pop & (sp == 0)
        pop &= sp > 0
        rows = torch.nonzero(pop).squeeze(1)
        sp = sp - pop.long()
        k[rows] = stack[rows, sp[rows]]

        n_done = int(done.sum())
        if 2 * n_done > ids.numel() or n_done == ids.numel():
            fin, keep = ids[done], ~done
            hit[fin], prim[fin], work[fin] = w_hit[done], w_prim[done], w_work[done]
            ids, ray, w_hit, w_prim, w_work, k, stack, sp = (
                x[keep] for x in (ids, ray, w_hit, w_prim, w_work, k, stack, sp))
            done = done[keep]

    out = {"t": hit[:, 0], "u": hit[:, 1], "v": hit[:, 2], "prim": prim.to(torch.int32)}
    if counts:
        out.update(boxes=work[:, 0], tris=work[:, 1], records=work[:, 2])
    return out


def static_trace_plain(tris, origins, dirs, tmin: float, tmax, any_hit: bool):
    """The plain version of K1: the same arithmetic, one triangle at a time
    over all rays. Returns (t, u, v, prim)."""
    ox, oy, oz = origins.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    t_best = tmax.clone()
    u = torch.zeros_like(t_best)
    v = torch.zeros_like(t_best)
    prim = torch.full(t_best.shape, -1, dtype=torch.int32, device=t_best.device)
    for k, row in enumerate(tris.unbind(0)):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.unbind(0)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = det.abs() > 1e-12
        inv_det = torch.where(det_ok, torch.reciprocal(torch.where(det_ok, det, 1.0)), 0.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        uu = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (tt > tmin) & (tt < t_best))
        if any_hit:
            ok = ok & (prim < 0)
        t_best = torch.where(ok, tt, t_best)
        u = torch.where(ok, uu, u)
        v = torch.where(ok, vv, v)
        prim = torch.where(ok, k, prim)
    return t_best, u, v, prim




def make_traversal(tris: torch.Tensor, mode: str):
    """(closest_fn, any_fn) over triangles [T,3,3] on their device:
    closest_fn(origins [N,3], dirs [N,3], tmin, tmax) -> {"t","u","v","prim"},
    any_fn(...) -> bool [N]. mode "all_pairs" tests every ray against every
    triangle; "bvh" walks the median BVH, built here on the host."""
    v0 = tris[:, 0]
    if mode == "all_pairs":
        packed = torch.cat([v0, tris[:, 1] - v0, tris[:, 2] - v0], -1)

        def trace(origins, dirs, tmin, tmax, any_hit):
            tmax = torch.as_tensor(tmax, dtype=torch.float32,
                                   device=origins.device).expand(origins.shape[0])
            return static_trace_plain(packed, origins, dirs, tmin, tmax, any_hit)

        def closest(origins, dirs, tmin, tmax):
            return dict(zip(("t", "u", "v", "prim"), trace(origins, dirs, tmin, tmax, False)))

        def any_hit(origins, dirs, tmin, tmax):
            return trace(origins, dirs, tmin, tmax, True)[3] >= 0

        return closest, any_hit
    if mode != "bvh":
        raise ValueError(f"unknown reference traversal {mode!r}")
    bvh = _as_tensors(build_median_bvh(tris.cpu().numpy(), LEAF_SIZE), tris.device)

    def closest(origins, dirs, tmin, tmax):
        return ordered_walk(bvh, origins, dirs, tmin, tmax, any_hit=False)

    def any_hit(origins, dirs, tmin, tmax):
        return ordered_walk(bvh, origins, dirs, tmin, tmax, any_hit=True)["prim"] >= 0

    return closest, any_hit
