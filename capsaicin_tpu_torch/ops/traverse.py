"""BVH walks in plain torch: the stackless walk, counterpart of
capsaicin_tpu/ops/traverse.py and the plain version of kernel K7 (ops.bvh,
`csrc/bvh_trace.cu`) on CPU tensors, and the ordered walk, the one K7
does, whose work K7's bound is counted from.

Each ray's walk state is one heap index. A step tests the node's box; a
hit on an internal node descends to its left child (2k), anything else
moves to the DFS successor (strip trailing ones, step right), which is
integer arithmetic on the index because the tree is an implicit heap
(ops.lbvh). At a leaf whose box is hit, the leaf's triangles are tested in
slot order with the Moller-Trumbore epsilons of K1. The JAX package steps
every ray in lockstep until all are done; here each step works on the
rays still walking only (the same walk per ray, so the same result).

A miss returns t = tmax, u = v = 0, prim = -1. A dead ray (tmax < tmin)
does no work. With `counts=True` the result also holds, per ray, the
box tests (`boxes`) and the tests of real triangles (`tris`) it did.

The ordered walk (`ordered_walk`) is the near-first stack walk of the
sibling pairs that K7 has done since it was written: a step at internal
node k fetches the pair record of its children 2k and 2k+1, tests both
boxes (an empty child is not tested) and orders them by the pair's code
(`pair_codes`) against the ray's own direction sign. Internal children:
go to the near one that was hit, pushing the far one if it was hit too.
Leaf children: the near leaf's triangles if its box was hit, then the far
leaf's if its box was hit and is still no farther than the best hit. Then
pop. It visits the leaves in near-first DFS order, so its closest hit is
the first tested of the triangles at the smallest accepted t; it differs
from the stackless walk's only where two triangles are hit at the same t.
Its counts add `records`, the pair records fetched.
"""

from __future__ import annotations

import numpy as np
import torch

from .lbvh import BVH

M32 = 0xFFFFFFFF


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits, in int64."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _dfs_next(k: torch.Tensor) -> torch.Tensor:
    """DFS successor in the implicit heap: strip trailing ones, step
    right. 1 (the root) when the walk is over."""
    lowest_zero = (~k) & (k + 1)
    up = k >> _popcount(lowest_zero - 1)
    return torch.where(up <= 1, 1, up + 1)


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


def traverse(bvh: BVH, origins, dirs, tmin, tmax, any_hit: bool, counts: bool = False):
    """The walk for rays [N,3]; tmin and tmax scalars or [N]. Returns
    {"t","u","v","prim"} (and "boxes", "tris" with `counts`)."""
    dev = origins.device
    bvh = _as_tensors(bvh, dev)
    n = origins.shape[0]
    n_leaves, leaf_size = bvh.n_leaves, bvh.leaf_size
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    tmin = torch.as_tensor(tmin, **f32).expand(n)
    tmax = torch.as_tensor(tmax, **f32).expand(n)
    boxes = torch.cat([bvh.nodes_min, bvh.nodes_max], 1)  # [2L, 6]
    tris = torch.cat([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], 1)  # [P, 9]
    tri_id = bvh.tri_id.long()

    hit = torch.stack([tmax, torch.zeros(n, **f32), torch.zeros(n, **f32)], 1)  # t, u, v
    prim = torch.full((n,), -1, **i64)
    work = torch.zeros((n, 2), **i64)  # box tests, real triangle tests
    # the walking rays, compacted as they finish: their index in the
    # output, their rays (o, d, inverse d, tmin, tmax), best hit, walk
    # state (k) and work
    ids = torch.nonzero(tmax >= tmin).squeeze(1)
    ray = torch.cat([origins[ids], dirs[ids], _safe_inv(dirs[ids]), tmin[ids, None],
                     tmax[ids, None]], 1)
    w_hit, w_prim, w_work = hit[ids], prim[ids], work[ids]
    k = torch.ones_like(ids)
    done = torch.zeros_like(ids, dtype=torch.bool)

    while ids.numel():
        box = boxes[k]
        hit_box = _slab_near(ray[:, 0:3], ray[:, 6:9], box[:, 0:3], box[:, 3:6], ray[:, 9],
                             w_hit[:, 0])[0] & ~done
        w_work[:, 0] += (~done).long()
        is_leaf = k >= n_leaves

        leaf = torch.nonzero(hit_box & is_leaf).squeeze(1)
        if leaf.numel():  # the whole leaf, as the JAX walk tests it
            cand, tid, closer, tested = _leaf(tris, tri_id, k[leaf] - n_leaves, leaf_size,
                                              ray[leaf], w_hit[leaf], False)
            w_hit[leaf] = torch.where(closer[:, None], cand, w_hit[leaf])
            w_prim[leaf] = torch.where(closer, tid, w_prim[leaf])
            w_work[leaf, 1] += tested

        k = torch.where(hit_box & ~is_leaf, 2 * k, _dfs_next(k))
        done = done | (k <= 1)
        if any_hit:
            done |= w_prim >= 0
        n_done = int(done.sum())
        if 2 * n_done > ids.numel() or n_done == ids.numel():
            fin, keep = ids[done], ~done
            hit[fin], prim[fin], work[fin] = w_hit[done], w_prim[done], w_work[done]
            ids, ray, w_hit, w_prim, w_work, k = (x[keep] for x in (ids, ray, w_hit, w_prim,
                                                                    w_work, k))
            done = done[keep]

    out = {"t": hit[:, 0], "u": hit[:, 1], "v": hit[:, 2], "prim": prim.to(torch.int32)}
    if counts:
        out.update(boxes=work[:, 0], tris=work[:, 1])
    return out


def bvh_closest(bvh: BVH, origins, dirs, tmin=0.0, tmax=1e6, counts: bool = False):
    """Closest-hit query; equal to the brute-force oracle up to ties."""
    return traverse(bvh, origins, dirs, tmin, tmax, any_hit=False, counts=counts)


def bvh_any(bvh: BVH, origins, dirs, tmin=1e-4, tmax=1e6):
    """Any-hit (shadow) query: True where a triangle is hit in (tmin, tmax);
    a ray stops at the end of the leaf where it first hits."""
    return traverse(bvh, origins, dirs, tmin, tmax, any_hit=True)["prim"] >= 0


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


EMPTY_SLOT = -2**31 + 1  # ops.bvh's mark of a slot with no triangle


def wide_walk(records, bvh: BVH, origins, dirs, tmin, tmax, any_hit: bool, counts: bool = False):
    """K7's walk, step for step, but for the leaves a lane of the kernel
    holds: the four-wide walk over the octant records of
    ops.bvh.pack_octant_records [8 * n_wide, 32] (numpy or tensor). A step
    fetches a record of the ray's octant copy, tests its slots that hold
    triangles, goes to the first that passed and pushes the others with
    their entry distance (last first); a popped entry whose distance is
    beyond the best hit is dropped. It tests the ordered walk's leaves in
    the ordered walk's order, so its hits are bit-equal to ordered_walk's;
    with `counts`, "boxes", "tris" and "records" are its own work
    (four-wide records fetched; a kernel lane that holds a leaf fetches a
    few more)."""
    dev = origins.device
    records = torch.as_tensor(records).to(dev)
    n_wide = records.shape[0] // 8
    boxes = records[:, :24].reshape(-1, 6, 4).transpose(1, 2)  # [R, slot, lo xyz hi xyz]
    refs = records[:, 24:28].contiguous().view(torch.int32).long()  # [R, 4]
    bvh = _as_tensors(bvh, dev)
    n = origins.shape[0]
    n_leaves, leaf_size = bvh.n_leaves, bvh.leaf_size
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    tmin = torch.as_tensor(tmin, **f32).expand(n)
    tmax = torch.as_tensor(tmax, **f32).expand(n)
    tris = torch.cat([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], 1)
    tri_id = bvh.tri_id.long()
    depth = bvh.depth

    hit = torch.stack([tmax, torch.zeros(n, **f32), torch.zeros(n, **f32)], 1)
    prim = torch.full((n,), -1, **i64)
    work = torch.zeros((n, 3), **i64)  # box tests, real triangle tests, records
    ids = torch.nonzero(tmax >= tmin).squeeze(1)
    o, d = origins[ids], dirs[ids]
    ray = torch.cat([o, d, _safe_inv(d), tmin[ids, None], tmax[ids, None]], 1)
    octant = ((d > 0).long() * torch.tensor([1, 2, 4], device=dev)).sum(1) * n_wide
    w_hit, w_prim, w_work = hit[ids], prim[ids], work[ids]
    cur = torch.zeros_like(ids)
    entries = 3 * (depth // 2) + depth % 2
    stack_ref = torch.zeros((ids.numel(), entries), **i64)
    stack_t = torch.zeros((ids.numel(), entries), **f32)
    sp = torch.zeros_like(ids)
    done = torch.zeros_like(ids, dtype=torch.bool)
    slot = torch.arange(4, device=dev)

    while ids.numel():
        at_record = ~done & (cur >= 0)
        rows = torch.nonzero(at_record).squeeze(1)
        pop = torch.zeros_like(done)
        if rows.numel():
            r = ray[rows]
            rec = octant[rows] + cur[rows]
            b, ref = boxes[rec], refs[rec]
            valid = ref != EMPTY_SLOT
            ok, t_near = _slab_near(r[:, None, 0:3], r[:, None, 6:9], b[..., 0:3], b[..., 3:6],
                                    r[:, None, 9], w_hit[rows, 0:1])
            passed = ok & valid
            w_work[rows, 0] += valid.sum(1)
            w_work[rows, 2] += 1
            first = torch.where(passed, slot, 4).amin(1)
            for s in (3, 2, 1):  # push the passed slots after the first, last first
                push = passed[:, s] & (s > first)
                p = rows[push]
                stack_ref[p, sp[p]] = ref[push, s]
                stack_t[p, sp[p]] = t_near[push, s]
                sp[p] += 1
            some = first < 4
            cur[rows[some]] = ref[some].gather(1, first[some, None])[:, 0]
            pop[rows[~some]] = True
        rows = torch.nonzero(~done & ~at_record).squeeze(1)  # at a leaf
        if rows.numel():
            cand, tid, acc, tested = _leaf(tris, tri_id, ~cur[rows], leaf_size, ray[rows],
                                           w_hit[rows], any_hit)
            w_hit[rows] = torch.where(acc[:, None], cand, w_hit[rows])
            w_prim[rows] = torch.where(acc, tid, w_prim[rows])
            w_work[rows, 1] += tested
            if any_hit:
                done[rows] |= acc
            pop[rows] = ~done[rows]
        while bool(pop.any()):  # pop until an entry is still near enough
            empty = pop & (sp == 0)
            done |= empty
            pop &= ~empty
            rows = torch.nonzero(pop).squeeze(1)
            sp[rows] -= 1
            near = stack_t[rows, sp[rows]] <= w_hit[rows, 0]
            cur[rows[near]] = stack_ref[rows[near], sp[rows[near]]]
            pop[rows[near]] = False

        n_done = int(done.sum())
        if 2 * n_done > ids.numel() or n_done == ids.numel():
            fin, keep = ids[done], ~done
            hit[fin], prim[fin], work[fin] = w_hit[done], w_prim[done], w_work[done]
            ids, ray, octant, w_hit, w_prim, w_work, cur, stack_ref, stack_t, sp = (
                x[keep] for x in (ids, ray, octant, w_hit, w_prim, w_work, cur, stack_ref,
                                  stack_t, sp))
            done = done[keep]

    out = {"t": hit[:, 0], "u": hit[:, 1], "v": hit[:, 2], "prim": prim.to(torch.int32)}
    if counts:
        out.update(boxes=work[:, 0], tris=work[:, 1], records=work[:, 2])
    return out
