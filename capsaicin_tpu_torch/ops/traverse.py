"""Stackless BVH traversal in plain torch: the counterpart of
capsaicin_tpu/ops/traverse.py, and the plain version of kernel K7
(ops.bvh, `csrc/bvh_trace.cu`).

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
box tests (`boxes`) and the tests of real triangles (`tris`) it did:
the work that K7's bound is counted from.
"""

from __future__ import annotations

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


def _slab_test(o, inv_d, lo, hi, tmin, tmax):
    """Ray against box; o, inv_d, lo, hi [N,3]."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= tmax)


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
    slot = torch.arange(leaf_size, device=dev)

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
        hit_box = _slab_test(ray[:, 0:3], ray[:, 6:9], box[:, 0:3], box[:, 3:6], ray[:, 9],
                             w_hit[:, 0]) & ~done
        w_work[:, 0] += (~done).long()
        is_leaf = k >= n_leaves

        leaf = torch.nonzero(hit_box & is_leaf).squeeze(1)
        if leaf.numel():
            # the leaf's slots at once: the first of the smallest t is the
            # hit that testing them in slot order on a strict < keeps
            slots = (k[leaf, None] - n_leaves) * leaf_size + slot
            tid = tri_id[slots]
            tri = tris[slots]
            r = ray[leaf, None]
            best = w_hit[leaf]
            tt, uu, vv, ok = _mt_single(r[..., 0:3], r[..., 3:6], tri[..., 0:3], tri[..., 3:6],
                                        tri[..., 6:9], r[..., 9],
                                        torch.minimum(r[..., 10], best[:, 0:1]))
            tt = torch.where(ok & (tid >= 0), tt, float("inf"))
            j = tt.argmin(1, keepdim=True)
            cand = torch.cat([tt.gather(1, j), uu.gather(1, j), vv.gather(1, j)], 1)
            closer = cand[:, 0] < best[:, 0]
            w_hit[leaf] = torch.where(closer[:, None], cand, best)
            w_prim[leaf] = torch.where(closer, tid.gather(1, j)[:, 0], w_prim[leaf])
            w_work[leaf, 1] += (tid >= 0).sum(1)

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
