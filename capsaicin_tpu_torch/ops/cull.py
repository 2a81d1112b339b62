"""Dense-cull traversal: the torch counterpart of capsaicin_tpu/ops/cull.py
(traversal="cull").

Rays go in packets of G = 32 (the last padded with dead rays). Every
packet runs the same four-stage funnel over the median BVH of leaves of 8
triangles (one "row" a leaf):

  1. Dense cull: the packet against every node of one tree level (a static
     [8,S] table): packet-interval tests for coherent rays (primary and
     shadow), per-ray slab tests OR-reduced over the packet for incoherent
     ones (bounce and NEE).
  2. Descent: over the remaining levels, the frontier's children tested and
     rank-compacted back to B slots (topk of the keys c - slot), in heap
     order.
  3. Row refine (incoherent only): per-ray slab tests against the leaf
     rows' boxes.
  4. Moller-Trumbore over the hit rows, K rows a wave, as one [P,G,T]
     tensor a chunk of MT_CHUNK rows reduced over T with min and argmin
     (the first minimal triangle, as jnp.argmin), the winner's u and v
     recomputed once (`_mt_finalize`).

Budgets are fixed: a packet whose candidates exceed one is re-run in a
compacted pass at 4x the budgets (`_retrace`), and a packet that still
overflows streams every leaf row (`_rescue_sweep`), so the results are
exact at any budget. The JAX package's lax.while_loops are Python loops
here, each reading its stop rule on the host once a step. Eager PyTorch
changes three things, none of which changes a result, since each packet's
passes depend on that packet alone: the retrace and the rescue take all
their packets in one batch (the JAX package, bound to static shapes, takes
fixed batches of P/8 and P/64, the rest of a batch poisoned); a wave, and
an any-hit rescue wave, trace only the packets with work left (a null row
hits nothing, and a packet whose live rays have all hit keeps its hits);
and the [P,G,C] and [P,G,T] stages run in pieces of at most ELEMS_PER_CHUNK
elements, which bounds the temporaries at 1080p (64,800 packets).

The tables are the JAX package's (`CullBVH`), packed on the host in numpy
from ops.lbvh.build_median_bvh at leaf size 8 and uploaded once. Contracts:
closest hit returns t = 1e30 on a miss, u = v = 0 and prim -1; any-hit
reports a dead ray (tmax < tmin) as not hit. tmin and tmax are scalars or
[N].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lbvh
from .wavefront import _mt_terms, _put, _sub, pad_rays

G = 32              # rays per packet
TRIS_PER_ROW = 8    # one leaf row = 8 triangles
ROW_F = 80          # 8 tris x 10 floats (v0, e1, e2, tid+1)
MT_CHUNK = 16       # rows per MT step (128 triangles)
INF = 1e30
ELEMS_PER_CHUNK = 1 << 24  # elements of one [P,G,C] or [P,G,T] piece

# default budgets: frontier slots (B) and MT rows per wave (K)
COH_B, COH_K = 48, 32
INC_B, INC_K = 160, 96

# The fallback work of the traces since the caller last zeroed it: the
# packets re-run at 4x the budgets and those swept over every row
STATS = {"retraced": 0, "rescued": 0}


class CullBVH:
    """The funnel's tables on a device:

    pair_rows: [L,16] float32 - row k = the records of children (2k, 2k+1):
               (lo xyz, hi xyz, valid, pad) x 2. Row 0 holds inverted
               infinite boxes with valid 0, so an empty frontier slot (id 0)
               never hits.
    tri_rows:  [L+1,80] float32 - leaf row l = 8 triangles (v0, e1, e2,
               id + 1), id + 1 = 0 marking padding; the last row all zero.
    coh_boxes/inc_boxes: [8,S] float32, the level tables of the coherent and
               incoherent stage 1, transposed (rows: lo xyz, hi xyz, valid,
               pad).
    A node is valid when its subtree holds a triangle.
    """

    def __init__(self, pair_rows, tri_rows, coh_boxes, inc_boxes, n_leaves: int, depth: int,
                 coh_level: int, inc_level: int):
        self.pair_rows = pair_rows
        self.tri_rows = tri_rows
        self.coh_boxes = coh_boxes
        self.inc_boxes = inc_boxes
        self.n_leaves = n_leaves
        self.depth = depth
        self.coh_level = coh_level
        self.inc_level = inc_level


def pack_cull(tris, coh_level: int = 11, inc_level: int = 8) -> dict:
    """tris [T,3,3] -> the JAX package's tables in numpy: pair_rows,
    tri_rows, coh_boxes, inc_boxes, n_leaves, depth, coh_level, inc_level."""
    bvh = lbvh.build_median_bvh(tris, leaf_size=TRIS_PER_ROW)
    l = int(bvh.n_leaves)
    depth = l.bit_length() - 1
    nodes_min, nodes_max = bvh.nodes_min, bvh.nodes_max

    tid_f = (bvh.tri_id + 1).astype(np.float32)
    # heap validity: a node is valid iff its subtree holds a real triangle
    valid = np.zeros(2 * l, bool)
    valid[l:] = (tid_f.reshape(l, TRIS_PER_ROW) > 0).any(1)
    for lv in range(depth - 1, -1, -1):
        s = 1 << lv
        valid[s:2 * s] = valid[2 * s:4 * s:2] | valid[2 * s + 1:4 * s:2]

    # children-pair records; row 0 = inverted boxes (the self-masking sentinel)
    vcol = valid.astype(np.float32)[:, None]
    rec = np.concatenate([nodes_min, nodes_max, vcol, np.zeros((2 * l, 1), np.float32)],
                         axis=1).astype(np.float32)
    inv_row = np.concatenate([np.full(3, INF), np.full(3, -INF), np.zeros(2)] * 2
                             ).astype(np.float32)
    pair_rows = np.concatenate([inv_row[None], rec[2:].reshape(l - 1, 16)])

    tri_rec = np.concatenate([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, tid_f[:, None]],
                             axis=1).astype(np.float32).reshape(l, ROW_F)
    tri_rows = np.concatenate([tri_rec, np.zeros((1, ROW_F), np.float32)])

    def level_table(lv):
        s = 1 << lv
        return np.ascontiguousarray(np.concatenate(
            [nodes_min[s:2 * s], nodes_max[s:2 * s], vcol[s:2 * s],
             np.zeros((s, 1), np.float32)], axis=1).astype(np.float32).T)  # [8,S]

    coh_level, inc_level = min(coh_level, depth), min(inc_level, depth)
    return dict(pair_rows=pair_rows, tri_rows=tri_rows, coh_boxes=level_table(coh_level),
                inc_boxes=level_table(inc_level), n_leaves=l, depth=depth,
                coh_level=coh_level, inc_level=inc_level)


def build_cull_bvh(tris, coh_level: int = 11, inc_level: int = 8, device=None) -> CullBVH:
    """tris [T,3,3] (numpy, or a tensor whose device is the default) -> the
    tables on `device`: built and packed on the host, uploaded once."""
    if device is None:
        device = tris.device if isinstance(tris, torch.Tensor) else "cpu"
    t = pack_cull(tris, coh_level, inc_level)
    up = {k: torch.from_numpy(t[k]).to(device)
          for k in ("pair_rows", "tri_rows", "coh_boxes", "inc_boxes")}
    return CullBVH(**up, **{k: t[k] for k in ("n_leaves", "depth", "coh_level", "inc_level")})


class _Packets(NamedTuple):
    """Component-separated ray packets ([P,G] a field) and interval bounds."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ivx: torch.Tensor     # safe inverse directions
    ivy: torch.Tensor
    ivz: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    o_lo: torch.Tensor    # [P,3] packet origin box (live rays)
    o_hi: torch.Tensor
    i_lo: torch.Tensor    # [P,3] inverse-direction interval
    i_hi: torch.Tensor
    tmin_lo: torch.Tensor  # [P]


def _make_packets(origins, dirs, tmin, tmax):
    o, d, inv, tmin_p, tmax_p, bounds, n = pad_rays(origins, dirs, tmin, tmax, G)
    return _Packets(o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
                    inv[..., 0], inv[..., 1], inv[..., 2], tmin_p, tmax_p, *bounds), n


def _pieces(p: int, per_packet: int):
    """Packet slices of at most ELEMS_PER_CHUNK elements of per_packet each."""
    step = max(1, ELEMS_PER_CHUNK // max(per_packet, 1))
    return [slice(s, min(p, s + step)) for s in range(0, p, step)]


def _by_pieces(fn, pk: _Packets, per_candidate: int, boxes, t_cap):
    """fn(pk, boxes, t_cap) -> [P,C] over pieces of the packets of at most
    ELEMS_PER_CHUNK elements (per_candidate a packet and candidate),
    concatenated. A static table [8,S] goes whole to every piece."""
    p = pk.ox.shape[0]
    out = [fn(_sub(pk, s), boxes if boxes.dim() == 2 else boxes[s], t_cap[s])
           for s in _pieces(p, per_candidate * boxes.shape[1])]
    return out[0] if len(out) == 1 else torch.cat(out)


def _box_comps(boxes):
    """[8,S] static table or [P,C,8] gathered records -> 7 arrays
    broadcastable against [P,C]: lo xyz, hi xyz, valid."""
    if boxes.dim() == 2:
        return [boxes[i][None] for i in range(7)]
    return [boxes[..., i] for i in range(7)]


def _interval_hits(pk: _Packets, boxes, t_cap):
    """Conservative packet-vs-box tests. boxes [8,S] (static) or [P,C,8]
    (gathered); t_cap [P]. Returns [P,C] bool."""
    c = _box_comps(boxes)
    tn = tf = None
    for ax in range(3):
        lo, hi = c[ax], c[3 + ax]
        o_lo, o_hi = pk.o_lo[:, ax, None], pk.o_hi[:, ax, None]
        i_lo, i_hi = pk.i_lo[:, ax, None], pk.i_hi[:, ax, None]

        def prods(a_lo, a_hi):
            p1 = a_lo * i_lo
            p2 = a_lo * i_hi
            p3 = a_hi * i_lo
            p4 = a_hi * i_hi
            return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                    torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

        lo0, hi0 = prods(lo - o_hi, lo - o_lo)
        lo1, hi1 = prods(hi - o_hi, hi - o_lo)
        tn_ax, tf_ax = torch.minimum(lo0, lo1), torch.maximum(hi0, hi1)
        tn = tn_ax if tn is None else torch.maximum(tn, tn_ax)
        tf = tf_ax if tf is None else torch.minimum(tf, tf_ax)
    return (tn <= tf) & (tf >= pk.tmin_lo[:, None]) & (tn <= t_cap[:, None]) & (c[6] > 0)


def _perray_hits(pk: _Packets, boxes, t_cap_ray):
    """Exact per-ray slab tests, OR-reduced over the packet. boxes [8,S] or
    [P,C,8]; t_cap_ray [P,G] (dead rays carry -inf and never vote).
    Returns [P,C] bool."""
    c = _box_comps(boxes)
    o = (pk.ox, pk.oy, pk.oz)
    iv = (pk.ivx, pk.ivy, pk.ivz)
    tn = torch.tensor(-INF, device=pk.ox.device)
    tf = torch.tensor(INF, device=pk.ox.device)
    for ax in range(3):
        lo, hi = c[ax][:, None], c[3 + ax][:, None]  # [1,1,S] or [P,1,C]
        a = (lo - o[ax][..., None]) * iv[ax][..., None]
        b = (hi - o[ax][..., None]) * iv[ax][..., None]
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    hit = (tn <= tf) & (tf >= pk.tmin[:, :, None]) & (tn <= t_cap_ray[:, :, None])
    return hit.any(1) & (c[6] > 0)


def _perray_union_hits(pk: _Packets, boxes, t_cap_ray):
    return _by_pieces(_perray_hits, pk, G, boxes, t_cap_ray)


def _select(hits, ids, budget: int):
    """Rank-compact hit candidate ids to `budget` slots in heap order.
    hits/ids [P,C]. Unfilled slots get id 0 (the inverted sentinel row,
    which every later test rejects). Returns (ids [P,budget], count [P])."""
    c = hits.shape[1]
    budget = min(budget, c)
    slot = torch.arange(c, device=hits.device)[None]
    key = torch.where(hits, c - slot, -1)
    top = torch.topk(key, budget, dim=1).indices  # ascending slot order
    valid = hits.gather(1, top)
    return torch.where(valid, ids.gather(1, top), 0), hits.sum(1)


def _children(bvh: CullBVH, ids):
    """Frontier ids [P,B] -> (child ids [P,2B], child boxes [P,2B,8])."""
    rec = bvh.pair_rows[ids]  # [P,B,16]
    return torch.cat([2 * ids, 2 * ids + 1], 1), torch.cat([rec[..., 0:8], rec[..., 8:16]], 1)


def _descend(bvh: CullBVH, pk: _Packets, ids, level: int, perray: bool, t_cap, t_cap_ray):
    """Run the frontier from `level` down to the leaf-row level. ids [P,B]
    node ids at `level` (0 = empty slot). Returns (row ids [P,2B], row
    boxes [P,2B,8], row hit mask [P,2B], overflowed [P])."""
    b = ids.shape[1]
    over = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)

    def test(kid_boxes):
        if perray:
            return _perray_union_hits(pk, kid_boxes, t_cap_ray)
        return _by_pieces(_interval_hits, pk, 1, kid_boxes, t_cap)

    for _ in range(bvh.depth - level - 1):
        kid_ids, kid_boxes = _children(bvh, ids)
        ids, count = _select(test(kid_boxes), kid_ids, b)
        over = over | (count > b)
    kid_ids, kid_boxes = _children(bvh, ids)  # children are leaf rows
    return kid_ids, kid_boxes, test(kid_boxes), over


def _mt_chunk(pk: _Packets, fld, best, any_hit: bool):
    """Every ray of the packet against every triangle of the chunk as one
    [P,G,T] tensor reduced over T. fld [10,P,T] triangle components.
    Closest hit carries (t, slot) only: best = (t, slot, slot offset)."""
    f = [fld[i][:, None, :] for i in range(10)]
    rays = [x[..., None] for x in (pk.ox, pk.oy, pk.oz, pk.dx, pk.dy, pk.dz)]
    tt, _, _, ok = _mt_terms(*rays, *f[:9])
    ok = ok & (tt > pk.tmin[..., None]) & (f[9] > 0)
    if any_hit:
        return best | (ok & (tt < pk.tmax[..., None])).any(2)
    t, slot, offset = best
    cand = torch.where(ok, tt, INF)
    ai = cand.argmin(2, keepdim=True)  # the first minimal triangle
    bt = cand.gather(2, ai)[..., 0]
    better = bt < torch.minimum(t, pk.tmax)
    return torch.where(better, bt, t), torch.where(better, ai[..., 0] + offset, slot)


def _mt_finalize(pk: _Packets, pick, t, prev):
    """The winning triangle's u and v recomputed from its fields pick
    [P,G,10]; prev = (t, u, v, prim) from before this _mt_rows call."""
    f = [pick[..., q] for q in range(10)]
    _, uu2, vv2, _ = _mt_terms(pk.ox, pk.oy, pk.oz, pk.dx, pk.dy, pk.dz, *f[:9])
    prim2 = f[9].to(torch.int32) - 1
    pt, pu, pv, pp = prev
    better = t < torch.minimum(pt, pk.tmax)
    return (torch.where(better, t, pt), torch.where(better, uu2, pu),
            torch.where(better, vv2, pv), torch.where(better, prim2, pp))


def _mt_rows_piece(bvh: CullBVH, pk: _Packets, idx, best, any_hit: bool):
    """_mt_rows on one piece of packets; idx [P,steps*MT_CHUNK] row ids
    (the null row L for empty slots)."""
    l = bvh.n_leaves
    p = idx.shape[0]
    steps = idx.shape[1] // MT_CHUNK
    t_c = MT_CHUNK * TRIS_PER_ROW
    if any_hit:
        carry = best
    else:
        carry = (torch.full((p, G), INF, device=idx.device),
                 torch.full((p, G), -1, dtype=torch.long, device=idx.device))
    for w in range(steps):
        rows = bvh.tri_rows[idx[:, w * MT_CHUNK:(w + 1) * MT_CHUNK]]  # [P,MT_CHUNK,80]
        fld = rows.reshape(p, t_c, 10).permute(2, 0, 1)  # [10,P,T]
        carry = _mt_chunk(pk, fld, carry if any_hit else (*carry, w * t_c), any_hit)
    if any_hit:
        return carry
    t, slot = carry
    # slot -> (row slot, triangle j) -> one [P,G] row gather and a field pick
    safe = slot.clamp_min(0)
    rid = idx.gather(1, safe // TRIS_PER_ROW)
    rows = bvh.tri_rows[torch.where(slot >= 0, rid, l)]  # [P,G,80]
    j = (safe % TRIS_PER_ROW)[..., None, None].expand(p, G, 1, 10)
    pick = rows.reshape(p, G, TRIS_PER_ROW, 10).gather(2, j)[:, :, 0]  # [P,G,10]
    return _mt_finalize(pk, pick, t, best)


def _mt_rows(bvh: CullBVH, pk: _Packets, row_ids, best, any_hit: bool):
    """Moller-Trumbore over [P,K] leaf-row heap ids (an id < L marks an
    empty slot: the all-zero null row), MT_CHUNK rows a step. best =
    (t, u, v, prim) each [P,G], or a hit mask [P,G] for any-hit."""
    l = bvh.n_leaves
    p, k = row_ids.shape
    pad = -k % MT_CHUNK
    if pad:
        row_ids = torch.cat([row_ids, row_ids.new_zeros((p, pad))], 1)
    idx = torch.where(row_ids >= l, row_ids - l, l)  # null row for empties
    out = [_mt_rows_piece(bvh, _sub(pk, s), idx[s],
                          best[s] if any_hit else _sub(best, s), any_hit)
           for s in _pieces(p, G * MT_CHUNK * TRIS_PER_ROW)]
    if len(out) == 1:
        return out[0]
    return torch.cat(out) if any_hit else tuple(torch.cat(x) for x in zip(*out))


def _t_cap_ray(pk: _Packets, best, any_hit: bool):
    """Per-ray candidate cap: nothing farther than this can matter."""
    if any_hit:
        return torch.where((pk.tmax >= pk.tmin) & ~best, pk.tmax, -INF)
    return torch.where(pk.tmax >= pk.tmin, torch.minimum(best[0], pk.tmax), -INF)


def _subset(best, idx, any_hit):
    return best[idx] if any_hit else _sub(best, idx)


def _place(best, idx, part, any_hit):
    return best.index_put((idx,), part) if any_hit else _put(best, idx, part)


def _trace_packets(bvh: CullBVH, pk: _Packets, best, any_hit: bool, coherent: bool,
                   budget: int, k_rows: int):
    """One full funnel pass at the given budgets. Returns (best, overflowed [P])."""
    level = bvh.coh_level if coherent else bvh.inc_level
    table = bvh.coh_boxes if coherent else bvh.inc_boxes
    s = table.shape[1]
    p = pk.ox.shape[0]
    dev = pk.ox.device
    t_ray = _t_cap_ray(pk, best, any_hit)
    t_pk = t_ray.amax(1)

    # stage 1: dense level cull against the static table
    ids0 = (torch.arange(s, device=dev) + s)[None].expand(p, s)
    if coherent:
        hits0 = _by_pieces(_interval_hits, pk, 1, table, t_pk)
    else:
        hits0 = _perray_union_hits(pk, table, t_ray)

    if s == bvh.n_leaves:
        # a tiny scene: the start level already is the row level
        row_ids, row_hits = ids0, hits0
        row_boxes = table.T[None].expand(p, s, 8)
        over = torch.zeros(p, dtype=torch.bool, device=dev)
    else:
        ids, count = _select(hits0, ids0, budget)
        row_ids, row_boxes, row_hits, over2 = _descend(
            bvh, pk, ids, level, not coherent, t_pk, t_ray)
        over = (count > budget) | over2

    # stage 3: exact per-ray row refine (incoherent only)
    if not coherent:
        row_hits = row_hits & _perray_union_hits(pk, row_boxes, t_ray)

    # stage 4: MT waves over rank windows of the row candidates
    c = row_hits.shape[1]
    k_rows = min(k_rows, c)
    slot = torch.arange(c, device=dev)[None]
    rank = torch.cumsum(row_hits.long(), 1) - 1
    n_rows = row_hits.sum(1)
    w = 0
    while True:
        # a packet is done once its rows are streamed (any-hit: or every
        # live ray has hit); only the others take part in the wave
        todo = n_rows > w * k_rows
        if any_hit:
            todo = todo & ~(best | (pk.tmax < pk.tmin)).all(1)
        if not bool(todo.any()):
            break
        idx = torch.nonzero(todo)[:, 0]
        sel = row_hits[idx] & (rank[idx] >= w * k_rows) & (rank[idx] < (w + 1) * k_rows)
        top = torch.topk(torch.where(sel, c - slot, -1), k_rows, dim=1).indices
        valid = sel.gather(1, top)
        ids = torch.where(valid, row_ids[idx].gather(1, top), 0)
        part = _mt_rows(bvh, _sub(pk, idx), ids, _subset(best, idx, any_hit), any_hit)
        best = _place(best, idx, part, any_hit)
        w += 1
    return best, over


def _retrace(bvh, pk, best, todo, any_hit, coherent, budget, k_rows):
    """Re-run the funnel at a bigger budget for the flagged packets, each
    exactly once. Returns (best, still overflowed [P])."""
    idx = torch.nonzero(todo)[:, 0]
    if not idx.numel():
        return best, todo
    STATS["retraced"] += idx.numel()
    # the prior best is a valid partial result (a budget-cut row subset);
    # the redo streams every candidate row again, so min/or is idempotent
    new, over = _trace_packets(bvh, _sub(pk, idx), _subset(best, idx, any_hit), any_hit,
                               coherent, budget, k_rows)
    return _place(best, idx, new, any_hit), todo.index_put((idx,), over)


def _rescue_sweep(bvh, pk, best, todo, any_hit, k_rows):
    """The backstop: stream every leaf row, k_rows a wave, for the flagged
    packets (any-hit: until each has every live ray hit)."""
    l = bvh.n_leaves
    idx = torch.nonzero(todo)[:, 0]
    STATS["rescued"] += idx.numel()
    rows = torch.arange(k_rows, device=todo.device)[None]
    for w in range(-(-l // k_rows) if idx.numel() else 0):
        if any_hit:
            idx = idx[~(best[idx] | (pk.tmax[idx] < pk.tmin[idx])).all(1)]
            if not idx.numel():
                break
        ids = (rows + w * k_rows).expand(idx.numel(), k_rows)
        part = _mt_rows(bvh, _sub(pk, idx), torch.where(ids < l, ids + l, 0),
                        _subset(best, idx, any_hit), any_hit)
        best = _place(best, idx, part, any_hit)
    return best


def _trace(bvh: CullBVH, origins, dirs, tmin, tmax, any_hit: bool, coherent: bool,
           budget: int, k_rows: int):
    pk, n = _make_packets(origins, dirs, tmin, tmax)
    p = pk.ox.shape[0]
    dev = pk.ox.device
    if any_hit:
        best = torch.zeros((p, G), dtype=torch.bool, device=dev)
    else:
        zeros = torch.zeros((p, G), dtype=torch.float32, device=dev)
        best = (torch.clamp_max(pk.tmax, INF), zeros, zeros,
                torch.full((p, G), -1, dtype=torch.int32, device=dev))

    best, over = _trace_packets(bvh, pk, best, any_hit, coherent, budget, k_rows)
    best, still = _retrace(bvh, pk, best, over, any_hit, coherent, 4 * budget, 4 * k_rows)
    best = _rescue_sweep(bvh, pk, best, still, any_hit, 4 * k_rows)

    alive = pk.tmax.reshape(-1)[:n] >= pk.tmin.reshape(-1)[:n]
    if any_hit:
        return best.reshape(-1)[:n] & alive
    t, u, v, prim = (x.reshape(-1)[:n] for x in best)
    return {"t": torch.where(prim < 0, INF, t), "u": u, "v": v, "prim": prim}


def cull_closest(bvh: CullBVH, origins, dirs, tmin=0.0, tmax=1e6, coherent=True, budget=None,
                 k_rows=None):
    b, k = (COH_B, COH_K) if coherent else (INC_B, INC_K)
    return _trace(bvh, origins, dirs, tmin, tmax, False, coherent, budget or b, k_rows or k)


def cull_any(bvh: CullBVH, origins, dirs, tmin=1e-4, tmax=1e6, coherent=True, budget=None,
             k_rows=None):
    b, k = (COH_B, COH_K) if coherent else (INC_B, INC_K)
    return _trace(bvh, origins, dirs, tmin, tmax, True, coherent, budget or b, k_rows or k)
