"""Wavefront leaf-streaming traversal: the torch counterpart of
capsaicin_tpu/ops/wavefront.py (traversal="wavefront").

Rays go in packets of LANE = 128 (the last padded with dead rays). Each
packet walks the BVH of leaves of 8 triangles (one "row" a leaf) with an
ordered near-first stack walk, testing its conservative interval bounds
(origin box x inverse-direction interval, so mixed-octant packets stay
correct) against each sibling pair. Two phases a stage:

  Phase A (`phase_a`): every packet advances its walk by one pair a step,
    all packets at once, emitting the leaf rows it hits, near first, until
    it has emitted k_rows - 1 rows or its walk is over.
  Phase B (`phase_b`): the listed rows' triangles against every ray of the
    packet, CHUNK rows (32 triangles) a step. The JAX package updates the
    running best triangle by triangle; here a step is one [P,128,32]
    tensor reduced with argmin, which takes the first minimal triangle, as
    the sequential strict `t < min(t_best, tmax)` update does, so the
    results are the same bit for bit (tests/test_torch_wavefront.py).

Stage 1 runs every packet with a budget of K_STAGE1 rows; then compacted
continuation stages of K_STAGE2 rows take the packets whose walk is not
over, until every walk is over (or, for any-hit, every live ray of the
packet has hit). The JAX package's lax.while_loops are Python loops here,
each reading its stop rule on the host. A walk step is some 70 small
launches, so on CUDA phase A records STEPS_PER_GRAPH steps as a CUDA graph
and replays it, reading the stop rule once a replay: a step of a packet
that has stopped changes nothing. Eager PyTorch changes three more things,
none of which changes a result, since each packet's stages depend on that
packet alone: a continuation stage takes every packet still going (the JAX
package, bound to static shapes, takes the first P/8 of them a stage, in a
stable order, and so may need several stages a round); phase B skips the
packets whose list has no row in a step (a null row hits nothing); and it
takes as many rows a step as keep the step within ELEMS_PER_CHUNK
ray-triangle pairs, in pieces of packets where CHUNK rows do not fit,
which bounds the temporaries at 1080p and makes few launches for a small
batch.

The tables are the JAX package's (`WavefrontBVH`), packed on the host in
numpy from ops.lbvh.build_median_bvh at leaf size 8 and uploaded once.
Contracts: closest hit returns t = 1e30 on a miss, u = v = 0 and prim -1;
any-hit reports a dead ray (tmax < tmin) as not hit. tmin and tmax are
scalars or [N].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lbvh
from .traverse import _safe_inv

LANE = 128          # rays per packet
TRIS_PER_ROW = 8    # one leaf = one row of 8 triangles
ROW_F = 80          # 8 tris x 10 floats (v0 xyz, e1 xyz, e2 xyz, tid+1)
STACK_DEPTH = 28    # >= max tree depth
K_STAGE1 = 192      # leaf-row budget, stage 1
K_STAGE2 = 256      # budget per compacted stage
CHUNK = 4           # rows per phase-B step (32 tris)
INF = 1e30
ELEMS_PER_CHUNK = 1 << 24  # ray-triangle pairs of one phase-B piece
STEPS_PER_GRAPH = 16  # walk steps a CUDA graph replays between reads of the stop rule


class WavefrontBVH:
    """The walk's tables on a device:

    pair_rows: [L, 16] float32 - row k holds the records of children
               (2k, 2k+1): (min xyz, max xyz, split code, valid) x 2; row 0
               unused. The split code (slot 6 of the left record) is
               axis + 4 * left_is_low; valid (slot 7) is 0 for the padding
               subtrees, whose inverted boxes would pass every interval test.
    tri_rows:  [L + 1, 80] float32 - row l = the 8 triangles of leaf L + l,
               triangle j at floats 10 j .. 10 j + 10 as (v0, e1, e2, id + 1),
               id + 1 = 0 marking padding; the last row is all zero (the
               target of empty list slots).
    """

    def __init__(self, pair_rows: torch.Tensor, tri_rows: torch.Tensor, n_leaves: int):
        self.pair_rows = pair_rows
        self.tri_rows = tri_rows
        self.n_leaves = n_leaves


def pack_wavefront(tris):
    """tris [T,3,3] -> (pair_rows, tri_rows, n_leaves) in numpy, the JAX
    package's packing of the median build at leaf size 8."""
    bvh = lbvh.build_median_bvh(tris, leaf_size=TRIS_PER_ROW)
    l = bvh.n_leaves
    nodes_min, nodes_max = bvh.nodes_min, bvh.nodes_max

    centers = (nodes_min + nodes_max) * 0.5
    diff = centers[3::2] - centers[2::2]
    axis = np.argmax(np.abs(diff), axis=1)
    low = np.take_along_axis(diff, axis[:, None], axis=1)[:, 0] >= 0
    code = (axis + 4 * low.astype(np.int32)).astype(np.float32)
    codes = np.zeros((2 * l,), np.float32)
    codes[2::2] = code
    valid = (nodes_min[:, 0] <= nodes_max[:, 0]).astype(np.float32)
    rec = np.concatenate([nodes_min, nodes_max, codes[:, None], valid[:, None]],
                         axis=1).astype(np.float32)  # [2L, 8]
    pair_rows = np.concatenate([np.zeros((1, 16), np.float32), rec[2:].reshape(l - 1, 16)])

    tid_f = (bvh.tri_id + 1).astype(np.float32)
    tri_rec = np.concatenate([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, tid_f[:, None]],
                             axis=1).astype(np.float32).reshape(l, ROW_F)
    tri_rows = np.concatenate([tri_rec, np.zeros((1, ROW_F), np.float32)])
    return pair_rows, tri_rows, l


def build_wavefront_bvh(tris, device=None) -> WavefrontBVH:
    """tris [T,3,3] (numpy, or a tensor whose device is the default) -> the
    tables on `device`: built and packed on the host, uploaded once."""
    if device is None:
        device = tris.device if isinstance(tris, torch.Tensor) else "cpu"
    pair_rows, tri_rows, l = pack_wavefront(tris)
    return WavefrontBVH(torch.from_numpy(pair_rows).to(device),
                        torch.from_numpy(tri_rows).to(device), l)


class _Packets(NamedTuple):
    """Per-packet rays [P, LANE] and conservative interval bounds."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    o_lo: torch.Tensor  # [P, 3] packet origin box
    o_hi: torch.Tensor
    i_lo: torch.Tensor  # [P, 3] inverse-direction interval
    i_hi: torch.Tensor
    sd_pos: torch.Tensor  # [P, 3] bool: the first ray's direction signs
    tmin_lo: torch.Tensor  # [P]


class _WalkState(NamedTuple):
    k: torch.Tensor      # [P] int64 current pair (an internal node); 0 = over
    sp: torch.Tensor     # [P] int64 stack pointer
    stack: torch.Tensor  # [P, STACK_DEPTH] int64
    done: torch.Tensor   # [P] bool


def _tree(like, parts):
    return type(like)(*parts) if hasattr(like, "_fields") else tuple(parts)


def _sub(tree, idx):
    """The packets idx of a tuple of [P, ...] tensors."""
    return _tree(tree, [x[idx] for x in tree])


def _put(tree, idx, part):
    """`tree` with its packets idx replaced by `part` (out of place)."""
    return _tree(tree, [x.index_put((idx,), s) for x, s in zip(tree, part)])


def _per_ray(x, n, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n)


def pad_rays(origins, dirs, tmin, tmax, lane: int):
    """Rays [N,3] (tmin, tmax scalars or [N]) -> packets of `lane`, the last
    padded with dead rays (tmin 1, tmax -1: they accept and bound nothing):
    (o, d, inv [P,lane,3], tmin, tmax [P,lane], bounds, N). bounds: the live
    rays' origin box and inverse-direction interval (o_lo, o_hi, i_lo, i_hi
    [P,3]) and least tmin [P]; a packet without a live ray gets inverted
    bounds, so that every test misses."""
    n = origins.shape[0]
    dev = origins.device
    p = -(-n // lane)
    pad = p * lane - n

    def padded(x, fill):
        if pad:
            x = torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])
        return x.reshape((p, lane) + x.shape[1:])

    o = padded(origins.float(), 0.0)
    d = padded(dirs.float(), 1.0)
    tmin_p = padded(_per_ray(tmin, n, dev), 1.0)
    tmax_p = padded(_per_ray(tmax, n, dev), -1.0)
    inv = _safe_inv(d)
    live = (tmax_p >= tmin_p)[..., None]
    bounds = (torch.where(live, o, INF).amin(1), torch.where(live, o, -INF).amax(1),
              torch.where(live, inv, INF).amin(1), torch.where(live, inv, -INF).amax(1),
              torch.where(live[..., 0], tmin_p, INF).amin(1))
    return o, d, inv, tmin_p, tmax_p, bounds, n


def _make_packets(origins, dirs, tmin, tmax):
    o, d, _, tmin_p, tmax_p, (o_lo, o_hi, i_lo, i_hi, tmin_lo), n = pad_rays(
        origins, dirs, tmin, tmax, LANE)
    return _Packets(o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2], tmin_p,
                    tmax_p, o_lo, o_hi, i_lo, i_hi, d[:, 0, :] > 0, tmin_lo), n


def _interval_hits(pk: _Packets, b_lo, b_hi, t_cap):
    """Conservative packet-vs-box slab tests of both children at once,
    b_lo/b_hi [P, 2, 3], t_cap [P]: [P, 2], true where any live ray of the
    packet could enter the box before t_cap."""
    o_lo, o_hi = pk.o_lo[:, None], pk.o_hi[:, None]
    i_lo, i_hi = pk.i_lo[:, None], pk.i_hi[:, None]

    def prods(a_lo, a_hi):
        p1 = a_lo * i_lo
        p2 = a_lo * i_hi
        p3 = a_hi * i_lo
        p4 = a_hi * i_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    lo0, hi0 = prods(b_lo - o_hi, b_lo - o_lo)
    lo1, hi1 = prods(b_hi - o_hi, b_hi - o_lo)
    t_near_lo = torch.minimum(lo0, lo1).amax(2)
    t_far_hi = torch.maximum(hi0, hi1).amin(2)
    return ((t_near_lo <= t_far_hi) & (t_far_hi >= pk.tmin_lo[:, None])
            & (t_near_lo <= t_cap[:, None]))


def walk_init(pk: _Packets) -> _WalkState:
    p = pk.ox.shape[0]
    dev = pk.ox.device
    no_live = (pk.tmax < pk.tmin).all(1)
    return _WalkState(
        k=(~no_live).long(),
        sp=torch.zeros(p, dtype=torch.long, device=dev),
        stack=torch.zeros((p, STACK_DEPTH), dtype=torch.long, device=dev),
        done=no_live,
    )


def _walk_step(bvh: WavefrontBVH, pk: _Packets, t_cap, k_rows: int, walk):
    """One step of every packet's walk, in place on walk = [k, sp, stack,
    done, emit, lists]: a packet that is active (its walk not over, fewer
    than k_rows - 1 rows emitted) tests the children of its pair, emits
    the leaf rows it hits, near first, and descends, pushes or pops. An
    inactive packet is left as it is, so a step past the stop rule changes
    nothing."""
    k, sp, stack, done, emit, lists = walk
    l = bvh.n_leaves
    p = k.shape[0]
    active = ~done & (emit <= k_rows - 2)
    rec = bvh.pair_rows[k].view(p, 2, 8)  # left and right child records
    hits = _interval_hits(pk, rec[..., 0:3], rec[..., 3:6], t_cap) & (rec[..., 7] > 0)
    c0 = 2 * k
    inner = c0 < l  # the children are internal nodes, not leaves

    code = rec[:, 0, 6].long()
    left_low = code >= 4
    # near child first: the left one where the first ray's direction sign
    # on the split axis says its side is the low one
    near_left = pk.sd_pos.gather(1, (code & 3)[:, None])[:, 0] == left_low
    far_right = near_left.long()
    any_n = hits.gather(1, 1 - far_right[:, None])[:, 0]
    any_f = hits.gather(1, far_right[:, None])[:, 0]
    near = c0 + 1 - far_right
    far = c0 + far_right

    # leaf emissions, near first
    e0 = ~inner & any_n & active
    e1 = ~inner & any_f & active
    at_far = emit + e0.long()
    slots = torch.arange(k_rows, device=k.device)[None]
    lists.copy_(torch.where((slots == emit[:, None]) & e0[:, None], (near - l)[:, None],
                            torch.where((slots == at_far[:, None]) & e1[:, None],
                                        (far - l)[:, None], lists)))
    emit.copy_(at_far + e1.long())

    # descend / push / pop
    push = inner & any_n & any_f & active
    depth = torch.arange(STACK_DEPTH, device=k.device)[None]
    stack.copy_(torch.where((depth == sp[:, None]) & push[:, None], far[:, None], stack))
    sp1 = sp + push.long()
    desc = torch.where(inner & any_n, near, torch.where(inner & any_f, far, 0))
    need_pop = desc == 0
    spm = torch.clamp_min(sp1 - 1, 0)
    popped = torch.where(sp1 > 0, stack.gather(1, spm[:, None])[:, 0], 0)
    k.copy_(torch.where(active, torch.where(need_pop, popped, desc), k))
    sp.copy_(torch.where(active, torch.where(need_pop, spm, sp1), sp))
    done.copy_(done | (k == 0))


def _replay_steps(step, going):
    """Run step() while going() holds, on CUDA: one step on a side stream,
    then STEPS_PER_GRAPH steps captured as a CUDA graph, replayed while
    going() holds (the stop rule read on the host once a replay). The
    graph launches the same kernels on the same tensors as the eager
    steps; the steps past the stop rule change nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    if not going():
        return
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(STEPS_PER_GRAPH):
            step()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    while going():
        graph.replay()


def phase_a(bvh: WavefrontBVH, pk: _Packets, state: _WalkState, t_cap, k_rows: int):
    """Advance every packet's ordered stack walk until it has emitted
    k_rows - 1 leaf rows or its walk is over. Returns (lists [P, k_rows]
    int64 leaf-row ids, -1 padded, near first; the new state)."""
    p = state.k.shape[0]
    dev = state.k.device
    walk = [x.clone() for x in state[:4]] + [
        torch.zeros(p, dtype=torch.long, device=dev),
        torch.full((p, k_rows), -1, dtype=torch.long, device=dev)]

    def going():
        return bool((~walk[3] & (walk[4] <= k_rows - 2)).any())

    def step():
        _walk_step(bvh, pk, t_cap, k_rows, walk)

    if dev.type == "cuda" and going():
        _replay_steps(step, going)
    while going():
        step()
    return walk[5], _WalkState(*walk[:4])


def _mt_terms(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Moller-Trumbore on broadcastable components, each dot product
    written left to right as the JAX package writes it: (tt, uu, vv, the
    test of det, u and v)."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = det.abs() > 1e-12
    inv_det = torch.where(big, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return tt, uu, vv, big & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)


def mt_step(best, pk: _Packets, tri, any_hit: bool):
    """One phase-B step: the triangles tri [P, T, 10] (v0, e1, e2, id + 1)
    against the packet's rays [P, LANE]; best = (t, u, v, prim) [P, LANE].
    Equal to updating best triangle by triangle with the strict test
    tt < min(t, tmax) (closest) or tt < tmax (any-hit)."""
    t, u, v, prim = best
    f = [tri[:, None, :, q] for q in range(10)]  # [P, 1, T]
    rays = [x[..., None] for x in (pk.ox, pk.oy, pk.oz, pk.dx, pk.dy, pk.dz)]
    tt, uu, vv, ok = _mt_terms(*rays, *f[:9])
    tid = f[9] - 1.0
    ok = ok & (tt > pk.tmin[..., None]) & (tid >= 0)
    if any_hit:
        hit = (ok & (tt < pk.tmax[..., None])).any(2)
        return t, u, v, torch.where(hit, torch.ones_like(prim), prim)
    cand = torch.where(ok, tt, float("inf"))
    j = cand.argmin(2, keepdim=True)  # the first minimal triangle
    bt = cand.gather(2, j)[..., 0]
    better = bt < torch.minimum(t, pk.tmax)
    return (torch.where(better, bt, t),
            torch.where(better, uu.gather(2, j)[..., 0], u),
            torch.where(better, vv.gather(2, j)[..., 0], v),
            torch.where(better, tid.expand_as(cand).gather(2, j)[..., 0].to(torch.int32), prim))


def phase_b(bvh: WavefrontBVH, pk: _Packets, lists, best, any_hit: bool):
    """Test the listed rows' triangles, near first, at least CHUNK rows a
    step. A step takes only the packets with a row in it (the rows of a
    list are a prefix) and as many rows as keep it within ELEMS_PER_CHUNK
    ray-triangle pairs (in pieces of packets where CHUNK rows do not):
    argmin over a step's triangles in list order takes the first minimal
    one, so steps of any length give the same bits."""
    l = bvh.n_leaves
    k_rows = lists.shape[1]
    rows_of = (lists >= 0).sum(1)
    n_rows = int(rows_of.max()) if rows_of.numel() else 0
    pairs = LANE * CHUNK * TRIS_PER_ROW  # a packet's pairs in CHUNK rows
    start = 0
    while start < n_rows:
        todo = torch.nonzero(rows_of > start)[:, 0]
        grow = max(1, ELEMS_PER_CHUNK // (todo.numel() * pairs))
        stop = min(start + CHUNK * grow, k_rows)
        piece = max(1, ELEMS_PER_CHUNK // pairs)
        for i in range(0, todo.numel(), piece):
            idx = todo[i:i + piece]
            rows = lists[idx, start:stop]
            tri = bvh.tri_rows[torch.where(rows < 0, l, rows)]  # [A, R, 80]
            part = mt_step(_sub(best, idx), _sub(pk, idx), tri.reshape(len(idx), -1, 10), any_hit)
            best = _put(best, idx, part)
        start = stop
    return best


def _closest_t_cap(pk: _Packets, t):
    """Per-packet pruning cap: no node entered beyond every live ray's
    current best can improve anything."""
    live = pk.tmax >= pk.tmin
    return torch.where(live, torch.minimum(t, pk.tmax), -INF).amax(1)


def _any_t_cap(pk: _Packets, hit):
    live = (pk.tmax >= pk.tmin) & (hit == 0)
    return torch.where(live, pk.tmax, -INF).amax(1)


# The fallback work of the traces since the caller last zeroed it: the
# packets that went on past stage 1 and the continuation stages run
STATS = {"continued": 0, "stages": 0}


def _trace(bvh: WavefrontBVH, origins, dirs, tmin, tmax, any_hit: bool):
    pk, n = _make_packets(origins, dirs, tmin, tmax)
    p = pk.ox.shape[0]
    dev = pk.ox.device
    zeros = torch.zeros((p, LANE), dtype=torch.float32, device=dev)
    if any_hit:
        best = (zeros, zeros, zeros, torch.zeros((p, LANE), dtype=torch.int32, device=dev))
    else:
        best = (torch.clamp_max(pk.tmax, INF), zeros, zeros,
                torch.full((p, LANE), -1, dtype=torch.int32, device=dev))

    def cap(pk, best):
        return _any_t_cap(pk, best[3]) if any_hit else _closest_t_cap(pk, best[0])

    def stage_done(state, best):
        if any_hit:
            # packets whose every live ray has hit need no more rows
            return state.done | ((best[3] > 0) | (pk.tmax < pk.tmin)).all(1)
        return state.done

    state = walk_init(pk)
    lists, state = phase_a(bvh, pk, state, cap(pk, best), K_STAGE1)
    best = phase_b(bvh, pk, lists, best, any_hit)

    # compacted continuation stages for the footprint's tail
    first = True
    while True:
        idx = torch.nonzero(~stage_done(state, best))[:, 0]
        if not idx.numel():
            break
        if first:
            STATS["continued"] += idx.numel()
            first = False
        STATS["stages"] += 1
        pk_s, st_s, best_s = _sub(pk, idx), _sub(state, idx), _sub(best, idx)
        lists, st_s = phase_a(bvh, pk_s, st_s, cap(pk_s, best_s), K_STAGE2)
        best_s = phase_b(bvh, pk_s, lists, best_s, any_hit)
        state, best = _put(state, idx, st_s), _put(best, idx, best_s)

    t, u, v, prim = (x.reshape(-1)[:n] for x in best)
    if any_hit:
        return (prim > 0) & (pk.tmax.reshape(-1)[:n] >= pk.tmin.reshape(-1)[:n])
    return {"t": torch.where(prim < 0, INF, t), "u": u, "v": v, "prim": prim}


def wavefront_closest(bvh: WavefrontBVH, origins, dirs, tmin=0.0, tmax=1e6):
    return _trace(bvh, origins, dirs, tmin, tmax, any_hit=False)


def wavefront_any(bvh: WavefrontBVH, origins, dirs, tmin=1e-4, tmax=1e6):
    return _trace(bvh, origins, dirs, tmin, tmax, any_hit=True)
