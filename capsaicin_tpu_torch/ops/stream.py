"""Stream traversal for dense scenes (kernels K10, `csrc/stream_trace.cu`,
and K11, `csrc/stream_count.cu`): the torch counterpart of
capsaicin_tpu/ops/stream.py.

Rays go in sub-packets of LANE = 128: sub-packet i is rays
[128 i, 128 i + 128), the last one padded with dead rays. Each sub-packet
takes the interval bounds of its live rays (origin, inverse direction,
tmin, tmax) and tests them against EVERY leaf-block box at once (the cull:
an interval slab test, so no stack walk). The blocks it hits are sorted
nearest first, in (conservative entry distance, block id) order. Each
warp of the sub-packet (32 rays) then streams that list on its own: before
each pop it takes its cap (the largest reach min(t_best, tmax) of its live
rays; for any-hit the largest tmax of its live rays that have no hit yet)
and stops at the first block whose entry lies beyond it. The cap never
rises and the entries never fall, so no later block could be popped
either. Each ray still searching slab-tests the popped block's own box
against its reach, padded by BOX_PAD of the coordinates' magnitude so
that the test is conservative (`_ray_box`), and tests the block's
triangles in slot order only where it passes. A ray thus meets its blocks
in the order of the sub-packet's list and skips only blocks that hold no
hit for it: the results are those of the whole sub-packet popping every
block up to its cap, which is what the TPU kernel does. K11 is the cull
alone: the candidate count of each sub-packet, which `balance_order` sorts
by; on the card a block of 128 threads counts COUNT_GROUP sub-packets
(`count_plan`), reading each box once for all of them.

On the card K10 is a persistent grid (`launch_plan`): as many blocks of
128 threads as are resident, each taking sub-packets from an atomic
counter, in `balance_order` where one is given. Its shared memory is a
fixed SHARED_BYTES, under SHARED_CEILING whatever the scene: a candidate
list longer than TILE keys goes to a scratch in device memory, which the
wrapper allocates (two lists of n_blocks keys a resident block), so
n_blocks is limited by device memory alone.

The structure (`StreamBVH`) is the median BVH of ops.lbvh with leaves of
`block_tris` triangles; leaf b is heap node n_leaves + b, and n_leaves is
a power of two, so many blocks of a scene are empty:
- `boxes` [n_blocks, 8] float32, two float4s a block: (lo xyz, valid),
  (hi xyz, 0). An empty block has the box +3e38 .. -3e38, whose interval
  products give +-inf; only its valid flag (0) keeps it out of the cull.
- `tris` [n_blocks * block_tris, 12] float32, K7's triangle slots in block
  order: (v0 xyz, id), (e1 xyz, 0), (e2 xyz, 0), the id as int32 bits.
  Padding slots are copies of triangle 0 with id -1, at the end of their
  block; only the id test rejects them.

Contracts, as the JAX package's: closest hit returns t = 1e30 on a miss
(as K8, not tmax as K1 and K7) and u = v = 0; any-hit counts a dead ray
(tmax < tmin) as decided, so a warp retires once its live rays have all
hit, and reports it as not hit. tmin is a scalar, tmax a scalar or [N].

The plain versions (`stream_count_plain`, `stream_trace_plain`) compute
the same cull and each warp's pops in the same order, vectorised over
warps, and count K10's work: the blocks each warp pops, the box tests and
the triangle tests. The TPU kernel extracts the next block one step ahead
of its triangle test (its DMA pipeline) and tests every ray of its
sub-packet against every popped block; a block past a ray's reach holds no
hit for it, so the results agree.

Not carried over, since none changes a result: the gang of 8 sub-packets
(TPU sublanes), the `hier` and `near_first` extraction variants, the DMA
semaphores, the 128-lane row packing of boxes and triangles, and the int32
valid mask of the TPU kernel's loop.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels as K
from . import lbvh
from .bvh import pack_tris
from .traverse import _mt_single, _safe_inv

LANE = 128  # rays per sub-packet
WARP = 32  # rays per warp, which streams the sub-packet's list on its own
WARPS = LANE // WARP
BLOCK_TRIS = 32  # triangles per block (the BVH leaf), the JAX package's default
MAX_BLOCK_TRIS = 128  # the most triangles a block that K10 takes
MISS_T = 1e30
BIG = 1e30  # the bound of a sub-packet without live rays
# the per-ray box test's pad, a fraction of the largest coordinate magnitude
# of the box and the ray origin (STREAM_BOX_PAD, csrc/stream_trace.cu)
BOX_PAD = torch.tensor(1e-5, dtype=torch.float32)
# K10's shared memory, whatever n_blocks is (csrc/stream_trace.cu): a tile of
# TILE keys sorted in place, each warp's bounds values and stage of
# STAGE_TRIS triangle slots, two counters (and up to 8 bytes of alignment),
# under the ceiling that keeps 8 blocks of 128 threads on an SM
TILE = 2048
STAGE_TRIS = 32
SHARED_BYTES = TILE * 8 + WARPS * (13 * 4 + STAGE_TRIS * 48) + 16
SHARED_CEILING = 24_576
# K10's candidate lists in device memory: two lists of n_blocks 8-byte keys
# for each resident block, and a counter; the grid shrinks to stay under this
SCRATCH_BUDGET = 1 << 32
PAIRS_PER_CHUNK = 1 << 24  # sub-packets x blocks per cull of the plain versions
# K11: the sub-packets a block of LANE threads counts together (K11_GROUP,
# csrc/stream_count.cu); each thread reads every LANE-th box once for all
# of them
COUNT_GROUP = 8

_RAYS = [K.vp, K.vp, K.f32, K.vp, K.vp]  # origins, dirs, tmin, tmax, boxes
K10 = K.register(K.Kernel(
    "stream_trace", "stream_trace",
    _RAYS + [K.vp, K.vp, K.i32, K.i32, K.i32, K.i32, K.i32, K.vp, K.vp, K.vp, K.vp, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/stream_trace.cu",
    replaces="capsaicin_tpu/ops/stream.py:220",
))
K11 = K.register(K.Kernel(
    "stream_count", "stream_count",
    _RAYS + [K.i32, K.i32, K.i32, K.vp],
    source="capsaicin_tpu_torch/csrc/stream_count.cu",
    replaces="capsaicin_tpu/ops/stream.py:209",
))


class StreamBVH:
    """The blocks' boxes and triangle slots on a device (see the module doc)."""

    def __init__(self, boxes: torch.Tensor, tris: torch.Tensor, n_blocks: int, block_tris: int):
        self.boxes = boxes
        self.tris = tris
        self.n_blocks = n_blocks
        self.block_tris = block_tris


def build_stream_bvh(tris, block_tris: int = BLOCK_TRIS, device=None) -> StreamBVH:
    """tris [T,3,3] (numpy, or a tensor whose device is the default) -> the
    median build with leaves of `block_tris`, packed on `device`."""
    if device is None:
        device = tris.device if isinstance(tris, torch.Tensor) else "cpu"
    host = lbvh.build_median_bvh(tris, leaf_size=block_tris)
    b = host.n_leaves
    lo, hi = host.nodes_min[b:], host.nodes_max[b:]  # leaves: heap nodes [b, 2b)
    boxes = np.zeros((b, 8), np.float32)
    boxes[:, 0:3] = lo
    boxes[:, 3] = lo[:, 0] <= hi[:, 0]
    boxes[:, 4:7] = hi
    return StreamBVH(torch.from_numpy(boxes).to(device),
                     torch.from_numpy(pack_tris(host)).to(device), b, block_tris)


def _sub_packets(origins, dirs, tmin: float, tmax):
    """Rays [N,3] -> sub-packets: origins and directions [P,128,3], tmax
    [P,128] (the padding dead: tmax -inf), tmin a float32 scalar tensor."""
    pad = -origins.shape[0] % LANE
    pad_rows = torch.nn.functional.pad
    return (pad_rows(origins, (0, 0, 0, pad)).reshape(-1, LANE, 3),
            pad_rows(dirs, (0, 0, 0, pad)).reshape(-1, LANE, 3),
            torch.tensor(tmin, dtype=torch.float32, device=origins.device),
            pad_rows(tmax, (0, pad), value=float("-inf")).reshape(-1, LANE))


def _bounds(o, d, tmin, tmax):
    """Each sub-packet's interval bounds over its live rays, as the JAX
    package's _sub_packet_bounds: (o_lo, o_hi, i_lo, i_hi) [P,3] and
    (tmin_lo, tcap0, any_live) [P]."""
    live = tmax >= tmin
    lv = live[..., None]
    inv = _safe_inv(d)
    o_lo = torch.where(lv, o, BIG).amin(1)
    o_hi = torch.where(lv, o, -BIG).amax(1)
    i_lo = torch.where(lv, inv, BIG).amin(1)
    i_hi = torch.where(lv, inv, -BIG).amax(1)
    any_live = live.any(1)
    tmin_lo = torch.where(any_live, tmin, BIG)
    tcap0 = torch.where(live, tmax, -BIG).amax(1)
    return o_lo, o_hi, i_lo, i_hi, tmin_lo, tcap0, any_live


def _interval_products(al, ah, il, ih):
    p1, p2, p3, p4 = al * il, al * ih, ah * il, ah * ih
    return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
            torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))


def _cull(bounds, boxes):
    """Interval slab test of every block box [B,8] against each
    sub-packet's bounds -> (tn conservative entry, hit), both [P,B]."""
    o_lo, o_hi, i_lo, i_hi, tmin_lo, tcap0, any_live = bounds
    tn = tf = None
    for ax in range(3):
        blo, bhi = boxes[:, ax], boxes[:, 4 + ax]
        olo, ohi = o_lo[:, ax, None], o_hi[:, ax, None]
        il, ih = i_lo[:, ax, None], i_hi[:, ax, None]
        l0, h0 = _interval_products(blo - ohi, blo - olo, il, ih)
        l1, h1 = _interval_products(bhi - ohi, bhi - olo, il, ih)
        alo, ahi = torch.minimum(l0, l1), torch.maximum(h0, h1)
        tn = alo if tn is None else torch.maximum(tn, alo)
        tf = ahi if tf is None else torch.minimum(tf, ahi)
    hit = ((tn <= tf) & (tf >= tmin_lo[:, None]) & (tn <= tcap0[:, None])
           & (boxes[:, 3] > 0) & any_live[:, None])
    return tn, hit


def _chunks(p: int, n_blocks: int):
    step = max(1, PAIRS_PER_CHUNK // n_blocks)
    return [slice(s, min(p, s + step)) for s in range(0, p, step)]


def stream_count_plain(sbvh: StreamBVH, origins, dirs, tmin: float, tmax) -> torch.Tensor:
    """The plain version of K11: the candidate blocks of each sub-packet,
    int32 [ceil(N/128)]."""
    o, d, tmin, tm = _sub_packets(origins, dirs, tmin, tmax)
    counts = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    for c in _chunks(o.shape[0], sbvh.n_blocks):
        counts[c] = _cull(_bounds(o[c], d[c], tmin, tm[c]), sbvh.boxes)[1].sum(1, dtype=torch.int32)
    return counts


def _ray_box(o, inv, om, box, tmin, reach):
    """K10's padded slab test of each ray against its warp's popped block
    (csrc/stream_trace.cu:ray_box), operation for operation: o, inv [A,32,3],
    om (the largest |origin| coordinate) and reach [A,32], box [A,8] ->
    [A,32] bool."""
    lo, hi = box[:, None, 0:3], box[:, None, 4:7]
    m = torch.maximum(lo.abs().amax(-1), hi.abs().amax(-1))  # [A,1]
    pad = (BOX_PAD.to(o.device) * (m + om))[..., None]
    t0 = ((lo - pad) - o) * inv
    t1 = ((hi + pad) - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tn <= tf) & (tf >= tmin) & (tn <= reach)


def _stream_chunk(sbvh: StreamBVH, o, d, tmin, tm, any_hit: bool, state, work):
    """Cull the sub-packets of one chunk and stream each of their warps,
    updating `state` (t_best, u, v, prim, each [C,128]) and `work` (blocks
    each warp popped [C,4]; box tests and triangle tests [C]) in place;
    returns the candidate count [C]."""
    streamed, box_tests, tests = work
    c = o.shape[0]
    tn, hit = _cull(_bounds(o, d, tmin, tm), sbvh.boxes)
    # (tn, block id) order: the ids ascend along a row, and the sort is
    # stable; -0.0 becomes +0.0 so every sort takes it as equal to 0
    key = torch.where(hit, tn, float("inf")) + 0.0
    key, order = torch.sort(key, dim=1, stable=True)
    count = hit.sum(1)
    # warp w of sub-packet s is row 4 s + w
    nw = c * WARPS
    sp = torch.arange(nw, device=o.device) // WARPS
    wo, wd = o.reshape(nw, WARP, 3), d.reshape(nw, WARP, 3)
    winv = _safe_inv(wd)
    wom = wo.abs().amax(-1)
    wtm = tm.reshape(nw, WARP)
    wlive = wtm >= tmin
    t_best, bu, bv, prim = (x.view(nw, WARP) for x in state)
    w_streamed = torch.zeros(nw, dtype=torch.int64, device=o.device)
    w_box = torch.zeros_like(w_streamed)
    w_tests = torch.zeros_like(w_streamed)
    tri_id = sbvh.tris.view(torch.int32)[:, 3]
    slot = torch.arange(sbvh.block_tris, device=o.device)
    act = torch.arange(nw, device=o.device)
    for k in range(int(count.max()) if count.numel() else 0):
        # the warp's cap: the largest reach of its rays (a dead any-hit ray
        # has prim 0, so prim < 0 only on live ones)
        if any_hit:
            cap = torch.where(prim[act] < 0, wtm[act], -BIG).amax(1)
        else:
            cap = torch.where(wlive[act], t_best[act], -BIG).amax(1)
        act = act[(k < count[sp[act]]) & (key[sp[act], k] <= cap)]
        if not act.numel():
            break
        w_streamed[act] += 1
        blk = order[sp[act], k]
        lanes = prim[act] < 0 if any_hit else wlive[act]  # the rays still searching
        w_box[act] += lanes.sum(1)
        reach = wtm[act] if any_hit else t_best[act]
        go = lanes & _ray_box(wo[act], winv[act], wom[act], sbvh.boxes[blk], tmin, reach)
        tested = go.any(1)
        rows, blk, go = act[tested], blk[tested], go[tested]
        if not rows.numel():
            continue
        slots = blk[:, None] * sbvh.block_tris + slot  # [R, block_tris]
        tri = sbvh.tris[slots][:, None]  # [R, 1, block_tris, 12]
        tid = tri_id[slots][:, None]
        real = tid >= 0  # padding is at the end of a block
        best = t_best[rows]
        tt, uu, vv, ok = _mt_single(wo[rows][:, :, None], wd[rows][:, :, None], tri[..., 0:3],
                                    tri[..., 4:7], tri[..., 8:11], tmin, best[..., None])
        ok &= real & go[..., None]
        if any_hit:
            j = ok.to(torch.uint8).argmax(2, keepdim=True)  # the first hit in slot order
            found = ok.any(2)
            # a ray tests the slots up to its first hit
            done = torch.where(found, j[..., 0] + 1, real.sum(2))
            w_tests[rows] += torch.where(go, done, 0).sum(1)
        else:
            tt = torch.where(ok, tt, float("inf"))
            j = tt.argmin(2, keepdim=True)  # the first of the nearest, as slot order keeps
            found = tt.gather(2, j)[..., 0] < best
            w_tests[rows] += go.sum(1) * real[:, 0].sum(1)
        pick = lambda x: x.gather(2, j)[..., 0]  # noqa: E731
        t_best[rows] = torch.where(found, pick(tt), best)
        bu[rows] = torch.where(found, pick(uu), bu[rows])
        bv[rows] = torch.where(found, pick(vv), bv[rows])
        prim[rows] = torch.where(found, pick(tid.expand_as(tt)), prim[rows])
    streamed += w_streamed.view(c, WARPS)
    box_tests += w_box.view(c, WARPS).sum(1)
    tests += w_tests.view(c, WARPS).sum(1)
    return count


def stream_trace_plain(sbvh: StreamBVH, origins, dirs, tmin: float, tmax, any_hit: bool):
    """The plain version of K10. Returns {"t","u","v","prim"} (closest) or
    {"hit"} (any-hit), with K10's work: "candidates" (the cull's count)
    [ceil(N/128)], "streamed" (the blocks each warp popped) [ceil(N/128), 4],
    "box_tests" (a ray still searching against a popped block's box) and
    "tests" (a ray against a real triangle of a popped block whose box it
    passed; for any-hit up to its first hit) [ceil(N/128)], all int64."""
    n = origins.shape[0]
    o, d, tmin, tm = _sub_packets(origins, dirs, tmin, tmax)
    p = o.shape[0]
    live = tm >= tmin
    t_best = tm.clone()
    bu = torch.zeros_like(tm)
    bv = torch.zeros_like(tm)
    prim = torch.full_like(tm, -1, dtype=torch.int32)
    if any_hit:  # a dead ray counts as decided, so its warp can retire
        prim[~live] = 0
    candidates = torch.zeros(p, dtype=torch.int64, device=o.device)
    streamed = torch.zeros((p, WARPS), dtype=torch.int64, device=o.device)
    box_tests = torch.zeros_like(candidates)
    tests = torch.zeros_like(candidates)
    for c in _chunks(p, sbvh.n_blocks):  # slices: the chunk's state is a view
        candidates[c] = _stream_chunk(sbvh, o[c], d[c], tmin, tm[c], any_hit,
                                      (t_best[c], bu[c], bv[c], prim[c]),
                                      (streamed[c], box_tests[c], tests[c]))
    prim = prim.reshape(-1)[:n]
    work = {"candidates": candidates, "streamed": streamed, "box_tests": box_tests,
            "tests": tests}
    if any_hit:
        return {"hit": (prim >= 0) & live.reshape(-1)[:n], **work}
    t = torch.where(prim < 0, MISS_T, t_best.reshape(-1)[:n])
    return {"t": t, "u": bu.reshape(-1)[:n], "v": bv.reshape(-1)[:n], "prim": prim, **work}


def _tmax(tmax, n: int, device) -> torch.Tensor:
    if isinstance(tmax, torch.Tensor):
        return tmax.to(torch.float32).expand(n).contiguous()
    return torch.full((n,), float(tmax), dtype=torch.float32, device=device)


def _check(sbvh: StreamBVH, origins, dirs, tmax):
    """Raise unless the rays and the structure are what the kernels take."""
    n, dev = origins.shape[0], origins.device
    for name, x, shape in (("origins", origins, (n, 3)), ("dirs", dirs, (n, 3)),
                           ("tmax", tmax, (n,)), ("boxes", sbvh.boxes, (sbvh.n_blocks, 8)),
                           ("tris", sbvh.tris, (sbvh.n_blocks * sbvh.block_tris, 12))):
        K.check_cuda(x, name, torch.float32, shape, dev, align=16 if name in ("boxes", "tris") else 1)
    if sbvh.n_blocks < 1:
        raise ValueError(f"n_blocks {sbvh.n_blocks} < 1")
    if not 1 <= sbvh.block_tris <= MAX_BLOCK_TRIS:
        raise ValueError(f"block_tris {sbvh.block_tris} outside 1..{MAX_BLOCK_TRIS}")


def launch_plan(n_blocks: int, block_tris: int, n_rays: int, resident: int) -> dict:
    """K10's launch, from host ints only (no sync in a frame): "grid" (the
    resident blocks, at most one a sub-packet, fewer where the scratch
    would pass SCRATCH_BUDGET), "shared_bytes" (fixed: the tile, the
    reduction, the counters) and "scratch_bytes" (two lists of n_blocks
    8-byte keys a block of the grid, and the 8-byte sub-packet counter)."""
    if n_blocks < 1 or not 1 <= block_tris <= MAX_BLOCK_TRIS or resident < 1:
        raise ValueError(f"no K10 launch for {n_blocks} blocks of {block_tris} triangles on "
                         f"{resident} resident blocks")
    per_block = 2 * n_blocks * 8
    grid = max(1, min(resident, -(-n_rays // LANE), SCRATCH_BUDGET // per_block))
    return {"grid": grid, "shared_bytes": SHARED_BYTES, "scratch_bytes": grid * per_block + 8}


def count_plan(n_rays: int) -> int:
    """K11's grid, from host ints only: one block of LANE threads for each
    COUNT_GROUP sub-packets of the ceil(n_rays / LANE)."""
    return -(-(-(-n_rays // LANE)) // COUNT_GROUP)


@functools.lru_cache(maxsize=None)
def count_kernel_info(device_index: int) -> dict:
    """K11's build on a card, from cudaFuncGetAttributes and the occupancy
    API: registers a thread, spilled bytes a thread, static shared bytes,
    resident blocks of 128 threads (and warps) an SM, and the SMs."""
    out = (ctypes.c_int * 5)()
    err = K.call("stream_count_info", [ctypes.POINTER(ctypes.c_int), K.i32], out, device_index)
    if err != 0:
        raise RuntimeError(f"stream_count_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "ctas_per_sm", "sms"), out))
    info["warps_per_sm"] = info["ctas_per_sm"] * WARPS
    return info


@functools.lru_cache(maxsize=None)
def kernel_info(device_index: int, any_hit: bool) -> dict:
    """K10's build on a card, from cudaFuncGetAttributes and the occupancy
    API: registers a thread, static shared bytes, spilled bytes a thread,
    resident blocks of 128 threads an SM, and the SMs."""
    out = (ctypes.c_int * 5)()
    err = K.call("stream_trace_info", [K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                 int(any_hit), out, device_index)
    if err != 0:
        raise RuntimeError(f"stream_trace_info: CUDA error {err}")
    return dict(zip(("registers", "shared_bytes", "local_bytes", "ctas_per_sm", "sms"), out))


def count_candidates(sbvh: StreamBVH, origins, dirs, tmin: float, tmax) -> torch.Tensor:
    """K11 on CUDA tensors, its plain version on CPU tensors: int32
    [ceil(N/128)], the candidate blocks of each sub-packet."""
    n = origins.shape[0]
    tmax = _tmax(tmax, n, origins.device)
    if K.on_cpu(origins):
        return stream_count_plain(sbvh, origins, dirs, tmin, tmax)
    origins, dirs = origins.contiguous(), dirs.contiguous()
    _check(sbvh, origins, dirs, tmax)
    counts = torch.empty(-(-n // LANE), dtype=torch.int32, device=origins.device)
    K11.launch(origins.device, K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax),
               K.ptr(sbvh.boxes), n, sbvh.n_blocks, count_plan(n), K.ptr(counts))
    return counts


def stream_trace(sbvh: StreamBVH, origins, dirs, tmin: float, tmax, any_hit: bool, order=None):
    """K10 on CUDA tensors, its plain version on CPU tensors. Returns
    (t, u, v, prim) for closest hit (t = 1e30 on a miss), or the bool hit
    mask for any-hit. `order` (int32 [ceil(N/128)], a permutation of the
    sub-packets, as `balance_order` gives) is the order in which the card
    starts them; it changes no result, so the plain version takes none."""
    n = origins.shape[0]
    tmax = _tmax(tmax, n, origins.device)
    if K.on_cpu(origins):
        out = stream_trace_plain(sbvh, origins, dirs, tmin, tmax, any_hit)
        return out["hit"] if any_hit else (out["t"], out["u"], out["v"], out["prim"])
    dev = origins.device
    origins, dirs = origins.contiguous(), dirs.contiguous()
    _check(sbvh, origins, dirs, tmax)
    if order is not None:
        K.check_cuda(order, "order", torch.int32, (-(-n // LANE),), dev)
    info = kernel_info(dev.index or 0, any_hit)
    plan = launch_plan(sbvh.n_blocks, sbvh.block_tris, n, info["ctas_per_sm"] * info["sms"])
    scratch = torch.empty(plan["scratch_bytes"] // 8, dtype=torch.int64, device=dev)
    args = (K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax), K.ptr(sbvh.boxes),
            K.ptr(sbvh.tris), None if order is None else K.ptr(order), n, sbvh.n_blocks,
            sbvh.block_tris, int(any_hit), plan["grid"], K.ptr(scratch))
    if any_hit:
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        K10.launch(dev, *args, None, None, None, None, K.ptr(hit))
        return hit
    t = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    K10.launch(dev, *args, K.ptr(t), K.ptr(u), K.ptr(v), K.ptr(prim), None)
    return t, u, v, prim


def balance_order(counts: torch.Tensor) -> torch.Tensor:
    """The sub-packets by descending candidate count, ties in index order
    (the JAX package's _balance permutation), int32. K10 takes them in this
    order, so the longest start first."""
    return torch.argsort(-counts.long(), stable=True).to(torch.int32)


def stream_closest(sbvh: StreamBVH, origins, dirs, tmin: float = 0.0, tmax=1e6,
                   balance: bool = False):
    """Closest-hit query. With `balance` K11 counts each sub-packet's
    candidates first and K10 starts the sub-packets in descending order of
    that count; the results are the same."""
    order = None
    if balance:
        tmax = _tmax(tmax, origins.shape[0], origins.device)
        order = balance_order(count_candidates(sbvh, origins, dirs, tmin, tmax))
    t, u, v, prim = stream_trace(sbvh, origins, dirs, tmin, tmax, any_hit=False, order=order)
    return {"t": t, "u": u, "v": v, "prim": prim}


def stream_any(sbvh: StreamBVH, origins, dirs, tmin: float = 1e-4, tmax=1e6):
    """Any-hit (shadow) query: True where a triangle is hit in (tmin, tmax)."""
    return stream_trace(sbvh, origins, dirs, tmin, tmax, any_hit=True)
