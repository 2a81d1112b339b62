"""BVH traversal on the card (kernel K7, `csrc/bvh_trace.cu`): the torch
counterpart of capsaicin_tpu/ops/pallas_traverse.py.

The tree is ops.lbvh's median build (a complete binary heap over the
leaves, every leaf at depth D), packed for the card:
- `pack_wide_nodes` [n_wide, 32] float32, one 128-byte record per binary
  node at even depth 0, 2, ... < D (level by level, heap order within a
  level), holding its four grandchildren; a node at depth D - 1 (D odd)
  holds its two children in slots 0 and 1 and marks slots 2 and 3 empty.
  Floats 0-23 are the slots' boxes in SoA form (lo.x[4], lo.y[4],
  lo.z[4], hi.x[4], hi.y[4], hi.z[4]); then, as int32 bits: 24 the first
  slot's child (its record, or ~leaf where the slots are leaves; the
  others follow it, +1 for records, -1 for leaves), 25 the three
  near/far masks and 26 the empty bits (slot s holds no triangle). A mask
  has bit o set when a ray of direction-sign octant o (bit a: the
  direction is positive on axis a) takes the left one of a pair first:
  bits 0-7 the pair of pairs (the node's own code), 8-15 slots 0/1, 16-23
  slots 2/3, from `pair_codes`. Ordering the slots by them gives the
  binary walk's leaf order (ops.traverse.ordered_walk). The records are
  derived from `pack_nodes`' sibling-pair records.
- `wide` [8 * n_wide, 32] float32 (`pack_octant_records`), what K7 reads:
  those records once per octant, each record's slots in the order a ray
  of that octant visits them, floats 24-27 their children (a record of
  the same copy, ~leaf, or EMPTY_SLOT, which the walk skips).
- `tris` [n_leaves * leaf_size, 12] float32, three float4s per triangle
  slot in leaf order: (v0 xyz, id), (e1 xyz, 0), (e2 xyz, 0), the id as
  int32 bits. Padding slots have id -1 and end their leaf.

A miss returns t = tmax, u = v = 0 and prim = -1, as K1 and the stackless
walk (ops.traverse, the plain version) do; a dead ray (tmax < tmin) does
no work. On CPU tensors the wrappers run the plain version.

While a profiler records (render.profiling.recording), a launch takes K7's
counting build, which changes no result: it adds the rays it walks, the
child boxes it tests and the triangles it tests into three int64 words,
which go to the counters `bvh.rays`, `bvh.box_tests` and `bvh.tri_tests`
(render.profiling.count). Otherwise K7 runs its plain build, which counts
nothing.

Not carried over from the TPU kernel, since none of them changes a result:
the 128-lane row packing, the split of scenes above 150k triangles into
chunks (global memory holds the whole colonnade: 21.3 MB of octant
records and 12.6 MB of triangles at leaf 4), and the 8x128 pixel-block ray
order (a warp takes 32 rays of a row, or an 8x4 pixel tile where the
caller gives the rays' pixel width).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels as K
from ..render import profiling
from . import lbvh, traverse
from .traverse import pair_codes

# Triangles per leaf. A step of K7 tests four boxes (about 4 x 22 FLOP and
# a 128-byte record); a triangle test is about 45 FLOP and 48 bytes. With
# one thread per ray there is no 1024-ray packet to spread a step over (the
# TPU kernel's reason for 32), so the leaf that tests the fewest triangles
# wins while the walk stays short: on the colonnade's 1080p rays K7 is
# fastest at 4 of the sizes chip_smoke.py times (4, 8 and 32; PERF.md).
LEAF_SIZE = 4
WIDE_FLOATS = 32  # one 128-byte wide record
BLOCK = 128  # K7's threads a block (BVH_BLOCK in the source)
# K7 keeps each ray's stack in shared memory, 8 bytes an entry (a node and
# its entry distance), stack_entries(depth) a ray, BLOCK threads a block:
# depth 30 takes 45 entries, 46,080 bytes a block, under the 48 KB a launch
# may take without opting in, and keeps every leaf index in an int32
MAX_DEPTH = 30

K7 = K.register(K.Kernel(
    "bvh_trace", "bvh_trace",
    [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.vp, K.i32, K.i32, K.i32, K.i32, K.i32, K.i32,
     K.vp, K.vp, K.vp, K.vp, K.vp, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/bvh_trace.cu",
    replaces="capsaicin_tpu/ops/pallas_traverse.py:249",
))


class DeviceBVH:
    """The packed tree on a device, and the host BVH it was packed from
    (the plain version's input)."""

    def __init__(self, host: lbvh.BVH, wide: torch.Tensor, tris: torch.Tensor):
        self.host = host
        self.wide = wide
        self.tris = tris
        self.n_leaves = host.n_leaves
        self.leaf_size = host.leaf_size
        self.depth = host.depth
        self.n_wide = wide_heads(host.n_leaves).size  # records in each octant's copy


def pack_nodes(bvh: lbvh.BVH) -> np.ndarray:
    """[n_leaves, 16] float32 sibling-pair records (see the module doc)."""
    lo, hi = np.asarray(bvh.nodes_min), np.asarray(bvh.nodes_max)
    empty = lo[:, 0] > hi[:, 0]
    rec = np.zeros((bvh.n_leaves, 16), np.float32)
    left, right = slice(2, None, 2), slice(3, None, 2)
    rec[1:, 0:3] = lo[left]
    rec[1:, 3] = pair_codes(bvh)[1:]
    rec[1:, 4:7] = hi[left]
    rec[1:, 7] = empty[left] + 2 * empty[right]
    rec[1:, 8:11] = lo[right]
    rec[1:, 12:15] = hi[right]
    return rec


def octant_masks(codes: np.ndarray) -> np.ndarray:
    """int64 8-bit masks of pair codes: bit o is set when a ray of
    direction-sign octant o goes to the pair's left child first."""
    c = codes.astype(np.int64)
    octant = np.arange(8)
    first = ((octant[None, :] >> (c[:, None] & 3)) & 1) == (c[:, None] >= 4)
    return (first.astype(np.int64) << octant).sum(1)


def wide_heads(n_leaves: int) -> np.ndarray:
    """The heap indices of the wide records' nodes, in record order: the
    binary nodes at even depth below the leaves, level by level."""
    depth = int(n_leaves).bit_length() - 1
    return np.concatenate([np.arange(1 << d, 2 << d) for d in range(0, depth, 2)])


def stack_entries(depth: int) -> int:
    """K7's stack per ray: a four-wide step pushes at most 3 of its slots,
    a two-wide one (the last level of an odd depth) 1."""
    return 3 * (depth // 2) + depth % 2


def pack_wide_nodes(bvh: lbvh.BVH) -> np.ndarray:
    """[n_wide, 32] float32 wide records (see the module doc)."""
    rec = pack_nodes(bvh)
    n_leaves = bvh.n_leaves
    heads = wide_heads(n_leaves)
    index = np.zeros(n_leaves, np.int64)
    index[heads] = np.arange(heads.size)
    codes = octant_masks(pair_codes(bvh))
    out = np.zeros((heads.size, WIDE_FLOATS), np.float32)
    ints = out.view(np.int32)
    two = 2 * heads >= n_leaves  # depth D - 1: the children are the leaves
    k4, k2 = heads[~two], heads[two]
    # four-wide: the left pair is record 2k (children 4k, 4k+1), the right
    # one record 2k+1 (4k+2, 4k+3)
    pairs4 = [(2 * k4, 0), (2 * k4, 8), (2 * k4 + 1, 0), (2 * k4 + 1, 8)]
    pairs2 = [(k2, 0), (k2, 8)]
    for rows, pairs in ((~two, pairs4), (two, pairs2)):
        for slot, (r, off) in enumerate(pairs):
            for axis in range(3):
                out[rows, 4 * axis + slot] = rec[r, off + axis]
                out[rows, 12 + 4 * axis + slot] = rec[r, off + 4 + axis]
    for slot in (2, 3):  # the two-wide records' missing slots
        for axis in range(3):
            out[two, 4 * axis + slot] = lbvh.INF
            out[two, 12 + 4 * axis + slot] = -lbvh.INF
    e = rec[:, 7].astype(np.int64)
    first4 = 4 * k4
    ints[~two, 24] = np.where(first4 >= n_leaves, ~(first4 - n_leaves),
                              index[np.minimum(first4, n_leaves - 1)])
    ints[~two, 25] = codes[k4] | codes[2 * k4] << 8 | codes[2 * k4 + 1] << 16
    ints[~two, 26] = e[2 * k4] | e[2 * k4 + 1] << 2
    ints[two, 24] = ~(2 * k2 - n_leaves)
    ints[two, 25] = 0xFF | codes[k2] << 8
    ints[two, 26] = e[k2] | 12
    return out


EMPTY_SLOT = traverse.EMPTY_SLOT  # a slot's child in an octant record: no triangle


def pack_octant_records(bvh: lbvh.BVH) -> np.ndarray:
    """[8 * n_wide, 32] float32: the wide records once per direction-sign
    octant (copy o at rows o * n_wide ...), each record's slots put in that
    octant's visit order (the masks of pack_wide_nodes applied), floats
    0-23 their boxes as before and 24-27 their children as int32 bits (a
    record of the same copy, ~leaf, or EMPTY_SLOT)."""
    wide = pack_wide_nodes(bvh)
    ints = wide.view(np.int32)
    n = wide.shape[0]
    first, masks, empty = (ints[:, c].astype(np.int64) for c in (24, 25, 26))
    slot = np.arange(4)
    step = np.where(first >= 0, 1, -1)[:, None]
    refs = np.where((empty[:, None] >> slot) & 1, EMPTY_SLOT, first[:, None] + slot * step)
    out = np.zeros((8, n, WIDE_FLOATS), np.float32)
    for o in range(8):
        a = np.where((masks >> (8 + o)) & 1, 0, 1)  # the near slot of slots 0/1
        b = np.where((masks >> (16 + o)) & 1, 2, 3)  # and of slots 2/3
        left, right = np.stack([a, 1 - a], 1), np.stack([b, 5 - b], 1)
        order = np.where(((masks >> o) & 1)[:, None] == 1, np.concatenate([left, right], 1),
                         np.concatenate([right, left], 1))
        for f in range(6):
            out[o, :, 4 * f:4 * f + 4] = np.take_along_axis(wide[:, 4 * f:4 * f + 4], order, 1)
        out[o].view(np.int32)[:, 24:28] = np.take_along_axis(refs, order, 1)
    return out.reshape(8 * n, WIDE_FLOATS)


def pack_tris(bvh: lbvh.BVH) -> np.ndarray:
    """[P, 12] float32 triangle slots (see the module doc)."""
    rows = np.zeros((bvh.tri_v0.shape[0], 12), np.float32)
    rows[:, 0:3] = bvh.tri_v0
    rows[:, 4:7] = bvh.tri_e1
    rows[:, 8:11] = bvh.tri_e2
    rows.view(np.int32)[:, 3] = bvh.tri_id
    return rows


def build_bvh(tris, leaf_size: int = LEAF_SIZE, device=None) -> DeviceBVH:
    """tris [T,3,3] (numpy, or a tensor whose device is the default) ->
    the median-built tree packed on `device`."""
    if device is None:
        device = tris.device if isinstance(tris, torch.Tensor) else "cpu"
    host = lbvh.build_median_bvh(tris, leaf_size)
    if host.depth > MAX_DEPTH:
        raise ValueError(f"tree depth {host.depth} exceeds K7's limit of {MAX_DEPTH}")
    return DeviceBVH(host, torch.from_numpy(pack_octant_records(host)).to(device),
                     torch.from_numpy(pack_tris(host)).to(device))


COUNTERS = ("bvh.rays", "bvh.box_tests", "bvh.tri_tests")  # the counting build's words


@functools.lru_cache(maxsize=None)
def kernel_info(device_index: int, any_hit: bool, depth: int, counting: bool = False) -> dict:
    """K7's build on a card for a tree of `depth` (with `counting`, its
    counting build), from cudaFuncGetAttributes and the occupancy API:
    registers a thread, local (spilled or stack) bytes a thread, static and
    dynamic (the stacks') shared bytes a block, resident blocks of BLOCK
    threads an SM and warps an SM, and the SMs."""
    out = (ctypes.c_int * 6)()
    err = K.call("bvh_trace_info",
                 [K.i32, K.i32, K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                 int(any_hit), int(counting), stack_entries(depth), out, device_index)
    if err != 0:
        raise RuntimeError(f"bvh_trace_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "dynamic_shared_bytes",
                     "ctas_per_sm", "sms"), out))
    if info["ctas_per_sm"] < 1:
        raise RuntimeError(f"K7 does not fit an SM at depth {depth}: {info}")
    info["warps_per_sm"] = info["ctas_per_sm"] * BLOCK // 32
    return info


def tile_of(n_rays: int, width: int) -> int:
    """K7's tile width for n_rays rays in pixel order, rows of `width`:
    `width` where a warp can take 8x4 pixel tiles (width a multiple of 8,
    rows a multiple of 4), else 0 (a warp takes 32 consecutive rays)."""
    return width if width > 0 and width % 8 == 0 and n_rays % (4 * width) == 0 else 0


def bvh_trace(accel: DeviceBVH, origins, dirs, tmin: float, tmax, any_hit: bool,
              pixel_width: int = 0):
    """K7 on CUDA tensors, its plain version on CPU tensors. Returns
    (t, u, v, prim) for closest hit, or the bool hit mask for any-hit.
    On the card the grid is the resident blocks (at most one a BLOCK rays)
    and each warp takes 32 rays at a time from a zeroed counter; rays in
    pixel order with rows of `pixel_width` go as 8x4 tiles (tile_of), which
    changes no result. While a profiler records, the counting build runs
    and its counts go to render.profiling's counters (module doc)."""
    n = origins.shape[0]
    if isinstance(tmax, torch.Tensor):
        tmax = tmax.to(torch.float32).expand(n).contiguous()
    else:
        tmax = torch.full((n,), float(tmax), dtype=torch.float32, device=origins.device)
    if K.on_cpu(origins):
        if any_hit:
            return traverse.bvh_any(accel.host, origins, dirs, tmin, tmax)
        out = traverse.bvh_closest(accel.host, origins, dirs, tmin, tmax)
        return out["t"], out["u"], out["v"], out["prim"]
    dev = origins.device
    origins = origins.contiguous()
    dirs = dirs.contiguous()
    n_wide = accel.n_wide
    for name, x, shape in (("origins", origins, (n, 3)), ("dirs", dirs, (n, 3)),
                           ("tmax", tmax, (n,)), ("wide", accel.wide, (8 * n_wide, WIDE_FLOATS)),
                           ("tris", accel.tris, (accel.n_leaves * accel.leaf_size, 12))):
        K.check_cuda(x, name, torch.float32, shape, dev, align=16 if x.dim() == 2 else 1)
    counts = torch.zeros(3, dtype=torch.int64, device=dev) if profiling.recording() else None
    info = kernel_info(dev.index or 0, any_hit, accel.depth, counts is not None)
    grid = max(1, min(info["ctas_per_sm"] * info["sms"], -(-n // BLOCK)))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax), K.ptr(accel.wide), n_wide,
            K.ptr(accel.tris), n, accel.leaf_size, tile_of(n, pixel_width),
            stack_entries(accel.depth), int(any_hit), grid, K.ptr(counter))
    counts_ptr = None if counts is None else K.ptr(counts)
    if any_hit:
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        K7.launch(dev, *args, None, None, None, None, K.ptr(hit), counts_ptr)
        out = hit
    else:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        prim = torch.empty(n, dtype=torch.int32, device=dev)
        K7.launch(dev, *args, K.ptr(t), K.ptr(u), K.ptr(v), K.ptr(prim), None, counts_ptr)
        out = t, u, v, prim
    if counts is not None:
        for name, c in zip(COUNTERS, counts):
            profiling.count(name, c)
    return out


def bvh_closest(accel: DeviceBVH, origins, dirs, tmin: float = 0.0, tmax=1e6,
                pixel_width: int = 0):
    t, u, v, prim = bvh_trace(accel, origins, dirs, tmin, tmax, False, pixel_width)
    return {"t": t, "u": u, "v": v, "prim": prim}


def bvh_any(accel: DeviceBVH, origins, dirs, tmin: float = 1e-4, tmax=1e6, pixel_width: int = 0):
    return bvh_trace(accel, origins, dirs, tmin, tmax, True, pixel_width)


def sort_rays_for_traversal(origins, dirs, dead=None, dir_grid: int = 0):
    """(order, inverse) of a coherence sort of rays [N,3]: a direction key
    (the octant, or with dir_grid g one of 6*g*g major-axis face cells)
    over the origin's morton code, dead rays last. int64 keys and a stable
    sort give the JAX package's order; the inverse is a scatter."""
    lo = origins.amin(0)
    hi = origins.amax(0)
    om = lbvh.morton_codes(origins, lo, hi)
    if dir_grid:
        g = dir_grid
        ax = dirs.abs().argmax(1, keepdim=True)
        m = dirs.gather(1, ax)[:, 0]
        am = m.abs().clamp_min(1e-12)
        u = dirs.gather(1, (ax + 1) % 3)[:, 0] / am
        v = dirs.gather(1, (ax + 2) % 3)[:, 0] / am
        face = ax[:, 0] * 2 + (m > 0).long()
        qa = ((u + 1.0) * 0.5 * g).clamp(0, g - 1).long()
        qb = ((v + 1.0) * 0.5 * g).clamp(0, g - 1).long()
        bits = max(int(6 * g * g - 1).bit_length(), 3)
        key = (((face * g + qa) * g + qb) << (31 - bits)) | (om >> (bits + 1))
    else:
        octant = (dirs[:, 0] > 0).long() * 4 + (dirs[:, 1] > 0).long() * 2 + (dirs[:, 2] > 0).long()
        key = (octant << 28) | (om >> 4)
    if dead is not None:
        key = key | (dead.long() << 31)
    order = torch.argsort(key, stable=True)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return order, inverse
