"""BVH traversal on the card (kernel K7, `csrc/bvh_trace.cu`): the torch
counterpart of capsaicin_tpu/ops/pallas_traverse.py.

The tree is ops.lbvh's median build, packed for the card:
- `nodes` [n_leaves, 16] float32, one 64-byte sibling-pair record per
  internal node k >= 1, holding its children 2k and 2k+1 as four float4s:
  (left min xyz, code), (left max xyz, empty), (right min xyz, 0),
  (right max xyz, 0). `code` is the pair's near/far code of the JAX
  package's `pack_bvh`: the axis of the largest centre offset, plus 4 when
  the left child is the lower one. `empty` has bit 0 set when the left
  child holds no triangle and bit 1 for the right one; the walk skips such
  a child, whose box (+3e38 .. -3e38) would pass the slab test on every
  axis. Record 0 is unused.
- `tris` [n_leaves * leaf_size, 12] float32, three float4s per triangle
  slot in leaf order: (v0 xyz, id), (e1 xyz, 0), (e2 xyz, 0), the id as
  int32 bits. Padding slots have id -1 and end their leaf.

A miss returns t = tmax, u = v = 0 and prim = -1, as K1 and the stackless
walk (ops.traverse, the plain version) do; a dead ray (tmax < tmin) does
no work. On CPU tensors the wrappers run the plain version.

Not carried over from the TPU kernel, since none of them changes a result:
the 128-lane row packing, the split of scenes above 150k triangles into
chunks (global memory holds the whole colonnade: 4 MB of nodes and
12.6 MB of triangles at leaf 4), and the 8x128 pixel-block ray order (a
warp's 32 rays are 32 pixels of one row either way).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as K
from . import lbvh, traverse

# Triangles per leaf. A step of K7 tests two boxes (about 2 x 22 FLOP and
# a 64-byte record); a triangle test is about 45 FLOP and 48 bytes. With
# one thread per ray there is no 1024-ray packet to spread a step over (the
# TPU kernel's reason for 32), so the leaf that tests the fewest triangles
# wins while the walk stays short: on the colonnade's 1080p rays K7 is
# fastest at 4 of the sizes chip_smoke.py times (4, 8 and 32; PERF.md).
LEAF_SIZE = 4
STACK_DEPTH = 32  # the kernel's per-ray stack; holds depth - 2 entries

K7 = K.register(K.Kernel(
    "bvh_trace", "bvh_trace",
    [K.vp, K.vp, K.f32, K.vp, K.vp, K.vp, K.i32, K.i32, K.i32, K.i32,
     K.vp, K.vp, K.vp, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/bvh_trace.cu",
    replaces="capsaicin_tpu/ops/pallas_traverse.py:249",
))


class DeviceBVH:
    """The packed tree on a device, and the host BVH it was packed from
    (the plain version's input)."""

    def __init__(self, host: lbvh.BVH, nodes: torch.Tensor, tris: torch.Tensor):
        self.host = host
        self.nodes = nodes
        self.tris = tris
        self.n_leaves = host.n_leaves
        self.leaf_size = host.leaf_size
        self.depth = host.depth


def pair_codes(bvh: lbvh.BVH) -> np.ndarray:
    """[n_leaves] float32: the near/far code of each sibling pair k (of
    children 2k, 2k+1), 0 at k = 0; column 6 of `pack_bvh`'s rows."""
    lo, hi = np.asarray(bvh.nodes_min), np.asarray(bvh.nodes_max)
    centers = (lo + hi) * np.float32(0.5)
    diff = centers[3::2] - centers[2::2]
    axis = np.argmax(np.abs(diff), axis=1)
    low = np.take_along_axis(diff, axis[:, None], axis=1)[:, 0] >= 0
    return np.concatenate([[0.0], axis + 4 * low]).astype(np.float32)


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
    if host.depth > STACK_DEPTH:
        raise ValueError(f"tree depth {host.depth} exceeds the kernel's stack of {STACK_DEPTH}")
    return DeviceBVH(host, torch.from_numpy(pack_nodes(host)).to(device),
                     torch.from_numpy(pack_tris(host)).to(device))


def bvh_trace(accel: DeviceBVH, origins, dirs, tmin: float, tmax, any_hit: bool):
    """K7 on CUDA tensors, its plain version on CPU tensors. Returns
    (t, u, v, prim) for closest hit, or the bool hit mask for any-hit."""
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
    for name, x, shape in (("origins", origins, (n, 3)), ("dirs", dirs, (n, 3)),
                           ("tmax", tmax, (n,)), ("nodes", accel.nodes, (accel.n_leaves, 16)),
                           ("tris", accel.tris, (accel.n_leaves * accel.leaf_size, 12))):
        K.check_cuda(x, name, torch.float32, shape, dev, align=16 if x.dim() == 2 else 1)
    args = (K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax), K.ptr(accel.nodes),
            K.ptr(accel.tris), n, accel.n_leaves, accel.leaf_size)
    if any_hit:
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        K7.launch(dev, *args, 1, None, None, None, None, K.ptr(hit))
        return hit
    t = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    K7.launch(dev, *args, 0, K.ptr(t), K.ptr(u), K.ptr(v), K.ptr(prim), None)
    return t, u, v, prim


def bvh_closest(accel: DeviceBVH, origins, dirs, tmin: float = 0.0, tmax=1e6):
    t, u, v, prim = bvh_trace(accel, origins, dirs, tmin, tmax, any_hit=False)
    return {"t": t, "u": u, "v": v, "prim": prim}


def bvh_any(accel: DeviceBVH, origins, dirs, tmin: float = 1e-4, tmax=1e6):
    return bvh_trace(accel, origins, dirs, tmin, tmax, any_hit=True)


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
