"""BVH builds over an implicit heap: the torch counterpart of
capsaicin_tpu/ops/lbvh.py.

Triangles are grouped into fixed-size leaves and the hierarchy is a
complete binary tree in heap order over the leaves: node k's children are
2k and 2k+1, the root is 1, index 0 is unused, and the leaves occupy
[n_leaves, 2*n_leaves). Every leaf sits at the same depth, so a node's DFS
successor is integer arithmetic on its index (ops.traverse). Slots past a
leaf's triangles are padding: triangle id -1 (and, in the median build, a
copy of triangle 0). A leaf or subtree with no triangles gets the empty
box +3e38 .. -3e38.

`build_lbvh` sorts by 30-bit morton code of the centroids, in torch on the
triangles' device. `build_median_bvh` splits each slot range at its
midpoint along the longest centroid axis, on the host in numpy: tighter
boxes, and the build the renderer uses (ops.bvh).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = np.float32(3e38)


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


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (the morton expansion), in int64 holding the
    uint32 values."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit morton codes (int64) of float32 points normalised to [lo, hi]."""
    extent = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((points - lo) / extent * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits_10(q[..., 0]) << 2) | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2]))


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


def build_lbvh(tris: torch.Tensor, leaf_size: int = 4) -> BVH:
    """tris [T,3,3] float32 (v0, v1, v2) -> the morton-ordered BVH, in torch
    on the triangles' device (a stable sort, so equal codes keep input
    order)."""
    tris = torch.as_tensor(tris, dtype=torch.float32)
    dev = tris.device
    t = tris.shape[0]
    n_leaves = _n_leaves(t, leaf_size)
    pad = n_leaves * leaf_size - t
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0)
    hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0)
    order = torch.argsort(morton_codes((v0 + v1 + v2) / 3.0, lo, hi), stable=True)

    zeros = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
    tri_id = torch.cat([order.to(torch.int32),
                        torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    gv0, gv1, gv2 = (torch.cat([x[order], zeros]) for x in (v0, v1, v2))
    valid = (tri_id >= 0)[:, None]
    p_min = torch.where(valid, torch.minimum(torch.minimum(gv0, gv1), gv2), float(INF))
    p_max = torch.where(valid, torch.maximum(torch.maximum(gv0, gv1), gv2), -float(INF))
    nodes_min, nodes_max = _fit_heap(
        p_min.reshape(n_leaves, leaf_size, 3).amin(1),
        p_max.reshape(n_leaves, leaf_size, 3).amax(1),
        torch.cat, torch.minimum, torch.maximum,
        lambda x: torch.full((1, 3), float(x), dtype=torch.float32, device=dev))
    return BVH(nodes_min, nodes_max, gv0, gv1 - gv0, gv2 - gv0, tri_id)


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
