"""Hit-attribute fetch (kernel K2, `csrc/hit_attributes.cu`): the torch
counterpart of capsaicin_tpu/ops/pallas_lookup.py together with the
elementwise tail of shading.fetch_hit_attributes that consumes its rows.

The table is the [T,29] per-triangle record of render.shading
(`tri_attr_table`): v0 v1 v2 positions, n0 n1 n2 normals, t0 t1 t2
texcoords, material kd, texture id, mesh id.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from . import mathops as m

TABLE_COLS = 29

K2 = K.register(K.Kernel(
    "hit_attributes", "hit_attributes",
    [K.vp, K.vp, K.vp, K.vp, K.i32, K.i32, K.vp, K.vp, K.vp, K.vp, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/hit_attributes.cu",
    replaces="capsaicin_tpu/ops/pallas_lookup.py:31",
))


def hit_attributes_plain(table, prim, u, v):
    """The plain version of K2: a row gather and the interpolation."""
    a = table[prim.clamp(0, table.shape[0] - 1).long()]
    w = (1.0 - u - v)[..., None]
    uu = u[..., None]
    vv = v[..., None]
    return {
        "p": a[..., 0:3] * w + a[..., 3:6] * uu + a[..., 6:9] * vv,
        "n": m.normalize(a[..., 9:12] * w + a[..., 12:15] * uu + a[..., 15:18] * vv),
        "tx": a[..., 18:20] * w + a[..., 20:22] * uu + a[..., 22:24] * vv,
        "kd": a[..., 24:27],
        "tex": a[..., 27].to(torch.int32),
        "mesh": a[..., 28].to(torch.int32),
    }


def hit_attributes(table, prim, u, v):
    """(prim [N] int32, u [N], v [N]) -> dict of position [N,3], shading
    normal [N,3], texcoord [N,2], kd [N,3], texture id [N] and mesh id
    [N]. K2 on CUDA tensors, its plain version on CPU tensors. K2 reads a
    table of up to 128 rows from shared memory and a larger one from
    device memory; its launcher chooses by the row count."""
    if K.on_cpu(prim):
        return hit_attributes_plain(table, prim, u, v)
    dev = prim.device
    n = prim.shape[0]
    rows = table.shape[0]
    if rows < 1:
        raise ValueError("K2 needs a table of at least one row")
    u = u.contiguous()
    v = v.contiguous()
    K.check_cuda(prim, "prim", torch.int32, (n,), dev)
    K.check_cuda(u, "u", torch.float32, (n,), dev)
    K.check_cuda(v, "v", torch.float32, (n,), dev)
    K.check_cuda(table, "table", torch.float32, (rows, TABLE_COLS), dev)
    out = {
        "p": torch.empty((n, 3), dtype=torch.float32, device=dev),
        "n": torch.empty((n, 3), dtype=torch.float32, device=dev),
        "tx": torch.empty((n, 2), dtype=torch.float32, device=dev),
        "kd": torch.empty((n, 3), dtype=torch.float32, device=dev),
        "tex": torch.empty(n, dtype=torch.int32, device=dev),
        "mesh": torch.empty(n, dtype=torch.int32, device=dev),
    }
    K2.launch(dev, K.ptr(prim), K.ptr(u), K.ptr(v), K.ptr(table), n, rows,
              *[K.ptr(out[k]) for k in ("p", "n", "tx", "kd", "tex", "mesh")])
    return out
