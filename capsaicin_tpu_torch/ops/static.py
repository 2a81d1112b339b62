"""Small-scene intersector (kernel K1, `csrc/static_trace.cu`): the torch
counterpart of capsaicin_tpu/ops/pallas_static.py.

For scenes of at most 128 triangles (Cornell-class) every ray tests every
triangle, in index order, with the Moller-Trumbore epsilons of
ops.intersect. A miss returns t = tmax, u = v = 0 and prim = -1, the
contract of the TPU kernel. Rays are [N,3] origins and directions; tmax is
a scalar or [N] (tmax <= tmin marks a dead ray, which never hits).

K1 returns exactly what the plain version returns, bit for bit: it runs
the same test on every pair that a division-free prefilter does not rule
out (csrc/static_trace.cu).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from .traverse import _mt_single

MAX_STATIC_TRIS = 128
BLOCK = 256  # K1's rays a block (STATIC_BLOCK in csrc/static_trace.cu)

K1 = K.register(K.Kernel(
    "static_trace", "static_trace",
    [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.i32,
     K.vp, K.vp, K.vp, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/static_trace.cu",
    replaces="capsaicin_tpu/ops/pallas_static.py:41",
))


class StaticScene:
    """Triangles packed as [T,9] rows (v0, e1 = v1-v0, e2 = v2-v0): the
    input of K1 and of the brute-force K8 (ops.brute)."""

    def __init__(self, tris: torch.Tensor):
        self.tris = tris
        self.n_tris = tris.shape[0]


def pack_triangles(tris) -> StaticScene:
    """tris [T,3,3] -> the packed scene, any T; prim ids are the input
    triangle indices."""
    tris = torch.as_tensor(tris, dtype=torch.float32)
    v0 = tris[:, 0]
    return StaticScene(torch.cat([v0, tris[:, 1] - v0, tris[:, 2] - v0], -1).contiguous())


def build_static(tris) -> StaticScene:
    """pack_triangles for K1, which takes at most MAX_STATIC_TRIS."""
    if len(tris) > MAX_STATIC_TRIS:
        raise ValueError(f"static kernel takes at most {MAX_STATIC_TRIS} triangles")
    return pack_triangles(tris)


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


def first_hits(tris, origins, dirs, tmin: float, tmax):
    """Each ray's first hit in index order, where an any-hit trace of K1, K8
    or their plain versions stops: the triangle index, -1 for a miss or a
    dead ray (tmax <= tmin). int64 [N]. The plain versions' arithmetic
    (`traverse._mt_single`) over chunks of 1,024 triangles and about 2^22
    pairs, so it serves scenes of any size."""
    n, t_tot = origins.shape[0], tris.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=origins.device).expand(n)
    first = torch.full((n,), -1, dtype=torch.int64, device=origins.device)
    tb = max(1, min(1024, t_tot))
    step = max(1, (1 << 22) // tb)
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        o, d, hi = origins[rs, None, :], dirs[rs, None, :], tmax[rs, None]
        for base in range(0, t_tot, tb):
            blk = tris[base:base + tb]
            ok = _mt_single(o, d, blk[None, :, 0:3], blk[None, :, 3:6], blk[None, :, 6:9],
                            tmin, hi)[3]
            first[rs] = torch.where((first[rs] < 0) & ok.any(1), base + ok.int().argmax(1),
                                    first[rs])
    return first


def any_hit_tests(tris, origins, dirs, tmin: float, tmax):
    """The triangle tests an any-hit trace in index order does per ray, as
    the plain versions, K1 and K8 stop: the index of the first hit plus 1,
    n_tris for a miss, 0 for a dead ray (tmax <= tmin). int64 [N]."""
    first = first_hits(tris, origins, dirs, tmin, tmax)
    live = torch.as_tensor(tmax, dtype=torch.float32, device=origins.device) > tmin
    return torch.where(live, torch.where(first >= 0, first + 1, tris.shape[0]), 0)


def kernel_info(any_hit: bool, device_index: int = 0) -> dict:
    """K1's build on a card (cudaFuncGetAttributes and the occupancy API):
    registers a thread, local (spilled) bytes a thread, static and dynamic
    shared bytes a block, resident blocks and warps an SM, SMs."""
    out = (ctypes.c_int * 6)()
    err = K.call("static_trace_info", [K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                 int(bool(any_hit)), out, device_index)
    if err != 0:
        raise RuntimeError(f"static_trace_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "dynamic_shared_bytes",
                     "ctas_per_sm", "sms"), out))
    info["warps_per_sm"] = info["ctas_per_sm"] * BLOCK // 32
    return info


def static_trace(scene: StaticScene, origins, dirs, tmin: float, tmax, any_hit: bool):
    """K1 on CUDA tensors, its plain version on CPU tensors. Returns
    (t, u, v, prim) for closest hit, or the bool hit mask for any-hit."""
    n = origins.shape[0]
    if isinstance(tmax, torch.Tensor):
        tmax = tmax.to(torch.float32).expand(n).contiguous()
    else:
        tmax = torch.full((n,), float(tmax), dtype=torch.float32, device=origins.device)
    if K.on_cpu(origins):
        t, u, v, prim = static_trace_plain(scene.tris, origins, dirs, tmin, tmax, any_hit)
        return prim >= 0 if any_hit else (t, u, v, prim)
    dev = origins.device
    origins = origins.contiguous()
    dirs = dirs.contiguous()
    for name, x, shape in (("origins", origins, (n, 3)), ("dirs", dirs, (n, 3)),
                           ("tmax", tmax, (n,)), ("tris", scene.tris, (scene.n_tris, 9))):
        K.check_cuda(x, name, torch.float32, shape, dev)
    if any_hit:
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        K1.launch(dev, K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax),
                  K.ptr(scene.tris), n, scene.n_tris, 1,
                  None, None, None, None, K.ptr(hit))
        return hit
    t = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    K1.launch(dev, K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax),
              K.ptr(scene.tris), n, scene.n_tris, 0,
              K.ptr(t), K.ptr(u), K.ptr(v), K.ptr(prim), None)
    return t, u, v, prim


def static_closest(scene: StaticScene, origins, dirs, tmin: float = 0.0, tmax=1e6):
    t, u, v, prim = static_trace(scene, origins, dirs, tmin, tmax, any_hit=False)
    return {"t": t, "u": u, "v": v, "prim": prim}


def static_any(scene: StaticScene, origins, dirs, tmin: float = 1e-4, tmax=1e6):
    return static_trace(scene, origins, dirs, tmin, tmax, any_hit=True)
