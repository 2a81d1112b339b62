"""Brute-force intersector for scenes of any size (kernel K8,
`csrc/brute_trace.cu`): the torch counterpart of
capsaicin_tpu/ops/pallas_intersect.py, with the chunked oracle of
capsaicin_tpu/ops/intersect.py as its plain version.

Every ray tests every triangle. The contract is the oracle's: the closest
hit in (tmin, tmax), ties to the lowest triangle index, and t = 1e30 on a
miss (not tmax, as K1 and K7 return). tmin is a scalar, tmax a scalar or
[N] (tmax <= tmin marks a dead ray). The scene is K1's packing
(static.pack_triangles), of any size.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from .static import StaticScene
from .traverse import _mt_single

MISS_T = 1e30
TRI_BLOCK = 1024  # the oracle's triangle chunk
BLOCK = 256  # K8's rays a block (BRUTE_BLOCK in csrc/brute_trace.cu)
TILE = 256  # K8's triangles a tile in shared memory (BRUTE_TILE)
PAIRS_PER_CHUNK = 1 << 22  # rays x triangles per step of the plain version

K8 = K.register(K.Kernel(
    "brute_trace", "brute_trace",
    [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.i32,
     K.vp, K.vp, K.vp, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/brute_trace.cu",
    replaces="capsaicin_tpu/ops/pallas_intersect.py:93",
))


def brute_trace_plain(tris, origins, dirs, tmin: float, tmax, any_hit: bool):
    """The plain version of K8: the oracle's scan over triangle chunks of
    TRI_BLOCK, each a [rays, chunk] Moller-Trumbore block reduced by
    argmin (the first of equal t), the best hit carried across chunks on a
    strict <. Rays go in slices so a block stays near PAIRS_PER_CHUNK
    pairs. Returns (t, u, v, prim) or the hit mask."""
    n, t_tot = origins.shape[0], tris.shape[0]
    dev = origins.device
    tb = max(1, min(TRI_BLOCK, t_tot))
    step = max(1, PAIRS_PER_CHUNK // tb)
    best_t = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    for r0 in range(0, n, step):
        rs = slice(r0, min(n, r0 + step))
        o, d = origins[rs, None, :], dirs[rs, None, :]
        lo, hi = tmin, tmax[rs, None]
        for base in range(0, t_tot, tb):
            blk = tris[base:base + tb]
            t, u, v, ok = _mt_single(o, d, blk[None, :, 0:3], blk[None, :, 3:6],
                                     blk[None, :, 6:9], lo, hi)
            if any_hit:
                hit[rs] |= ok.any(1)
                continue
            t = torch.where(ok, t, MISS_T)
            j = t.argmin(1, keepdim=True)
            bt = t.gather(1, j)[:, 0]
            closer = bt < best_t[rs]
            best_t[rs] = torch.where(closer, bt, best_t[rs])
            best_u[rs] = torch.where(closer, u.gather(1, j)[:, 0], best_u[rs])
            best_v[rs] = torch.where(closer, v.gather(1, j)[:, 0], best_v[rs])
            best_p[rs] = torch.where(closer, (base + j[:, 0]).to(torch.int32), best_p[rs])
    return hit if any_hit else (best_t, best_u, best_v, best_p)


def kernel_info(any_hit: bool, n_tris: int, device_index: int = 0) -> dict:
    """K8's build on a card for a query and a scene size (a scene of at most
    TILE triangles has its own instance, with no pipeline), as
    `static.kernel_info` gives K1's: registers a thread, local (spilled)
    bytes a thread, static and dynamic shared bytes a block, resident blocks
    and warps an SM, SMs."""
    out = (ctypes.c_int * 6)()
    err = K.call("brute_trace_info", [K.i32, K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                 int(bool(any_hit)), int(n_tris), out, device_index)
    if err != 0:
        raise RuntimeError(f"brute_trace_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "dynamic_shared_bytes",
                     "ctas_per_sm", "sms"), out))
    info["warps_per_sm"] = info["ctas_per_sm"] * BLOCK // 32
    return info


def brute_trace(scene: StaticScene, origins, dirs, tmin: float, tmax, any_hit: bool):
    """K8 on CUDA tensors, its plain version on CPU tensors. Returns
    (t, u, v, prim) for closest hit, or the bool hit mask for any-hit."""
    n = origins.shape[0]
    if isinstance(tmax, torch.Tensor):
        tmax = tmax.to(torch.float32).expand(n).contiguous()
    else:
        tmax = torch.full((n,), float(tmax), dtype=torch.float32, device=origins.device)
    if K.on_cpu(origins):
        return brute_trace_plain(scene.tris, origins, dirs, tmin, tmax, any_hit)
    dev = origins.device
    origins = origins.contiguous()
    dirs = dirs.contiguous()
    for name, x, shape in (("origins", origins, (n, 3)), ("dirs", dirs, (n, 3)),
                           ("tmax", tmax, (n,)), ("tris", scene.tris, (scene.n_tris, 9))):
        K.check_cuda(x, name, torch.float32, shape, dev)
    args = (K.ptr(origins), K.ptr(dirs), float(tmin), K.ptr(tmax), K.ptr(scene.tris), n,
            scene.n_tris)
    if any_hit:
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        K8.launch(dev, *args, 1, None, None, None, None, K.ptr(hit))
        return hit
    t = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    K8.launch(dev, *args, 0, K.ptr(t), K.ptr(u), K.ptr(v), K.ptr(prim), None)
    return t, u, v, prim


def brute_force_closest(scene: StaticScene, origins, dirs, tmin: float = 0.0, tmax=1e6):
    t, u, v, prim = brute_trace(scene, origins, dirs, tmin, tmax, any_hit=False)
    return {"t": t, "u": u, "v": v, "prim": prim}


def brute_force_any(scene: StaticScene, origins, dirs, tmin: float = 1e-4, tmax=1e6):
    return brute_trace(scene, origins, dirs, tmin, tmax, any_hit=True)
