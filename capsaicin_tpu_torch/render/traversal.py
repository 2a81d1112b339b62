"""Traversal backends: the replacement for DXR's TraceRay, as in
capsaicin_tpu/render/traversal.py. A backend gives
  closest_fn(origins [N,3], dirs [N,3], tmin, tmax) -> {"t","u","v","prim"}
  any_fn(origins [N,3], dirs [N,3], tmin, tmax) -> bool [N]

Backends:
  "static" - every ray against every triangle of a scene of at most 128
             (kernel K1, ops.static)
  "brute"  - every ray against every triangle, any size (K8, ops.brute)
  "bvh"    - a median-built BVH walked per ray (K7, ops.bvh)
  "auto"   - "static" up to 128 triangles, else "bvh": the JAX package's
             rule on its production device
"""

from __future__ import annotations

import torch

from ..ops import brute, bvh, static

_NOT_PORTED = {
    "wavefront": "ROADMAP A (not to be ported: pure-XLA backend)",
    "cull": "ROADMAP A (not to be ported: pure-XLA backend)",
    "stream": "ROADMAP A10 and B5 (stream traversal)",
}


def resolve_mode(mode: str, num_triangles: int) -> str:
    if mode == "auto":
        return "static" if num_triangles <= static.MAX_STATIC_TRIS else "bvh"
    if mode in ("static", "brute", "bvh"):
        return mode
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"traversal={mode!r} is not ported: {_NOT_PORTED[mode]}")
    raise ValueError(f"unknown traversal mode {mode!r}")


def build_accel(scene, mode: str):
    """The acceleration structure of a resolved mode, from a Scene of
    tensors, on the scene's device (the BVH is built on the host)."""
    tris = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    if mode == "static":
        return static.build_static(tris)
    if mode == "brute":
        return static.pack_triangles(tris)
    if mode == "bvh":
        return bvh.build_bvh(tris)
    raise ValueError(f"no acceleration structure for traversal {mode!r}")


_BACKENDS = {
    "static": (static.static_closest, static.static_any),
    "brute": (brute.brute_force_closest, brute.brute_force_any),
    "bvh": (bvh.bvh_closest, bvh.bvh_any),
}


def make_traversal(mode: str, accel):
    closest_of, any_of = _BACKENDS[mode]

    def closest(origins, dirs, tmin, tmax):
        return closest_of(accel, origins, dirs, tmin, tmax)

    def any_hit(origins, dirs, tmin, tmax):
        return any_of(accel, origins, dirs, tmin, tmax)

    return closest, any_hit


def _sorted_inputs(origins, dirs, tmin, tmax, dir_grid):
    n = origins.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=origins.device).expand(n)
    order, inverse = bvh.sort_rays_for_traversal(origins, dirs, dead=tmax < tmin,
                                                 dir_grid=dir_grid)
    return origins[order], dirs[order], tmax[order], inverse


def with_ray_sorting(closest_fn, dir_grid: int = 0):
    """A closest-hit function that traces the rays in coherence-sorted
    order (bvh.sort_rays_for_traversal, dead rays last) and returns the
    results in the caller's order. A permutation: the results are those
    of closest_fn."""

    def sorted_closest(origins, dirs, tmin, tmax):
        o, d, tm, inverse = _sorted_inputs(origins, dirs, tmin, tmax, dir_grid)
        return {k: x[inverse] for k, x in closest_fn(o, d, tmin, tm).items()}

    return sorted_closest


def with_ray_sorting_any(any_fn, dir_grid: int = 0):
    """The any-hit counterpart of with_ray_sorting."""

    def sorted_any(origins, dirs, tmin, tmax):
        o, d, tm, inverse = _sorted_inputs(origins, dirs, tmin, tmax, dir_grid)
        return any_fn(o, d, tmin, tm)[inverse]

    return sorted_any
