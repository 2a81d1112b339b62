"""Traversal backends: the replacement for DXR's TraceRay, as in
capsaicin_tpu/render/traversal.py. A backend gives
  closest_fn(origins [N,3], dirs [N,3], tmin, tmax) -> {"t","u","v","prim"}
  any_fn(origins [N,3], dirs [N,3], tmin, tmax) -> bool [N]

Backends:
  "static" - every ray against every triangle of a scene of at most 128
             (kernel K1, ops.static)
  "brute"  - every ray against every triangle, any size (K8, ops.brute)
  "bvh"    - a median-built BVH walked per ray (K7, ops.bvh)
  "stream" - per-128-ray cull of every leaf block, then the hit blocks
             streamed nearest first (K10 and K11, ops.stream)
  "wavefront" - 128-ray packets walk the BVH all at once, listing leaf rows,
             then test the listed triangles (ops.wavefront, plain torch)
  "cull"   - 32-ray packets through a level cull, a frontier descent and
             the hit rows' triangles (ops.cull, plain torch): packet-interval
             tests for primary and shadow rays, per-ray tests for bounce
             rays (make_bounce_fns)
  "auto"   - "static" up to 128 triangles, else "bvh": the JAX package's
             rule on its production device
"""

from __future__ import annotations

import torch

from ..ops import brute, bvh, cull, static, stream, wavefront
from .profiling import span


def resolve_mode(mode: str, num_triangles: int) -> str:
    if mode == "auto":
        return "static" if num_triangles <= static.MAX_STATIC_TRIS else "bvh"
    if mode in _BACKENDS:
        return mode
    raise ValueError(f"unknown traversal mode {mode!r}")


def build_accel(scene, mode: str, stream_block_tris: int = None):
    """The acceleration structure of a resolved mode, from a Scene of
    tensors, on the scene's device (the BVHs are built on the host).
    `stream_block_tris` is the stream mode's block size (default
    stream.BLOCK_TRIS)."""
    tris = torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1)
    if mode == "static":
        return static.build_static(tris)
    if mode == "brute":
        return static.pack_triangles(tris)
    if mode == "bvh":
        return bvh.build_bvh(tris)
    if mode == "stream":
        return stream.build_stream_bvh(tris, stream_block_tris or stream.BLOCK_TRIS)
    if mode == "wavefront":
        return wavefront.build_wavefront_bvh(tris)
    if mode == "cull":
        return cull.build_cull_bvh(tris)
    raise ValueError(f"no acceleration structure for traversal {mode!r}")


_BACKENDS = {
    "static": (static.static_closest, static.static_any),
    "brute": (brute.brute_force_closest, brute.brute_force_any),
    "bvh": (bvh.bvh_closest, bvh.bvh_any),
    "stream": (stream.stream_closest, stream.stream_any),
    "wavefront": (wavefront.wavefront_closest, wavefront.wavefront_any),
    # primary and shadow rays: the coherent funnel (make_bounce_fns has the other)
    "cull": (cull.cull_closest, cull.cull_any),
}


def make_traversal(mode: str, accel, pixels=None):
    """The backend's (closest_fn, any_fn) on `accel`. With `pixels`, a
    function giving the frame's (W, H), the BVH backend takes a set of W*H
    rays as pixels in row order (K7 gives each warp an 8x4 tile of them;
    no result changes)."""
    closest_of, any_of = _BACKENDS[mode]

    def tiles(origins):
        if mode != "bvh" or pixels is None:
            return {}
        w, h = pixels()
        return {"pixel_width": w} if origins.shape[0] == w * h else {}

    def closest(origins, dirs, tmin, tmax):
        return closest_of(accel, origins, dirs, tmin, tmax, **tiles(origins))

    def any_hit(origins, dirs, tmin, tmax):
        return any_of(accel, origins, dirs, tmin, tmax, **tiles(origins))

    return closest, any_hit


def _sorted_inputs(origins, dirs, tmin, tmax, dir_grid):
    """The rays in coherence-sorted order (key sort and permutation, under
    the span `ray_sort`), and the inverse permutation."""
    n = origins.shape[0]
    with span("ray_sort"):
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
        hit = closest_fn(o, d, tmin, tm)
        with span("ray_sort"):
            return {k: x[inverse] for k, x in hit.items()}

    return sorted_closest


def with_ray_sorting_any(any_fn, dir_grid: int = 0):
    """The any-hit counterpart of with_ray_sorting."""

    def sorted_any(origins, dirs, tmin, tmax):
        o, d, tm, inverse = _sorted_inputs(origins, dirs, tmin, tmax, dir_grid)
        hit = any_fn(o, d, tmin, tm)
        with span("ray_sort"):
            return hit[inverse]

    return sorted_any


def make_stream_bounce_fns(sbvh):
    """The stream mode's bounce-ray trace functions, as the JAX package's:
    both sort the rays by a 96-cell direction key (dir_grid=4), and the
    closest-hit one also traces the sub-packets in descending order of
    candidate count (K11, then K10 in that order). The any-hit one
    is not balanced: a shadow ray stops at its first occluder, so the
    candidate count says little of its work."""

    def closest(origins, dirs, tmin, tmax):
        return stream.stream_closest(sbvh, origins, dirs, tmin, tmax, balance=True)

    def any_hit(origins, dirs, tmin, tmax):
        return stream.stream_any(sbvh, origins, dirs, tmin, tmax)

    return (with_ray_sorting(closest, dir_grid=4),
            with_ray_sorting_any(any_hit, dir_grid=4))


def make_bounce_fns(cull_bvh):
    """The cull mode's bounce-ray trace functions, as the JAX package's:
    the incoherent funnel (per-ray slab tests, the only ones that stay
    tight for scattered directions) on rays sorted by octant and origin
    (dir_grid=0), so that a packet keeps its origins together."""

    def closest(origins, dirs, tmin, tmax):
        return cull.cull_closest(cull_bvh, origins, dirs, tmin, tmax, coherent=False)

    def any_hit(origins, dirs, tmin, tmax):
        return cull.cull_any(cull_bvh, origins, dirs, tmin, tmax, coherent=False)

    return with_ray_sorting(closest), with_ray_sorting_any(any_hit)
