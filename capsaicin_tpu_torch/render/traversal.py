"""Traversal backends: the replacement for DXR's TraceRay, as in
capsaicin_tpu/render/traversal.py. A backend gives
  closest_fn(origins [N,3], dirs [N,3], tmin, tmax) -> {"t","u","v","prim"}
  any_fn(origins [N,3], dirs [N,3], tmin, tmax) -> bool [N]

Only the small-scene "static" backend (kernel K1) is ported so far.
"""

from __future__ import annotations

from ..ops import static

_NOT_PORTED = {
    "brute": "ROADMAP B3 (pallas_intersect brute-force kernels)",
    "bvh": "ROADMAP A9 and B4 (packet BVH traversal)",
    "wavefront": "ROADMAP A (not to be ported: pure-XLA backend)",
    "cull": "ROADMAP A (not to be ported: pure-XLA backend)",
    "stream": "ROADMAP A10 and B5 (stream traversal)",
}


def resolve_mode(mode: str, num_triangles: int) -> str:
    """"auto" and "static" give "static" for scenes of at most 128
    triangles; every other mode raises."""
    if mode in ("auto", "static"):
        if num_triangles <= static.MAX_STATIC_TRIS:
            return "static"
        raise NotImplementedError(
            f"{num_triangles} triangles need BVH traversal, not ported yet: "
            + _NOT_PORTED["bvh"])
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"traversal={mode!r} is not ported yet: {_NOT_PORTED[mode]}")
    raise ValueError(f"unknown traversal mode {mode!r}")


def build_accel(scene, mode: str):
    """The acceleration structure of a resolved mode, from a Scene of tensors."""
    import torch

    if mode != "static":
        raise NotImplementedError(f"traversal={mode!r} is not ported yet")
    return static.build_static(torch.stack([scene.tri_v0, scene.tri_v1, scene.tri_v2], 1))


def make_traversal(mode: str, accel):
    if mode != "static":
        raise NotImplementedError(f"traversal={mode!r} is not ported yet")

    def closest(origins, dirs, tmin, tmax):
        return static.static_closest(accel, origins, dirs, tmin, tmax)

    def any_hit(origins, dirs, tmin, tmax):
        return static.static_any(accel, origins, dirs, tmin, tmax)

    return closest, any_hit
