"""K7's times on the full colonnade's four 1080p ray sets (primary, direct
shadow, bounce, NEE of the third frame of `colonnade`) in pixel order and,
for bounce and NEE, in the session's sorted order (octant over morton
code, dead rays last, as `render.traversal.with_ray_sorting` sorts them),
at leaf 4, 8 and 32, with a digest of each result; at leaf 4 also the
pixel-order sets as the session traces them (`session_ms`: the BVH
backend's trace functions, which may hand K7 the pixel grid); then the
`colonnade` and `colonnade sort_bounce_rays=False` ms/frame. One JSON
line.

It uses only the BVH API that every version of the port since K7 has
(`bvh.build_bvh`, `bvh.bvh_trace`, `bvh.sort_rays_for_traversal`, the
session), so an A/B of two trees on one card runs it from each tree's root
in turns (parent, change, change, parent) and compares the times and the
digests:

    python3 -m capsaicin_tpu_torch.tools.bvh_times [--iters 3] [--frames 8] [--save PATH]

`--save` writes the leaf-4 results of every set (torch.save, about 70 MB)
for a ray-by-ray comparison where two trees' digests differ. GPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from capsaicin_tpu_torch.ops import bvh
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, make_camera
from capsaicin_tpu_torch.tools.stream_times import NAMES, cuda_ms, digest, frame_rays

W, H = 1920, 1080
LEAVES = (4, 8, 32)


def session(host, **options):
    """A 1080p colonnade session through the BVH; the EAW variants set (so
    that trees whose defaults come from the environment and trees whose
    defaults do not render the same frame)."""
    options = {"eaw_fused": "0", "eaw_bf16": False, **options}
    s = RenderSession(W, H, options=RenderOptions(**options), device="cuda", traversal="bvh")
    s.set_camera(make_camera("colonnade", W, H))
    s.set_scene(host)
    return s


def frame_ms(host, frames, **options):
    """Host-clock ms/frame of `colonnade` over `frames` queued frames after one."""
    s = session(host, **options)
    s.render_async()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        s.render_async()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3, help="timed calls after one warm-up")
    ap.add_argument("--frames", type=int, default=8, help="frames timed per configuration")
    ap.add_argument("--save", help="torch.save the leaf-4 results here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    host = build_scene(colonnade())
    s = session(host)
    calls = frame_rays(s)
    tris = torch.stack([s.scene_dev.tri_v0, s.scene_dev.tri_v1, s.scene_dev.tri_v2], 1)
    sets = {}
    for name, (kind, o, d, tmin, tmax) in zip(NAMES, calls):
        sets[name] = (kind == "any", o, d, tmin, tmax)
        if name in ("bounce", "nee"):
            order, _ = bvh.sort_rays_for_traversal(o, d, dead=tmax < tmin)
            sets[name + "_sorted"] = (kind == "any", o[order].contiguous(), d[order].contiguous(),
                                      tmin, tmax[order].contiguous())
    result = {"device": smi, "env": {v: os.environ.get(v) for v in ("CAPSAICIN_EAW_FUSED",
                                                                     "CAPSAICIN_EAW_BF16")},
              "rays": {n: digest(v[1:3] + v[4:]) for n, v in sets.items()},
              "k7": {}, "frame_ms": {}}
    saved = {}
    for leaf in LEAVES:
        tree = bvh.build_bvh(tris, leaf)
        for name, (any_hit, o, d, tmin, tmax) in sets.items():
            trace = lambda: bvh.bvh_trace(tree, o, d, tmin, tmax, any_hit)  # noqa: E731
            out = trace()
            entry = {"ms": cuda_ms(trace, args.iters), "digest": digest(out)}
            if leaf == 4 and not name.endswith("_sorted"):  # the session's own call
                fn = s._trace[1 if any_hit else 0]
                got = fn(o, d, tmin, tmax)
                got = got if any_hit else tuple(got[k] for k in ("t", "u", "v", "prim"))
                entry["session_ms"] = cuda_ms(lambda: fn(o, d, tmin, tmax), args.iters)
                entry["session_digest"] = digest(got)
            if leaf == 4 and args.save:
                saved[name] = tuple(x.cpu() for x in out) if isinstance(out, tuple) else out.cpu()
            result["k7"][f"{name}{leaf}"] = entry
            print(f"leaf {leaf} {name}: {entry}", flush=True)
        del tree
    del s
    if args.save:
        torch.save(saved, args.save)
    for label, options in (("colonnade", {}),
                           ("colonnade_nosort", dict(sort_bounce_rays=False))):
        result["frame_ms"][label] = frame_ms(host, args.frames, **options)
        print(f"{label}: {result['frame_ms'][label]:.2f} ms/frame", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
