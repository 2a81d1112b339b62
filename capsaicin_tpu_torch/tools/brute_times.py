"""K8's and K9's times, with a digest of each result. One JSON line.

- K8 (`brute.brute_trace`) on the four ray sets of the third 1080p Cornell
  frame (primary closest, direct shadow any-hit, bounce closest, NEE
  any-hit) and on the 65,536-ray subsample of each of the full colonnade's
  four 1080p sets that `chip_smoke.py` holds K7 against (every n // 65,536th
  ray of the third `colonnade` frame, 249,190 triangles); then the
  `gi1080_brute` ms/frame.
- K9 (`microstep.microstep`), its five variants at 64 packets x 4096 steps.

Each kernel time is `ms`, CUDA events around `--iters` calls (`--colonnade-iters`
on the colonnade) as the host issues them, as chip_smoke.py times every
kernel, and on the Cornell sets also `device_ms`, the same calls queued
behind a spin of the device.

It uses only the API that every version of the port since K8 and K9 has
(`brute.brute_trace`, `microstep.microstep`, `microstep.make_inputs`, the
session), so an A/B of two trees on one card runs it from each tree's root
in turns (parent, change, change, parent) and compares the times and the
digests:

    python3 -m capsaicin_tpu_torch.tools.brute_times [--iters 20] [--colonnade-iters 3] [--frames 8]

GPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from capsaicin_tpu_torch.ops import brute, static
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade, cornell_box, make_camera
from capsaicin_tpu_torch.tools import microstep as msk
from capsaicin_tpu_torch.tools.stencil_times import session
from capsaicin_tpu_torch.tools.stream_times import cuda_ms, device_ms, digest, frame_rays

W, H = 1920, 1080
NAMES = ("primary", "shadow", "bounce", "nee")
SUBSAMPLE = 65_536  # chip_smoke.py's subsample of the colonnade's sets
PACKETS = 64


def colonnade_subsets():
    """The packed colonnade and the 65,536-ray subsample of each of the four
    sets of its third frame: (scene, [(kind, origins, dirs, tmin, tmax)])."""
    s = RenderSession(W, H, options=RenderOptions(), device="cuda", traversal="bvh")
    s.set_camera(make_camera("colonnade", W, H))
    s.set_scene(build_scene(colonnade()))
    tris = torch.stack([s.scene_dev.tri_v0, s.scene_dev.tri_v1, s.scene_dev.tri_v2], 1)
    subsets = []
    for kind, o, d, tmin, tmax in frame_rays(s):
        idx = torch.arange(0, o.shape[0], o.shape[0] // SUBSAMPLE, device=o.device)[:SUBSAMPLE]
        subsets.append((kind, o[idx].contiguous(), d[idx].contiguous(), tmin,
                        tmax[idx].contiguous()))
    return static.pack_triangles(tris), subsets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    ap.add_argument("--colonnade-iters", type=int, default=3, help="timed calls on the colonnade")
    ap.add_argument("--frames", type=int, default=8, help="gi1080_brute frames timed")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {"device": smi, "k8": {}, "k8_colonnade": {}, "k9": {}, "frame_ms": {}}

    s = session()
    for name, (kind, o, d, tmin, tmax) in zip(NAMES, frame_rays(s)):
        trace = lambda: brute.brute_trace(s.accel, o, d, tmin, tmax, kind == "any")  # noqa: E731
        entry = {"kind": kind, "ms": cuda_ms(trace, args.iters),
                 "device_ms": device_ms(trace, args.iters), "digest": digest(trace())}
        result["k8"][name] = entry
        print(f"K8 Cornell {name}: {entry}", flush=True)
    del s

    scene, subsets = colonnade_subsets()
    for name, (kind, o, d, tmin, tmax) in zip(NAMES, subsets):
        trace = lambda: brute.brute_trace(scene, o, d, tmin, tmax, kind == "any")  # noqa: E731
        entry = {"kind": kind, "rays": o.shape[0], "live": int((tmax > tmin).sum()),
                 "ms": cuda_ms(trace, args.colonnade_iters), "digest": digest(trace())}
        result["k8_colonnade"][name] = entry
        print(f"K8 colonnade subsample {name}: {entry}", flush=True)
    del scene, subsets

    rays, nodes = msk.make_inputs(PACKETS, device="cuda")
    for variant in msk.VARIANTS:
        walk = lambda v=variant: msk.microstep(v, rays, nodes, msk.STEPS)  # noqa: E731
        entry = {"ms": cuda_ms(walk, 5), "digest": digest(walk())}
        result["k9"][variant] = entry
        print(f"K9 {variant}: {entry}", flush=True)

    # gi1080_brute: the flagship frame with traversal="brute"
    s = RenderSession(W, H, options=RenderOptions(eaw_fused="0", eaw_bf16=False), device="cuda",
                      traversal="brute")
    s.set_camera(make_camera("cornell", W, H))
    s.set_scene(build_scene(cornell_box()))
    s.render_async()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.frames):
        s.render_async()
    torch.cuda.synchronize()
    result["frame_ms"]["gi1080_brute"] = (time.perf_counter() - t0) * 1e3 / args.frames
    print(f"gi1080_brute: {result['frame_ms']['gi1080_brute']:.2f} ms/frame", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
