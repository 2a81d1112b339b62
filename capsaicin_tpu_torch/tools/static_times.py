"""K1's times on the four ray sets of a 1080p Cornell frame (the third
after a reset, default options): primary closest, direct shadow any-hit,
bounce closest and NEE any-hit, with a digest of each result; then the
`gi1080` and `gi1080x4` ms/frame. One JSON line. Each set has two times:
`ms`, CUDA events around `--iters` calls as the host issues them (as
chip_smoke.py times every kernel), and `device_ms`, the same calls queued
behind a spin of the device.

It uses only the API that every version of the port has
(`static.static_trace`, the session, `pipeline.render_frame`), so an A/B of
two trees on one card runs it from each tree's root in turns (parent,
change, change, parent) and compares the times and the digests:

    python3 -m capsaicin_tpu_torch.tools.static_times [--iters 20] [--frames 8]

GPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from capsaicin_tpu_torch.ops import static
from capsaicin_tpu_torch.tools.stencil_times import device_ms, frame_ms, session
from capsaicin_tpu_torch.tools.stream_times import cuda_ms, digest, frame_rays

NAMES = ("primary", "shadow", "bounce", "nee")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    ap.add_argument("--frames", type=int, default=8, help="frames timed per configuration")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    s = session()
    calls = frame_rays(s)
    result = {"device": smi, "rays": {}, "k1": {}, "frame_ms": {}}
    for name, (kind, o, d, tmin, tmax) in zip(NAMES, calls):
        result["rays"][name] = digest((o, d, tmax))
        trace = lambda: static.static_trace(s.accel, o, d, tmin, tmax, kind == "any")  # noqa: E731
        entry = {"kind": kind, "ms": cuda_ms(trace, args.iters),
                 "device_ms": device_ms(trace, args.iters), "digest": digest(trace())}
        result["k1"][name] = entry
        print(f"{name}: {entry}", flush=True)
    del s
    for label, options in (("gi1080", {}), ("gi1080x4", dict(num_diffuse_bounces=4))):
        result["frame_ms"][label] = frame_ms(args.frames, **options)
        print(f"{label}: {result['frame_ms'][label]:.2f} ms/frame", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
