"""K3's to K6's times on the inputs of a 1080p Cornell frame (the third
after a reset, default options): K3 (`eaw_disocclusion`) on the
denoiser's colour, geo and moments, K4 (`eaw_stage`, with the variance) at
strides 1, 3, 5 and 7 and K6 (`eaw_pair`, with the variance) at the pairs
(1, 3) and (5, 7) on the denoiser's colour and geo, K5 (`spatial_gather`)
on the gather's full-resolution input and on the [540, 960] input of a
`lowres_indirect` frame, each in float32 and in bf16 storage, with a
digest of each result and its max abs error against the plain version;
then the `gi1080`, `gi1080_eaw_bf16` and `gi1080_eaw_fused1` ms/frame. One
JSON line. Each kernel has two times: `ms`, CUDA events around `--iters` calls
as the host issues them (as chip_smoke.py times every kernel), and
`device_ms`, the same calls queued behind a spin of the device, so that a
call's host overhead in the wrapper leaves no gap between launches.

It uses only the stencil and session API that every version of the port
since K5 has (`stencil.eaw_disocclusion`, `stencil.eaw_stage`,
`stencil.eaw_pair`, `stencil.spatial_gather`, their plain
versions, `pipeline.render_frame(collect_aux=True)`), so an A/B of two trees
on one card runs it from each tree's root in turns (parent, change, change,
parent) and compares the times:

    python3 -m capsaicin_tpu_torch.tools.stencil_times [--iters 20] [--frames 8]

GPU only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from capsaicin_tpu_torch.ops import mathops as m
from capsaicin_tpu_torch.ops import stencil
from capsaicin_tpu_torch.render import passes, pipeline
from capsaicin_tpu_torch.render.session import RenderSession
from capsaicin_tpu_torch.render.settings import RenderOptions
from capsaicin_tpu_torch.render.traversal import make_traversal
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera
from capsaicin_tpu_torch.tools.stream_times import cuda_ms, device_ms, digest

W, H = 1920, 1080
STRIDES = (1, 3, 5, 7)
PAIRS = ((1, 3), (5, 7))  # K6 under eaw_fused="1"


def session(width=W, height=H, **options):
    """A Cornell session; the EAW variants set, not taken from the environment."""
    options = {"eaw_fused": "0", "eaw_bf16": False, **options}
    s = RenderSession(width, height, options=RenderOptions(**options), device="cuda")
    s.set_camera(make_camera("cornell", width, height))
    s.set_scene(build_scene(cornell_box()))
    return s


def frame_aux(s, options, frames=3):
    """(FrameState, PassOutputs) of the last of `frames` frames rendered
    from a reset with `options`, outside the session's own state."""
    closest, any_hit = make_traversal("static", s.accel)
    state = pipeline.init_state(s.width, s.height, s.camera, options)
    for _ in range(frames):
        _, state, aux = pipeline.render_frame(
            s.shade, closest, any_hit, s.camera, state, s.settings, s.noise, s.width, s.height,
            options, collect_aux=True)
    return state, aux


def stencil_inputs(s):
    """The stencils' float32 inputs of the third frame after a reset: the
    denoiser's `color4`, `geo` and `moments` [H,W,3] (and `moments4`,
    `normal`, `depth`, as the chain takes them), the gather's `indirect` and
    `full_geo`, and `low_in`, `low_geo` of a lowres_indirect frame [H/2,
    W/2]; `sig` and `gsig`, the denoiser's and the gather's sigmas."""
    st, aux = frame_aux(s, s.options)
    normal = m.oct_decode(st.prev_nd_oct)
    moments4 = st.moments_history.float()
    lst, laux = frame_aux(s, dataclasses.replace(s.options, lowres_indirect=True))
    ox, oy = passes.interleave_offset(lst.frame_count - 1)
    g = s.settings
    return dict(
        color4=st.color_history.float().contiguous(), geo=stencil.pack_geo(normal, st.prev_nd_depth),
        moments=moments4[..., [0, 1, 3]].contiguous(), moments4=moments4, normal=normal,
        depth=st.prev_nd_depth, indirect=aux.indirect_raw.contiguous(),
        full_geo=stencil.pack_geo(m.oct_decode(aux.nd_oct), aux.nd_depth),
        low_in=laux.indirect_raw.contiguous(),
        low_geo=stencil.pack_geo(m.oct_decode(laux.nd_oct[oy::2, ox::2]),
                                 laux.nd_depth[oy::2, ox::2]),
        sig=(g.eaw_normal_sigma, g.eaw_depth_sigma, g.eaw_luma_sigma),
        gsig=(g.gather_normal_sigma, g.gather_depth_sigma, g.gather_luma_sigma))


def frame_ms(frames, **options):
    """Host-clock ms/frame of a 1080p Cornell session over `frames` queued
    frames after one."""
    s = session(**options)
    s.render_async()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        s.render_async()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    ap.add_argument("--frames", type=int, default=8, help="frames timed per configuration")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    x = stencil_inputs(session())
    cases = {"k3_full": (stencil.eaw_disocclusion, stencil.eaw_disocclusion_plain,
                         (x["color4"], x["geo"], x["moments"], *x["sig"]))}
    cases.update({f"k4_s{k}": (stencil.eaw_stage, stencil.eaw_stage_plain,
                               (x["color4"], x["geo"], k, True, *x["sig"])) for k in STRIDES})
    cases.update({f"k6_p{a}{b}": (stencil.eaw_pair, stencil.eaw_pair_plain,
                                  (x["color4"], x["geo"], a, b, True, *x["sig"]))
                  for a, b in PAIRS})
    cases["k5_full"] = (stencil.spatial_gather, stencil.spatial_gather_plain,
                        (x["indirect"], x["full_geo"], *x["gsig"]))
    cases["k5_half"] = (stencil.spatial_gather, stencil.spatial_gather_plain,
                        (x["low_in"], x["low_geo"], *x["gsig"]))
    result = {"device": smi, "inputs": digest(tuple(v for v in x.values() if torch.is_tensor(v))),
              "kernels": {}, "frame_ms": {}}
    for name, (kernel, plain, args32) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            a = tuple(v.to(dt) if torch.is_tensor(v) else v for v in args32)
            out = kernel(*a)
            err = float((out.float() - plain(*a).float()).abs().max())
            entry = {"ms": cuda_ms(lambda: kernel(*a), args.iters),
                     "device_ms": device_ms(lambda: kernel(*a), args.iters),
                     "digest": digest(out.view(torch.int16) if dt == torch.bfloat16 else out),
                     "max_abs_err": err}
            key = f"{name}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
            result["kernels"][key] = entry
            print(f"{key}: {entry}", flush=True)
    for label, options in (("gi1080", {}), ("gi1080_eaw_bf16", dict(eaw_bf16=True)),
                           ("gi1080_eaw_fused1", dict(eaw_fused="1"))):
        result["frame_ms"][label] = frame_ms(args.frames, **options)
        print(f"{label}: {result['frame_ms'][label]:.2f} ms/frame", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
