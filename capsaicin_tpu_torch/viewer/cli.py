"""Offline render CLI, the headless counterpart of the reference viewer
(src/viewer/main.cpp): load a scene, render N progressive frames, save a
PNG. It renders on the GPU unless asked for the CPU:

    python -m capsaicin_tpu_torch.viewer --scene cornell --frames 32 --out out.png
    python -m capsaicin_tpu_torch.viewer --obj path/to/scene.obj --width 1920 ...
    python -m capsaicin_tpu_torch.viewer --timings         # per-pass table
    python -m capsaicin_tpu_torch.viewer --web             # browser viewer
    python -m capsaicin_tpu_torch.viewer --device cpu --width 64 --height 64
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_session(args):
    from ..render import RenderOptions
    from ..render.session import RenderSession
    from ..scene import build_scene
    from ..scene.procedural import (colonnade, cornell_box, cornell_box_multitextured,
                                    cornell_box_textured, make_camera)
    from ..scene.scene import load_scene_obj, quantize_atlas

    options = RenderOptions(
        num_diffuse_bounces=args.bounces,
        lowres_indirect=args.lowres_indirect,
        output=args.output,
        denoise=not args.no_denoise,
        taa=not args.no_taa,
    )
    session = RenderSession(width=args.width, height=args.height, options=options,
                            traversal=args.traversal, device=args.device)
    preset = "cornell"
    if args.obj:
        scene = load_scene_obj(args.obj)
    elif args.scene == "cornell":
        scene = build_scene(cornell_box())
    elif args.scene == "cornell-textured":
        scene = build_scene(*cornell_box_textured())
    elif args.scene == "cornell-multitex":
        scene = build_scene(*cornell_box_multitextured())
    else:
        scene = build_scene(colonnade())
        preset = "colonnade"
    session.set_camera(make_camera(preset, args.width, args.height))
    if args.atlas_u32:
        scene = quantize_atlas(scene)
    session.set_scene(scene)
    return session


def main(argv=None):
    ap = argparse.ArgumentParser(prog="capsaicin_tpu_torch.viewer")
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "cornell-textured", "cornell-multitex", "colonnade"])
    ap.add_argument("--obj", default=None, help="render an OBJ file instead")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=1)
    ap.add_argument("--output", type=int, default=0,
                    help="0=combined 1=direct 2=indirect 3=variance")
    ap.add_argument("--traversal", default="auto",
                    choices=["auto", "brute", "bvh", "wavefront", "cull", "stream"])
    ap.add_argument("--lowres-indirect", action="store_true")
    ap.add_argument("--atlas-u32", action="store_true",
                    help="pack the texture atlas as rgba8 (R8G8B8A8 precision, a quarter "
                         "of the bytes)")
    ap.add_argument("--no-denoise", action="store_true")
    ap.add_argument("--no-taa", action="store_true")
    ap.add_argument("--exposure", type=float, default=None,
                    help="display exposure scale (default 1; the colonnade takes 0.2)")
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--timings", action="store_true", help="print per-pass timings")
    ap.add_argument("--web", action="store_true", help="interactive web viewer")
    ap.add_argument("--port", type=int, default=8089)
    ap.add_argument("--precompile", action="store_true",
                    help="run a frame of every panel variant before serving (no hitch on "
                         "the first flip; slower start)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) runs the CUDA kernels and raises without a GPU; "
                         "cpu runs their plain versions")
    args = ap.parse_args(argv)

    session = build_session(args)
    exposure = args.exposure
    if exposure is None and args.scene == "colonnade":
        exposure = 0.2  # the open-air sun otherwise saturates the display
    if exposure is not None:
        session.settings = session.settings._replace(exposure=float(np.float32(exposure)))

    if args.web:
        from .web import serve

        serve(session, port=args.port, precompile=args.precompile)
        return 0

    t0 = time.perf_counter()
    img = None
    for i in range(args.frames):
        img = session.render()
        if i == 0:
            print(f"first frame: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
    dt = (time.perf_counter() - t0) / max(args.frames - 1, 1)
    print(f"{1.0 / dt:.1f} fps ({dt * 1e3:.1f} ms/frame) at {args.width}x{args.height} "
          f"on {session.device}")
    session.save_png(args.out, img)
    print(f"wrote {args.out}")

    if args.timings:
        for name, seconds in session.measure_pass_timings().items():
            print(f"  {name:28s} {seconds * 1e3:8.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
