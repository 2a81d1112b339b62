"""Frame times of the gi1080 configuration (1920x1080, the Cornell box
through K1, default options with the EAW variants pinned) on one card: an
unsharded session and sessions on meshes of n x cuda:0, timed in turn
over several rounds of frames (render_async, one sync a round), so that a
drift of the card's clock touches each session alike. One JSON line: the
package that ran (its path), the card's name and power limit, and each
session's ms/frame in every round.

    python3 capsaicin_tpu_torch/tools/frame_times.py [--meshes 0 1 2] [--rounds 5] [--frames 8]

`--meshes`: 0 is the session without a mesh, n > 0 a mesh of n x cuda:0.
Run by path, it times the capsaicin_tpu_torch that is first on
PYTHONPATH, so an A/B of two trees runs it once with each tree there, in
the order A, B, B, A. GPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

WIDTH, HEIGHT = 1920, 1080


def session(blocks: int):
    """The gi1080 session, on a mesh of `blocks` x cuda:0 (0: no mesh)."""
    from capsaicin_tpu_torch.render.session import RenderSession
    from capsaicin_tpu_torch.render.settings import RenderOptions
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera

    kw = {}
    if blocks:
        from capsaicin_tpu_torch.parallel import make_mesh

        kw["mesh"] = make_mesh(["cuda:0"] * blocks)
    s = RenderSession(WIDTH, HEIGHT, options=RenderOptions(eaw_fused="0", eaw_bf16=False),
                      **kw)
    s.set_camera(make_camera("cornell", WIDTH, HEIGHT))
    s.set_scene(build_scene(cornell_box()))
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", type=int, nargs="+", default=[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    import capsaicin_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("frame_times: CUDA is not available")
    sessions = {n: session(n) for n in args.meshes}
    for s in sessions.values():  # the first frame of each sets up its buffers
        s.render_async()
    torch.cuda.synchronize()
    ms = {n: [] for n in sessions}
    for _ in range(args.rounds):
        for n, s in sessions.items():
            t0 = time.perf_counter()
            for _ in range(args.frames):
                s.render_async()
            torch.cuda.synchronize()
            ms[n].append((time.perf_counter() - t0) * 1e3 / args.frames)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"package": capsaicin_tpu_torch.__file__, "card": smi,
                      "frames_a_round": args.frames,
                      "ms_per_frame": {("unsharded" if n == 0 else f"{n} blocks"): v
                                       for n, v in ms.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
