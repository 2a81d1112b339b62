"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (portbench/reference) computing the same
frames from the same scene, cameras and options, in float32.

The numbers compared and their limits are the cell's own data,
portbench/limits/<cell>.json: {"<number>": limit, ...}. A run is correct
where each number is finite and at most its limit.

  interactive loop (one frame a request):
    start_display_rmse   display RMSE of the first frame after reset (set-up's
                         first frame), the reference from its own initial state
    step_display_rmse    display RMSE of a frame of the window drawn from the
                         seed, the reference from a copy of the program's state
                         before that frame (the program's histories are only
                         followed step by step, so the start is checked apart)
    step_history_rmse    RMSE of the colour history (rgb and variance) that frame
                         left, over its mean absolute value
    step_primary_mismatch share of pixels whose primary hit (instance id, or a
                         depth off by over 1e-5 of itself) differs
  accumulate loop (a request is one image; a finished request drawn from
  the seed), as the cell's limits name them:
    image_rmse           RMSE of its mean image, the reference rendering all its
                         frames from reset
  or, where the reference cannot render a whole request inside a run:
    rerun_max_abs        the request rendered again from reset, frame by frame
                         through render_async: the largest difference of the mean
                         from the window's image (0: the frames are the window's)
    step_*               as above, of a frame of it drawn from the seed
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np

LIMITS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "limits")


def limits_of(cell_name: str) -> Dict[str, float]:
    path = os.path.join(LIMITS_DIR, f"{cell_name}.json")
    if not os.path.isfile(path):
        raise ValueError(f"no limits for cell {cell_name!r} ({path})")
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def rmse(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit", "ok"}} for every number that has a limit;
    a number without a limit, or a limit without its number, is an error."""
    if set(numbers) != set(limits):
        raise ValueError(f"compared numbers {sorted(numbers)} do not match the limits "
                         f"{sorted(limits)}")
    return {k: {"value": v, "limit": limits[k],
                "ok": bool(math.isfinite(v) and v <= limits[k])} for k, v in numbers.items()}


class Reference:
    """The reference's view of a cell: the scene's shading tables and
    traversal (built again here from the benchmark's scene arrays), the
    blue-noise texture read from its raw file, settings and options."""

    def __init__(self, scene, config: dict, options: dict, device, noise_path: str):
        import torch

        from ..reference import shading, trace
        from ..reference.settings import make_settings, options_from

        self.device = device
        self.width, self.height = config["width"], config["height"]
        self.shade = shading.shading_scene(scene, device)
        tris = torch.from_numpy(scene.triangles()).to(device)
        self.closest, self.any = trace.make_traversal(tris, config["reference_traversal"])
        self.noise = torch.from_numpy(np.load(noise_path).astype(np.float32)).to(device)
        self.settings = make_settings(**config["settings"])
        self.options = options_from(options)

    def camera(self, pose: dict):
        from ..reference.camera import Camera
        from . import camera as cam_lib

        return cam_lib.as_camera(pose, Camera, self.device)

    def state_from(self, program_state):
        """The reference's FrameState holding a program FrameState's
        tensors, read by field name."""
        import torch

        from ..reference.camera import Camera
        from ..reference.frame import FrameState

        fields = {f: getattr(program_state, f) for f in FrameState._fields}
        cam = Camera(*[x.to(self.device) for x in fields.pop("prev_camera")])
        return FrameState(prev_camera=cam, **{k: v.to(self.device) if torch.is_tensor(v) else v
                                              for k, v in fields.items()})

    def frame(self, pose: dict, state=None):
        """(display [H,W,3], next state) of one frame from `state` (the
        reference's own initial state by default)."""
        from ..reference import frame

        cam = self.camera(pose)
        if state is None:
            state = frame.init_state(self.width, self.height, cam)
        return frame.render_frame(self.shade, self.closest, self.any, cam, state, self.settings,
                                  self.noise, self.width, self.height, self.options)

    def image(self, pose: dict, frames: int) -> np.ndarray:
        """The mean display of `frames` frames from reset with the pose held."""
        total, state = None, None
        for _ in range(frames):
            display, state = self.frame(pose, state)
            total = display if total is None else total + display
        return (total / float(frames)).cpu().numpy()


def step_numbers(ref: Reference, step) -> Dict[str, float]:
    """The numbers of one frame that the reference renders from the
    program's state. step: (pose, program state before, display, program
    state after)."""
    pose, before, display, after = step
    d_ref, s_ref = ref.frame(pose, ref.state_from(before))
    out = {"step_display_rmse": rmse(d_ref.cpu().numpy(), display)}
    hist = after.color_history.float().cpu().numpy()
    hist_ref = s_ref.color_history.cpu().numpy()
    out["step_history_rmse"] = rmse(hist, hist_ref) / max(float(np.abs(hist_ref).mean()), 1e-30)
    inst = after.prev_nd_inst.cpu().numpy()
    depth = after.prev_nd_depth.float().cpu().numpy()
    depth_ref = s_ref.prev_nd_depth.cpu().numpy()
    off = (inst != s_ref.prev_nd_inst.cpu().numpy()) | (
        np.abs(depth - depth_ref) > 1e-5 * np.abs(depth_ref))
    out["step_primary_mismatch"] = float(off.mean())
    return out


def interactive_numbers(ref: Reference, start, step) -> Dict[str, float]:
    """The interactive loop's numbers. start: (pose, display) of the first
    frame after reset; step: as step_numbers."""
    pose0, display0 = start
    d_ref, _ = ref.frame(pose0)
    out = {"start_display_rmse": rmse(d_ref.cpu().numpy(), display0)}
    out.update(step_numbers(ref, step))
    return out
