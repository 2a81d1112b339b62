"""One run of a cell: set-up, the measured window, an optional profiled
stretch inside it, and the check of what the window produced.

The program is capsaicin_tpu_torch, driven through its public session
API: create_session, set_camera, set_scene, render (interactive) or
reset and render_loop (accumulate), with the configuration's options,
settings and traversal, and the traffic's overrides."""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Optional

import numpy as np

from . import camera as cam_lib
from . import check, stats, traffic
from . import trace as trace_lib
from .scene import make_scene

# frames of the interactive loop that the trace covers (after the frames
# from which the checked one is drawn)
TRACE_FRAMES = 20


def clone_state(state):
    """A copy of a program FrameState: its tensors cloned, the rest as it is."""
    def copy(x):
        if hasattr(x, "clone"):
            return x.clone()
        if isinstance(x, tuple):
            return type(x)(*[copy(y) for y in x])
        return x

    return type(state)(*[copy(x) for x in state])


class Bench:
    """A cell's program session, built and warmed: `setup()`, then
    `window()`, then `check()`."""

    def __init__(self, cell, device: str = "cuda", size: Optional[tuple] = None,
                 option_overrides: Optional[dict] = None, scene_overrides: Optional[dict] = None):
        self.cell = cell
        self.device = device
        self.config = dict(cell.config)
        if size is not None:
            self.config["width"], self.config["height"] = size
        if scene_overrides:
            self.config["scene"] = dict(self.config["scene"], **scene_overrides)
        self.mix = cell.traffic
        self.options = dict(self.config["options"], **self.mix.get("options", {}),
                            **(option_overrides or {}))
        self.width, self.height = self.config["width"], self.config["height"]
        self.interactive = self.mix["loop"] == "interactive"

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        """Import the program, load its kernels, build the scene and the
        session. Returns the session."""
        import torch

        import capsaicin_tpu_torch as prog
        from capsaicin_tpu_torch import kernels
        from capsaicin_tpu_torch.ops.camera import Camera
        from capsaicin_tpu_torch.render.settings import RenderOptions, make_settings

        self.torch = torch
        self.Camera = Camera
        marks = [("import", time.perf_counter())]
        if self.device == "cuda":
            torch.cuda.init()
            marks.append(("cuda_init", time.perf_counter()))
            kernels.load()
            marks.append(("kernels_load", time.perf_counter()))
        self.scene = make_scene(self.config["scene"])
        marks.append(("scene_build", time.perf_counter()))
        self.base = cam_lib.preset(self.config["camera"], self.width, self.height)
        self.session = prog.create_session(
            self.width, self.height, device=self.device, traversal=self.config["traversal"],
            options=RenderOptions(**self.options),
            settings=make_settings(**self.config["settings"]))
        self.session.set_camera(self.camera(self.base))
        marks.append(("session", time.perf_counter()))
        self.session.set_scene(self.scene)
        self.sync()
        marks.append(("set_scene", time.perf_counter()))
        # seconds of each step of set-up, for the record
        self.setup_steps = {name: t - prev for (name, t), (_, prev) in zip(marks[1:], marks)}
        return self.session

    def camera(self, pose: dict):
        return cam_lib.as_camera(pose, self.Camera, "cpu")

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def warm(self):
        """Warm-up with the cell's own shapes. Interactive: the first frame
        after reset (kept for the check of the start) and one moving frame;
        accumulate: one frame of the request's options."""
        s = self.session
        t0 = time.perf_counter()
        if self.interactive:
            s.set_camera(self.camera(self.base))
            s.reset()
            self.start = (self.base, s.render(self.camera(self.base)))
            s.render(self.camera(cam_lib.look(self.base, *np.add(cam_lib.yaw_pitch(self.base),
                                                                 (0.5, 0.25)))))
        else:
            s.reset()
            s.render_loop(1, chunk=1, accumulate=True).cpu().numpy()
        self.sync()
        self.setup_steps["warm"] = time.perf_counter() - t0

    # -- the window -----------------------------------------------------------

    def window(self, seed: int, seconds: float, trace: bool = False):
        """Run the traffic for `seconds` from the end of set-up, to a frame
        or request boundary. Returns a dict of what the end-to-end metrics
        read; with `trace`, a profiled stretch of it is in self.trace."""
        self.trace = None
        if self.interactive:
            return self._interactive(seed, seconds, trace)
        return self._accumulate(seed, seconds, trace)

    def _interactive(self, seed, seconds, trace):
        s = self.session
        path = traffic.poses(self.mix, self.base, seed)
        check_at = int(traffic.rng(seed, 3).integers(0, self.mix["check_frames"]))
        s.set_camera(self.camera(self.base))
        s.reset()
        s.render(self.camera(self.base))  # the path starts from the preset, one frame in
        self.sync()
        trace_at = int(self.mix["check_frames"])
        latencies = []
        t_start = self.t_start = time.perf_counter()
        i, now = 0, t_start
        while now - t_start < seconds or i <= check_at:
            if trace and i == trace_at:
                self._profile_frames(path, latencies)
                i += TRACE_FRAMES
                now = time.perf_counter()
                continue
            cam = self.camera(path_pose := path.next())
            if i == check_at:
                before = clone_state(s.state)
            t0 = time.perf_counter()
            image = s.render(cam)
            now = time.perf_counter()
            latencies.append(now - t0)
            if i == check_at:
                self.step = (path_pose, before, image, clone_state(s.state))
            i += 1
        return {"frames": len(latencies), "window_s": now - t_start, "latencies_s": latencies,
                "rays_per_frame": self._rays()}

    def _profile_frames(self, path, latencies):
        s = self.session
        rf = self.torch.profiler.record_function

        def stretch():
            t0 = time.perf_counter()
            for _ in range(TRACE_FRAMES):
                cam = self.camera(path.next())
                with rf(trace_lib.FRAME_RANGE):
                    ts = time.perf_counter()
                    s.render(cam)
                    latencies.append(time.perf_counter() - ts)
            return TRACE_FRAMES, time.perf_counter() - t0

        self.trace = trace_lib.capture(stretch)

    def _accumulate(self, seed, seconds, trace):
        s = self.session
        poses = traffic.poses(self.mix, self.base, seed)
        frames, chunk = int(self.mix["frames"]), int(self.mix["chunk"])
        rf = self.torch.profiler.record_function
        self.requests = []
        latencies = []

        def request(ctx=nullcontext()):
            pose = poses.next()
            with ctx:
                t0 = time.perf_counter()
                s.set_camera(self.camera(pose))
                s.reset()
                image = s.render_loop(frames, chunk=chunk, accumulate=True).cpu().numpy()
                latencies.append(time.perf_counter() - t0)
            self.requests.append((pose, image))

        t_start = self.t_start = time.perf_counter()
        n = 0
        while time.perf_counter() - t_start < seconds:
            if trace and n == 1:
                def stretch():
                    t0 = time.perf_counter()
                    request(rf(trace_lib.FRAME_RANGE))
                    return frames, time.perf_counter() - t0

                self.trace = trace_lib.capture(stretch)
            else:
                request()
            n += 1
        window = time.perf_counter() - t_start
        return {"frames": n * frames, "requests": n, "window_s": window,
                "latencies_s": latencies, "rays_per_frame": self._rays()}

    def _rays(self) -> int:
        o = self.options
        return stats.rays_per_frame(self.width, self.height, o.get("num_diffuse_bounces", 1),
                                    o.get("spp", 1), o.get("lowres_indirect", False))

    # -- the check ------------------------------------------------------------

    def collect(self, seed: int, numbers):
        """What the check needs of the program before its session is freed.
        Accumulate loop, where the cell compares a step (`numbers`, the
        names of its limits): the request drawn from the seed is rendered
        again from reset through render_async, the frame drawn from the
        seed kept with the program's state before and after it, and the
        mean of the frames compared with the window's image."""
        if self.interactive:
            return
        self.pick = int(traffic.rng(seed, 4).integers(0, len(self.requests)))
        if "step_display_rmse" not in numbers:
            return
        s = self.session
        frames = int(self.mix["frames"])
        k = int(traffic.rng(seed, 5).integers(0, frames))
        pose, _ = self.requests[self.pick]
        s.set_camera(self.camera(pose))
        s.reset()
        total = None
        for j in range(frames):
            before = clone_state(s.state) if j == k else None
            display = s.render_async()
            total = display if total is None else total + display
            if j == k:
                self.step = (pose, before, display.cpu().numpy(), clone_state(s.state))
        self.rerun = (total / float(frames)).cpu().numpy()

    def release(self):
        """Free the program's session (the window's outputs kept)."""
        self.session = None
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, numbers, noise_path: str) -> dict:
        """The numbers compared with the reference (check.py), of those
        named in `numbers`."""
        ref = check.Reference(self.scene, self.config, self.options, self.device, noise_path)
        if self.interactive:
            return check.interactive_numbers(ref, self.start, self.step)
        pose, image = self.requests[self.pick]
        out = {}
        if "image_rmse" in numbers:
            out["image_rmse"] = check.rmse(ref.image(pose, int(self.mix["frames"])), image)
        if "step_display_rmse" in numbers:
            out["rerun_max_abs"] = float(np.abs(self.rerun.astype(np.float64) - image).max())
            out.update(check.step_numbers(ref, self.step))
        return out
