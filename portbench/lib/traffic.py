"""The one traffic generator: a mix is a JSON file under portbench/traffic/
of parameters, and what a run renders is a function of those parameters,
the configuration and --seed alone, whatever the speed of the program.

A mix has:
  "loop"     "interactive": one client, each frame a camera update, then
             render() and its image on the host; "accumulate": one client,
             each request reset(), render_loop(frames, chunk, accumulate)
             and the readback of its mean
  "options"  values that replace the configuration's render options
  "camera"   how the pose moves from the configuration's preset:
             interactive: "drag_px" [max x, max y] drawn uniformly a frame,
             "dt_ms", "yaw_limit_deg", "pitch_limit_deg" (the path reflects
             there); accumulate: "yaw_deg", each request turned by a yaw
             drawn uniformly within +- that
  accumulate only: "frames" and "chunk" of a request
"""

from __future__ import annotations

import numpy as np

from . import camera as cam_lib


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of --seed (any integer) for one purpose `stream`."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


class FlyPath:
    """The interactive pose of each frame: a seeded mouse drag of up to
    drag_px pixels a frame at dt_ms, through the reference's mouse look,
    reflected to stay within the yaw and pitch limits of the preset."""

    def __init__(self, base: dict, params: dict, seed: int):
        self.base = base
        self.yaw0, self.pitch0 = cam_lib.yaw_pitch(base)
        self.max_dx, self.max_dy = params["drag_px"]
        self.dt = float(params["dt_ms"])
        self.limits = (float(params["yaw_limit_deg"]), float(params["pitch_limit_deg"]))
        self.rng = rng(seed, 1)
        self.offset = [0.0, 0.0]
        self.sign = [1.0, 1.0]

    def next(self) -> dict:
        """The next frame's pose."""
        drag = (self.rng.uniform(0.0, self.max_dx), self.rng.uniform(0.0, self.max_dy))
        for a in range(2):
            o = self.offset[a] + self.sign[a] * drag[a] * cam_lib.MOUSE_SENSITIVITY * self.dt
            lim = self.limits[a]
            if abs(o) > lim:
                o = np.sign(o) * 2 * lim - o
                self.sign[a] = -self.sign[a]
            self.offset[a] = o
        return cam_lib.look(self.base, self.yaw0 + self.offset[0], self.pitch0 + self.offset[1])


class RequestPoses:
    """The accumulate loop's pose of each request: the preset turned by a
    seeded yaw within +- yaw_deg."""

    def __init__(self, base: dict, params: dict, seed: int):
        self.base = base
        self.yaw0, self.pitch0 = cam_lib.yaw_pitch(base)
        self.spread = float(params["yaw_deg"])
        self.rng = rng(seed, 2)

    def next(self) -> dict:
        return cam_lib.look(self.base, self.yaw0 + self.rng.uniform(-self.spread, self.spread),
                            self.pitch0)


def poses(mix: dict, base: dict, seed: int):
    """The mix's pose source: next() gives the next frame's (interactive)
    or request's (accumulate) pose."""
    loop = mix["loop"]
    if loop == "interactive":
        return FlyPath(base, mix["camera"], seed)
    if loop == "accumulate":
        return RequestPoses(base, mix["camera"], seed)
    raise ValueError(f"unknown loop {loop!r}")
