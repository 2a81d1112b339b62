"""RenderSession: the host-side orchestration of the port (the torch
counterpart of capsaicin_tpu/render/session.py): device placement, scene
upload, camera updates, the frame state and readback.

PyTorch runs eagerly, so there is no compile cache or variant
precompilation: a frame is a sequence of kernel launches on the current
stream, and `render_async` returns before the device has finished. An
options change takes effect on the next frame.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import convert
from ..ops.camera import Camera, camera_to, default_camera
from ..scene import textures
from . import pipeline, shading
from .settings import RenderOptions, Settings, default_settings
from .traversal import (build_accel, make_stream_bounce_fns, make_traversal, resolve_mode,
                        with_ray_sorting, with_ray_sorting_any)


class RenderSession:
    def __init__(
        self,
        width: int = 1920,
        height: int = 1080,
        options: Optional[RenderOptions] = None,
        settings: Optional[Settings] = None,
        traversal: str = "auto",
        camera: Optional[Camera] = None,
        device="cuda",
        stream_block_tris: Optional[int] = None,
    ):
        """device: "cuda" (the default) runs the frame through the CUDA
        kernels and raises if CUDA is absent; "cpu" runs their plain
        versions. stream_block_tris: the block size of traversal="stream"
        (None: ops.stream.BLOCK_TRIS, 32)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for the CPU path")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.width = width
        self.height = height
        self.options = options or RenderOptions()
        self.settings = settings or default_settings()
        self.traversal_mode = traversal
        self.stream_block_tris = stream_block_tris
        self.camera = camera_to(camera or default_camera(aspect=height / width), self.device)
        self.noise = torch.from_numpy(textures.blue_noise_256()).to(self.device)
        self.scene_dev = None
        self.shade: Optional[shading.ShadingScene] = None
        self.accel = None
        self._trace = None
        self._sorted_trace = None
        self._sorted_shadow = None
        self.state: Optional[pipeline.FrameState] = None

    # -- scene ------------------------------------------------------------

    def set_scene(self, scene):
        """Upload a Scene of numpy arrays (textured or not; either atlas
        form) and build its acceleration structure and shading tables."""
        scene_dev = convert.scene_from_numpy(scene, self.device)
        mode = resolve_mode(self.traversal_mode, scene_dev.tri_v0.shape[0])
        self.accel = build_accel(scene_dev, mode, self.stream_block_tris)
        self._trace = make_traversal(mode, self.accel, lambda: (self.width, self.height))
        # while options.sort_bounce_rays holds, the BVH and stream modes
        # trace bounce rays sorted (so not in pixel order), as the JAX
        # package does for its packet and stream kernels; the stream mode
        # sorts the direct shadow rays too (by octant) and balances the
        # bounce closest-hit trace
        closest, any_hit = make_traversal(mode, self.accel)
        self._sorted_trace = self._sorted_shadow = None
        if mode == "bvh":
            self._sorted_trace = (with_ray_sorting(closest), with_ray_sorting_any(any_hit))
        elif mode == "stream":
            self._sorted_trace = make_stream_bounce_fns(self.accel)
            self._sorted_shadow = with_ray_sorting_any(any_hit)
        self.shade = shading.shading_scene(scene_dev)
        self.scene_dev = scene_dev
        self.reset()

    def set_camera(self, camera: Camera):
        self.camera = camera_to(camera, self.device)

    def reset(self):
        """Reset temporal accumulation (frame_count 0 disoccludes everything)."""
        self.state = pipeline.init_state(self.width, self.height, self.camera, self.options)

    def set_options(self, options: RenderOptions):
        """Switch options and reset accumulation (the reference rebuilding
        its pipelines with other #defines)."""
        self.use_options(options)
        self.reset()

    def use_options(self, options: RenderOptions):
        """Switch options keeping the temporal history, as flipping a
        viewer toggle mid-session does (gui_system.cpp:69-91). Only a
        history_dtype change resets, since the history changes type."""
        reset_needed = options.history_dtype != self.options.history_dtype
        self.options = options
        if reset_needed:
            self.reset()

    def panel_variants(self, base: Optional[RenderOptions] = None) -> List[RenderOptions]:
        """Every single-field flip the viewer panel offers from `base`
        (gui_system.cpp:69-91): the 4 output modes, each toggle flipped,
        bounces 0..5, and the raw-preview and direct-only combinations.
        Eager frames need no precompilation; the list names what a viewer
        may switch to."""
        base = self.options if base is None else base
        variants = [base]
        variants += [dataclasses.replace(base, output=mode) for mode in range(4)]
        variants += [dataclasses.replace(base, **{f: not getattr(base, f)})
                     for f in ("denoise", "eaw5", "gather", "taa")]
        variants += [dataclasses.replace(base, num_diffuse_bounces=b) for b in range(6)]
        variants.append(dataclasses.replace(base, denoise=False, gather=False, taa=False))
        variants.append(dataclasses.replace(base, output=1, denoise=False, gather=False,
                                            taa=False, num_diffuse_bounces=0))
        return list(dict.fromkeys(variants))

    def resize(self, width: int, height: int):
        """Change the resolution, refitting the camera sensor's height to
        the new aspect (camera_system.cpp:10-17), and reset accumulation."""
        if (width, height) == (self.width, self.height):
            return
        self.width, self.height = width, height
        s0 = self.camera.sensor_size[0]
        self.camera = self.camera._replace(sensor_size=torch.stack([s0, s0 * height / width]))
        self.reset()

    # -- frame ------------------------------------------------------------

    def render_async(self, camera: Optional[Camera] = None) -> torch.Tensor:
        """Queue one frame and advance the state without waiting for the
        device. Returns the display image [H,W,3] as a device tensor."""
        if self.shade is None:
            raise RuntimeError("set_scene() first")
        if camera is not None:
            self.set_camera(camera)
        closest, any_hit = self._trace
        bounce = bounce_any = None
        if self._sorted_trace is not None and self.options.sort_bounce_rays:
            bounce, bounce_any = self._sorted_trace
            any_hit = self._sorted_shadow or any_hit
        display, self.state = pipeline.render_frame(
            self.shade, closest, any_hit, self.camera, self.state, self.settings,
            self.noise, self.width, self.height, self.options,
            closest_bounce_fn=bounce, any_bounce_fn=bounce_any)
        return display

    def render_loop(self, frames: int, camera: Optional[Camera] = None, chunk: int = 16,
                    accumulate: bool = False) -> torch.Tensor:
        """Render `frames` frames with the camera held, queued without a
        wait, and return a device tensor: the last frame's display, or with
        `accumulate` the mean display of the last chunk of `chunk` frames
        (the offline antialiasing semantics: each frame jitters its
        subpixel sample). When `frames % chunk` is not 0 the last chunk is
        the remainder, and its mean is returned."""
        frames, chunk = int(frames), max(int(chunk), 1)
        if frames <= 0:
            raise ValueError("frames must be >= 1")
        if camera is not None:
            self.set_camera(camera)
        display = None
        for start in range(0, frames, chunk):
            n = min(chunk, frames - start)
            acc = None
            for _ in range(n):
                d = self.render_async()
                acc = d if acc is None else acc + d
            display = acc / float(n) if accumulate else d
        return display

    def render(self, camera: Optional[Camera] = None) -> np.ndarray:
        """Render one frame, advance the state, return the display image
        [H,W,3] as a numpy array."""
        return self.render_async(camera).cpu().numpy()

    def save_png(self, path: str, image: Optional[np.ndarray] = None):
        from PIL import Image

        img = image if image is not None else self.render()
        # row 0 of the framebuffer is sensor -v (camera.h:44-58): flip for display
        arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)[::-1]
        Image.fromarray(arr).save(path)
