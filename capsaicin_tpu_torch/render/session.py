"""RenderSession: the host-side orchestration of the port (the torch
counterpart of capsaicin_tpu/render/session.py): device placement, scene
upload, camera updates, the frame state and readback.

PyTorch runs eagerly, so there is no compile cache or variant
precompilation: a frame is a sequence of kernel launches on the current
stream, and `render_async` returns before the device has finished.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import convert
from ..ops.camera import Camera, camera_to, default_camera
from ..scene import textures
from . import pipeline, shading
from .settings import RenderOptions, Settings, default_settings
from .traversal import build_accel, make_traversal, resolve_mode


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
    ):
        """device: "cuda" (the default) runs the frame through the CUDA
        kernels and raises if CUDA is absent; "cpu" runs their plain
        versions. Options the port does not run yet raise here."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for the CPU path")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.width = width
        self.height = height
        self.options = options or RenderOptions()
        pipeline.check_supported(self.options)
        self.settings = settings or default_settings()
        self.traversal_mode = traversal
        self.camera = camera_to(camera or default_camera(aspect=height / width), self.device)
        self.noise = torch.from_numpy(textures.blue_noise_256()).to(self.device)
        self.scene_dev = None
        self.attr_table = None
        self.accel = None
        self._trace = None
        self.state: Optional[pipeline.FrameState] = None

    # -- scene ------------------------------------------------------------

    def set_scene(self, scene):
        """Upload a Scene of numpy arrays and build its acceleration
        structure and attribute table."""
        if np.any(np.asarray(scene.mesh_texture) >= 0):
            raise NotImplementedError("textured scenes are not ported yet (ROADMAP A8)")
        scene_dev = convert.scene_from_numpy(scene, self.device)
        mode = resolve_mode(self.traversal_mode, scene_dev.tri_v0.shape[0])
        self.accel = build_accel(scene_dev, mode)
        self._trace = make_traversal(mode, self.accel)
        self.attr_table = shading.tri_attr_table(scene_dev)
        self.scene_dev = scene_dev
        self.reset()

    def set_camera(self, camera: Camera):
        self.camera = camera_to(camera, self.device)

    def reset(self):
        """Reset temporal accumulation (frame_count 0 disoccludes everything)."""
        self.state = pipeline.init_state(self.width, self.height, self.camera, self.options)

    # -- frame ------------------------------------------------------------

    def render_async(self, camera: Optional[Camera] = None) -> torch.Tensor:
        """Queue one frame and advance the state without waiting for the
        device. Returns the display image [H,W,3] as a device tensor."""
        if self.attr_table is None:
            raise RuntimeError("set_scene() first")
        if camera is not None:
            self.set_camera(camera)
        closest, any_hit = self._trace
        display, self.state = pipeline.render_frame(
            self.attr_table, closest, any_hit, self.camera, self.state, self.settings,
            self.noise, self.width, self.height, self.options)
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
