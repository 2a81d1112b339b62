"""capsaicin_tpu_torch: the capsaicin-tpu renderer on PyTorch, with its
kernels written in CUDA C++ for NVIDIA Hopper (H100).

The JAX package `capsaicin_tpu` is the reference this port is held
against; this package imports no JAX. Module names follow the JAX
package's, so each counterpart is found under the same path, and the
public API is the same nine-function facade of the reference
(capsaicin.h:25-36) in Python form.

Quick start::

    import capsaicin_tpu_torch as cap

    cap.init()  # the GPU; cap.init("cpu") for the plain versions
    session = cap.create_session(1920, 1080)  # default RenderOptions
    session.set_scene(cap.load_scene_obj("scene.obj"))
    image = session.render()  # [H,W,3] numpy, gamma-encoded
"""

from .ops.camera import Camera, default_camera
from .scene.scene import Scene, build_scene, load_scene_obj, merge_scenes

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Scene",
    "__version__",
    "build_scene",
    "create_session",
    "default_camera",
    "init",
    "load_scene_obj",
    "merge_scenes",
    "shutdown",
]

_initialized = False


def init(device="cuda"):
    """Engine bring-up (capsaicin::Init, capsaicin.cpp:20-46): reads the
    blue-noise table and, on "cuda" (the default), builds and loads the
    kernel library. Raises without CUDA unless given "cpu"."""
    global _initialized
    import torch

    from . import kernels
    from .scene import textures

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for the CPU path")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    textures.blue_noise_256()
    if device.type == "cuda":
        kernels.load()
    _initialized = True


def shutdown():
    """capsaicin::Shutdown (capsaicin.cpp:94-103)."""
    global _initialized
    _initialized = False


def create_session(width: int = 1920, height: int = 1080, **kwargs):
    """A RenderSession (InitRenderSession, capsaicin.cpp:48-63; see
    render.session); device="cuda" by default."""
    from .render.session import RenderSession

    return RenderSession(width=width, height=height, **kwargs)
