"""Carry values from the JAX package (or any numpy source) into the port:
numpy arrays in, port tensors out, and back for the frame state. The
objects taken in only need the fields of their port counterparts, so a
JAX host Scene, a Camera of numpy arrays or a FrameState of `np.asarray`
leaves all convert."""

from __future__ import annotations

import numpy as np
import torch

from .ops.camera import Camera
from .render.pipeline import FrameState
from .render.settings import Settings, make_settings
from .scene.scene import Scene


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def scene_from_numpy(scene, device="cpu") -> Scene:
    """A Scene of numpy arrays -> the same Scene of tensors on `device`."""
    return Scene(*[_tensor(getattr(scene, f), device) for f in Scene._fields])


def camera_from_numpy(camera, device="cpu") -> Camera:
    return Camera(*[_tensor(np.asarray(x, np.float32), device) for x in camera])


def settings_from_numpy(settings) -> Settings:
    return make_settings(**{f: np.asarray(getattr(settings, f)) for f in Settings._fields})


def state_from_numpy(state, device="cpu") -> FrameState:
    """A FrameState of numpy leaves (prev_camera a Camera of arrays) -> the
    port's FrameState on `device`."""
    fields = {f: _tensor(getattr(state, f), device) for f in FrameState._fields
              if f not in ("prev_camera", "frame_count")}
    return FrameState(
        **fields,
        prev_camera=camera_from_numpy(state.prev_camera, device),
        frame_count=int(np.asarray(state.frame_count)),
    )


def state_to_numpy(state: FrameState) -> FrameState:
    """The port's FrameState -> the same FrameState with numpy leaves."""
    fields = {f: getattr(state, f).cpu().numpy() for f in FrameState._fields
              if f not in ("prev_camera", "frame_count")}
    return FrameState(
        **fields,
        prev_camera=Camera(*[x.cpu().numpy() for x in state.prev_camera]),
        frame_count=int(state.frame_count),
    )
