"""Carry values from the JAX package (or any numpy source) into the port:
numpy arrays in, port tensors out, and back for the frame state. The
objects taken in only need the fields of their port counterparts, so a
JAX host Scene, a Camera of numpy arrays or a FrameState of `np.asarray`
leaves all convert."""

from __future__ import annotations

import numpy as np
import torch

from .ops.camera import Camera
from .ops.stream import StreamBVH
from .render.pipeline import FrameState
from .render.settings import Settings, make_settings
from .scene.scene import Scene


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def _signed(x: np.ndarray) -> np.ndarray:
    """uint32 -> int32 with the same bits (torch's uint32 has few ops);
    other arrays unchanged."""
    return x.view(np.int32) if x.dtype == np.uint32 else x


def scene_from_numpy(scene, device="cpu") -> Scene:
    """A Scene of numpy arrays -> the same Scene of tensors on `device`.
    Either atlas form carries over: the float32 quad atlas, or the rgba8
    atlas (uint32 in the JAX package) as int32 of the same bits."""
    return Scene(*[_tensor(_signed(np.array(getattr(scene, f))), device) for f in Scene._fields])


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


def stream_bvh_from_numpy(boxes, tris, n_blocks: int, block_tris: int, device="cpu"):
    """The JAX package's StreamBVH arrays (numpy) -> the port's StreamBVH:
    boxes [8, Bp] (rows lo xyz, hi xyz, valid; a block a lane) and tris
    [B, rows, 128] (8 triangles a row as v0, e1, e2, id + 1) into the
    card's float4 layout of ops/stream.py."""
    boxes = np.asarray(boxes, np.float32)
    rec = np.asarray(tris, np.float32)[:, :, :80].reshape(n_blocks * block_tris, 10)
    out_boxes = np.zeros((n_blocks, 8), np.float32)
    out_boxes[:, 0:3] = boxes[0:3, :n_blocks].T
    out_boxes[:, 3] = boxes[6, :n_blocks]
    out_boxes[:, 4:7] = boxes[3:6, :n_blocks].T
    slots = np.zeros((n_blocks * block_tris, 12), np.float32)
    for f in range(3):  # v0, e1, e2
        slots[:, 4 * f:4 * f + 3] = rec[:, 3 * f:3 * f + 3]
    slots.view(np.int32)[:, 3] = rec[:, 9].astype(np.int32) - 1
    return StreamBVH(_tensor(out_boxes, device), _tensor(slots, device), n_blocks, block_tris)


def state_to_numpy(state: FrameState) -> FrameState:
    """The port's FrameState -> the same FrameState with numpy leaves."""
    fields = {f: getattr(state, f).cpu().numpy() for f in FrameState._fields
              if f not in ("prev_camera", "frame_count")}
    return FrameState(
        **fields,
        prev_camera=Camera(*[x.cpu().numpy() for x in state.prev_camera]),
        frame_count=int(state.frame_count),
    )
