"""One frame of the renderer in plain torch, float32, on one device: the
pass sequence of capsaicin_tpu_torch/render/pipeline.py (RaytracingSystem::Run,
raytracing_system.cpp:230-318) over the whole image, from a FrameState to
the next. The state is the program's FrameState by field name: the
reference can start from its own `init_state` or from a copy of the
program's state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import passes
from .camera import Camera


class FrameState(NamedTuple):
    color_history: torch.Tensor  # [H,W,4] rgb + variance
    moments_history: torch.Tensor  # [H,W,4] m1, m2, 0, history_length
    combined_history: torch.Tensor  # [H,W,3]
    prev_nd_oct: torch.Tensor  # [H,W,2]
    prev_nd_inst: torch.Tensor  # [H,W] i32
    prev_nd_depth: torch.Tensor  # [H,W]
    prev_camera: Camera
    frame_count: int


def init_state(width: int, height: int, camera: Camera) -> FrameState:
    dev = camera.position.device
    return FrameState(
        color_history=torch.zeros((height, width, 4), device=dev),
        moments_history=torch.zeros((height, width, 4), device=dev),
        combined_history=torch.zeros((height, width, 3), device=dev),
        prev_nd_oct=torch.zeros((height, width, 2), device=dev),
        prev_nd_inst=torch.full((height, width), -1, dtype=torch.int32, device=dev),
        prev_nd_depth=torch.zeros((height, width), device=dev),
        prev_camera=Camera(*[x.clone() for x in camera]),
        frame_count=0,
    )


def render_frame(scene, closest_fn, any_fn, camera: Camera, state: FrameState, settings,
                 noise, width: int, height: int, options):
    """(display [H,W,3] gamma-encoded, next FrameState) of one frame.
    Every trace goes through closest_fn and any_fn; the histories are
    read in float32 whatever type they are stored in."""
    frame_count = state.frame_count
    prev = state.prev_camera
    combined_prev = state.combined_history.float()
    prev_depth = state.prev_nd_depth
    gb = passes.trace_primary(closest_fn, camera, width, height, frame_count)
    direct, albedo, nd = passes.direct_lighting(scene, any_fn, camera, gb, width, height,
                                                frame_count, options)
    spp = max(int(options.spp), 1)
    indirect = None
    for s in range(spp):
        sample = passes.indirect_gi(
            scene, closest_fn, any_fn, camera, prev, gb, combined_prev, {"depth": prev_depth},
            noise, width, height, frame_count, options, noise_frame=frame_count * spp + s,
            closest_bounce_fn=closest_fn, any_bounce_fn=any_fn, row0=0)
        indirect = sample if indirect is None else indirect + sample
    if spp > 1:
        indirect = indirect / spp
    if options.gather:
        gathered = passes.gather_filter(*passes.gather_inputs(indirect, nd, frame_count, options),
                                        settings)
    else:
        gathered = indirect
    geo = passes.reprojection(camera, prev, nd["depth"], width, height, 0)
    is_static = geo["drift"].max() < 1e-2
    packed = passes.history_packed(state.color_history.float(), state.moments_history.float(),
                                   combined_prev, prev_depth)
    rep = passes.fetch_history(geo, packed, is_static, width, height, 0)
    color_hist, moments_hist = passes.svgf_accumulate(
        gathered, nd, rep, prev, width, height, frame_count,
        settings.temporal_upscale_feedback, options, row0=0)
    if options.denoise:
        denoised = passes.stencil.denoise_chain(*passes.denoise_inputs(color_hist, nd, moments_hist),
                                                settings, options)
    else:
        denoised = color_hist
    combined = passes.combine(direct, denoised, albedo, options.output)
    if options.taa:
        aabb = passes.neighbourhood_aabb(combined, passes.taa_aabb_scale(rep))
        combined = passes.taa(combined, rep, nd, settings.taa_feedback, aabb)
    display = torch.pow((combined * settings.exposure).clamp_min(0.0), 1.0 / 2.2)
    return display, FrameState(
        color_history=color_hist, moments_history=moments_hist, combined_history=combined,
        prev_nd_oct=nd["oct"], prev_nd_inst=nd["inst"], prev_nd_depth=nd["depth"],
        prev_camera=camera, frame_count=frame_count + 1)
