"""The frame function and its state: the torch counterpart of
capsaicin_tpu/render/pipeline.py (RaytracingSystem::Run's pass sequence,
raytracing_system.cpp:230-318, and its ping-pong histories).

`render_frame` consumes the previous FrameState and returns the next. It
runs eagerly: every pass queues its work on the current stream, and no
value is read back to the host, so the caller decides when to wait.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, NamedTuple

import torch

from ..ops.camera import Camera
from . import passes, shading
from .settings import RenderOptions, Settings


# The frame's passes, each under a profiler range of this name
# (render.profiling reads them; outside a profiler a range costs ~1 us).
PASS_NAMES = ("trace_primary", "direct_lighting", "indirect_gi", "spatial_gather",
              "reproject", "svgf_accumulate", "denoise", "combine_taa", "composite")


def _span(name: str):
    return torch.profiler.record_function(name)


def _timed(timer, name: str):
    """timer(name), a per-pass timer of render.profiling, or nothing."""
    return nullcontext() if timer is None else timer(name)


class FrameState(NamedTuple):
    """Persistent per-frame state (the reference's ping-pong textures,
    raytracing_system.cpp:466-575). `frame_count` is a host int, so the
    per-frame sample index and light angle cost no device sync."""

    color_history: torch.Tensor  # [H,W,4] rgb + variance
    moments_history: torch.Tensor  # [H,W,4] m1, m2, 0, history_length
    combined_history: torch.Tensor  # [H,W,3]
    prev_nd_oct: torch.Tensor  # [H,W,2]
    prev_nd_inst: torch.Tensor  # [H,W] i32
    prev_nd_depth: torch.Tensor  # [H,W]
    prev_camera: Camera
    frame_count: int


class PassOutputs(NamedTuple):
    """Intermediate images of one frame, for debugging and tests."""

    gbuffer_bary: torch.Tensor
    gbuffer_prim: torch.Tensor
    direct: torch.Tensor
    albedo: torch.Tensor
    nd_oct: torch.Tensor
    nd_depth: torch.Tensor
    indirect_raw: torch.Tensor
    indirect_gathered: torch.Tensor
    denoised: torch.Tensor
    combined: torch.Tensor


def history_dtype(options: RenderOptions) -> torch.dtype:
    return {"float32": torch.float32, "float16": torch.float16}[options.history_dtype]


def init_state(width: int, height: int, camera: Camera, options: RenderOptions) -> FrameState:
    dtype = history_dtype(options)
    dev = camera.position.device
    return FrameState(
        color_history=torch.zeros((height, width, 4), dtype=dtype, device=dev),
        moments_history=torch.zeros((height, width, 4), dtype=dtype, device=dev),
        combined_history=torch.zeros((height, width, 3), dtype=dtype, device=dev),
        prev_nd_oct=torch.zeros((height, width, 2), device=dev),
        prev_nd_inst=torch.full((height, width), -1, dtype=torch.int32, device=dev),
        prev_nd_depth=torch.zeros((height, width), device=dev),
        prev_camera=Camera(*[x.clone() for x in camera]),
        frame_count=0,
    )


def render_frame(
    scene: shading.ShadingScene,
    closest_fn: Callable,
    any_fn: Callable,
    camera: Camera,
    state: FrameState,
    settings: Settings,
    noise: torch.Tensor,
    width: int,
    height: int,
    options: RenderOptions,
    collect_aux: bool = False,
    closest_bounce_fn: Callable = None,
    any_bounce_fn: Callable = None,
    timer: Callable = None,
):
    """One full frame of the scene's ShadingScene (shading.shading_scene).
    closest_bounce_fn and any_bounce_fn, where given, trace the indirect
    pass's bounce and NEE shadow rays in place of closest_fn and any_fn.
    timer, where given, is entered around each pass under the reference's
    timer name (render.profiling.PASS_NAMES; combine_taa holds two of
    them, composite none). Returns (display [H,W,3] gamma-encoded, new
    FrameState[, PassOutputs])."""
    frame_count = state.frame_count
    prev_camera = state.prev_camera
    prev_nd = {"oct": state.prev_nd_oct, "inst": state.prev_nd_inst, "depth": state.prev_nd_depth}
    combined_history = state.combined_history.float()

    # 1. primary visibility
    with _span("trace_primary"), _timed(timer, "RaytracePrimaryVisibility"):
        gb = passes.trace_primary(closest_fn, camera, width, height, frame_count)
    # 2. direct lighting + gbuffer
    with _span("direct_lighting"), _timed(timer, "RT Direct lighting"):
        direct, albedo, nd = passes.direct_lighting(
            scene, any_fn, camera, gb, width, height, frame_count, options)
    # 3. indirect diffuse GI: options.spp sample sets, each with its own
    # blue-noise seed frame_count*spp + s, summed in order and averaged
    with _span("indirect_gi"), _timed(timer, "RT Indirect diffuse"):
        spp = max(int(options.spp), 1)
        indirect = None
        for s in range(spp):
            sample = passes.indirect_gi(
                scene, closest_fn, any_fn, camera, prev_camera, gb, combined_history,
                prev_nd, noise, width, height, frame_count, options,
                noise_frame=frame_count * spp + s, closest_bounce_fn=closest_bounce_fn,
                any_bounce_fn=any_bounce_fn)
            indirect = sample if indirect is None else indirect + sample
        if spp > 1:
            indirect = indirect / spp
    # 4. spatial gather
    if options.gather:
        with _span("spatial_gather"), _timed(timer, "Spatial gather"):
            gathered = passes.spatial_gather(indirect, nd, frame_count, settings, options)
    else:
        gathered = indirect
    # shared temporal reprojection + history fetch (SVGF + TAA)
    with _span("reproject"), _timed(timer, "Reproject history"):
        rep = passes.reproject_and_fetch_history(
            camera, prev_camera, nd, prev_nd, state.color_history.float(),
            state.moments_history.float(), combined_history, width, height)
    # 5. SVGF temporal accumulation
    with _span("svgf_accumulate"), _timed(timer, "Temporal upscale"):
        color_hist, moments_hist = passes.svgf_accumulate(
            gathered, nd, rep, prev_camera, width, height, frame_count,
            settings.temporal_upscale_feedback, options)
    # 6. EAW denoise chain
    with _span("denoise"), _timed(timer, "EAW"):
        denoised = passes.denoise(color_hist, nd, moments_hist, settings, options)
    # 7. combine, 8. TAA -> new combined history
    with _span("combine_taa"):
        with _timed(timer, "Combine illumination"):
            combined = passes.combine(direct, denoised, albedo, options.output)
        if options.taa:
            with _timed(timer, "TAA"):
                combined_out = passes.taa(combined, rep, nd, width, height,
                                          settings.taa_feedback)
        else:
            combined_out = combined
    # 9. composite: exposure + gamma for display; the history stays linear
    with _span("composite"):
        display = torch.pow((combined_out * settings.exposure).clamp_min(0.0), 1.0 / 2.2)

    dtype = history_dtype(options)
    new_state = FrameState(
        color_history=color_hist.to(dtype),
        moments_history=moments_hist.to(dtype),
        combined_history=combined_out.to(dtype),
        prev_nd_oct=nd["oct"],
        prev_nd_inst=nd["inst"],
        prev_nd_depth=nd["depth"],
        prev_camera=camera,
        frame_count=frame_count + 1,
    )
    if not collect_aux:
        return display, new_state
    aux = PassOutputs(
        gbuffer_bary=gb["bary"],
        gbuffer_prim=gb["prim"],
        direct=direct,
        albedo=albedo,
        nd_oct=nd["oct"],
        nd_depth=nd["depth"],
        indirect_raw=indirect,
        indirect_gathered=gathered,
        denoised=denoised,
        combined=combined,
    )
    return display, new_state, aux
