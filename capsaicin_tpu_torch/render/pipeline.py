"""The frame function and its state: the torch counterpart of
capsaicin_tpu/render/pipeline.py (RaytracingSystem::Run's pass sequence,
raytracing_system.cpp:230-318, and its ping-pong histories).

`render_frame_sharded` consumes the previous FrameState and returns the
next, over a mesh of devices with the state split into row blocks
(parallel.sharding); `render_frame` is the same frame on one device, all
its rows one block. It runs eagerly: every pass queues its work on the
current stream, and no value is read back to the host, so the caller
decides when to wait.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, NamedTuple

import torch

from ..ops import resample, stencil
from ..ops.camera import Camera, camera_to
from ..parallel import sharding as sh
from . import passes, shading
from .profiling import span as _span
from .settings import RenderOptions, Settings


# The frame's passes, each under a profiler range of this name
# (render.profiling.span: outside a profiler a range costs one flag test).
PASS_NAMES = ("trace_primary", "direct_lighting", "indirect_gi", "spatial_gather",
              "reproject", "svgf_accumulate", "denoise", "combine_taa", "composite")


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
    """One full frame of the scene's ShadingScene (shading.shading_scene) on
    one device: render_frame_sharded with all the rows in one block.
    closest_bounce_fn and any_bounce_fn, where given, trace the indirect
    pass's bounce and NEE shadow rays in place of closest_fn and any_fn.
    timer, where given, is entered around each pass under the reference's
    timer name (render.profiling.PASS_NAMES; combine_taa holds two of
    them, composite none). Returns (display [H,W,3] gamma-encoded, new
    FrameState[, PassOutputs])."""
    dev = state.prev_nd_depth.device
    mesh = sh.Mesh((dev,))
    out = render_frame_sharded(
        {dev: scene}, [(closest_fn, any_fn, closest_bounce_fn, any_bounce_fn)], camera,
        sh.shard_frame_state(mesh, state, height), settings, {dev: noise}, width, height,
        options, sh.row_sharding(mesh, height), collect_aux=collect_aux, timer=timer)
    return (out[0], sh.gather_frame_state(out[1], dev)) + tuple(out[2:])


def render_frame_sharded(
    scenes: dict,
    traces: list,
    camera: Camera,
    state: FrameState,
    settings: Settings,
    noise: dict,
    width: int,
    height: int,
    options: RenderOptions,
    sharding: sh.RowSharding,
    collect_aux: bool = False,
    timer: Callable = None,
):
    """One frame over the row blocks of `sharding`, pass by pass across
    the blocks, each block's work on its device:
      scenes  {device: ShadingScene}, one replica a distinct device
      traces  per block, (closest, any, bounce closest or None, bounce any
              or None) on its device's replica, the pixel-order ones
              knowing the block's (W, rows)
      noise   {device: blue-noise table}
      state   a FrameState whose per-pixel fields are row-sharded
              (parallel.sharding.shard_frame_state)
    Every per-pixel pass runs on the block's rows with their global
    coordinates. The passes that read the previous frame anywhere (the
    bounce hit's feedback fetch, the reprojection's history) read it
    whole: it is gathered on each device once a frame. The stencils run
    with a halo exchange (parallel.sharding.halo_map): the spatial gather
    with reach 3 and the EAW chain with its sum of reaches, zero past the
    image; TAA's AABB with reach 2 and the UPSCALE2X fetch with reach 1,
    clamped. The static-camera test is one max over the mesh. One block
    (render_frame) is the whole image: no halo, no gather, nothing copied.
    Returns (display [H,W,3] on sharding.home, the next FrameState, still
    row-sharded[, PassOutputs gathered on sharding.home])."""
    blocks = sharding.blocks
    devices = sh.distinct(sharding.devices)
    frame_count = state.frame_count
    cams = {d: camera_to(camera, d) for d in devices}
    prevs = {d: camera_to(state.prev_camera, d) for d in devices}
    # the previous frame's combined colour and depth, whole on each device
    whole = {d: (sh.gather_rows(state.combined_history, d).float(),
                 sh.gather_rows(state.prev_nd_depth, d)) for d in devices}

    def each(fn):
        """[fn(i, block, its device)] over the blocks."""
        return [fn(i, b, b.device) for i, b in enumerate(blocks)]

    with _span("trace_primary"), _timed(timer, "RaytracePrimaryVisibility"):
        gb = each(lambda i, b, d: passes.trace_primary(
            traces[i][0], cams[d], width, height, frame_count, (b.start, b.stop)))
    with _span("direct_lighting"), _timed(timer, "RT Direct lighting"):
        direct, albedo, nd = zip(*each(lambda i, b, d: passes.direct_lighting(
            scenes[d], traces[i][1], cams[d], gb[i], width, height, frame_count, options)))
    with _span("indirect_gi"), _timed(timer, "RT Indirect diffuse"):
        spp = max(int(options.spp), 1)

        def indirect_of(i, b, d):
            total = None
            for s in range(spp):
                sample = passes.indirect_gi(
                    scenes[d], traces[i][0], traces[i][1], cams[d], prevs[d], gb[i], whole[d][0],
                    {"depth": whole[d][1]}, noise[d], width, height, frame_count, options,
                    noise_frame=frame_count * spp + s, closest_bounce_fn=traces[i][2],
                    any_bounce_fn=traces[i][3], row0=b.start)
                total = sample if total is None else total + sample
            return total / spp if spp > 1 else total

        indirect = each(indirect_of)
    if options.gather:
        with _span("spatial_gather"), _timed(timer, "Spatial gather"):
            inputs = each(lambda i, b, d: passes.gather_inputs(indirect[i], nd[i], frame_count,
                                                               options))
            gathered = sh.halo_map(sharding, lambda c, g: passes.gather_filter(c, g, settings),
                                   stencil.GATHER_REACH, *map(list, zip(*inputs)))
    else:
        gathered = indirect
    with _span("reproject"), _timed(timer, "Reproject history"):
        geo = each(lambda i, b, d: passes.reprojection(
            cams[d], prevs[d], nd[i]["depth"], width, height, b.start))
        is_static = [x < 1e-2 for x in sh.all_max([g["drift"].max() for g in geo])]
        packed = {d: passes.history_packed(sh.gather_rows(state.color_history, d).float(),
                                           sh.gather_rows(state.moments_history, d).float(),
                                           *whole[d]) for d in devices}
        rep = each(lambda i, b, d: passes.fetch_history(geo[i], packed[d], is_static[i], width,
                                                        height, b.start))
    with _span("svgf_accumulate"), _timed(timer, "Temporal upscale"):
        if not options.lowres_indirect:
            color_in = gathered
        elif len(blocks) > 1 and height % 2 == 0 and width % 2 == 0:
            # each block's half-resolution rows, brought to full resolution
            # with one halo row (the image's last two rows blend only at its bottom)
            color_in = [resample.upsample2x_block(x, i == len(blocks) - 1)
                        for i, x in enumerate(sh.halo_blocks(gathered, 1, "clamp"))]
        else:  # one block, or the general bilinear fetch: the whole indirect image
            color_in = each(lambda i, b, d: sh.gather_rows(gathered, d))
        color_hist, moments_hist = zip(*each(lambda i, b, d: passes.svgf_accumulate(
            color_in[i], nd[i], rep[i], prevs[d], width, height, frame_count,
            settings.temporal_upscale_feedback, options, row0=b.start)))
    with _span("denoise"), _timed(timer, "EAW"):
        if options.denoise:
            inputs = each(lambda i, b, d: passes.denoise_inputs(color_hist[i], nd[i],
                                                                moments_hist[i]))
            denoised = sh.halo_map(
                sharding, lambda *x: stencil.denoise_chain(*x, settings, options),
                stencil.chain_reach(options), *map(list, zip(*inputs)))
        else:
            denoised = list(color_hist)
    with _span("combine_taa"):
        with _timed(timer, "Combine illumination"):
            combined = each(lambda i, b, d: passes.combine(direct[i], denoised[i], albedo[i],
                                                           options.output))
        if options.taa:
            with _timed(timer, "TAA"):
                aabb = sh.halo_map(sharding, passes.neighbourhood_aabb, passes.TAA_REACH,
                                   combined, [passes.taa_aabb_scale(r) for r in rep],
                                   edge="clamp")
                combined_out = each(lambda i, b, d: passes.taa(
                    combined[i], rep[i], nd[i], settings.taa_feedback, aabb[i]))
        else:
            combined_out = combined
    with _span("composite"):
        display = sh.gather_rows([torch.pow((c * settings.exposure).clamp_min(0.0), 1.0 / 2.2)
                                  for c in combined_out], sharding.home)

    dtype = history_dtype(options)
    new_state = FrameState(
        color_history=[x.to(dtype) for x in color_hist],
        moments_history=[x.to(dtype) for x in moments_hist],
        combined_history=[x.to(dtype) for x in combined_out],
        prev_nd_oct=[x["oct"] for x in nd],
        prev_nd_inst=[x["inst"] for x in nd],
        prev_nd_depth=[x["depth"] for x in nd],
        prev_camera=camera,
        frame_count=frame_count + 1,
    )
    if not collect_aux:
        return display, new_state
    whole_of = lambda parts: sh.gather_rows(parts, sharding.home)  # noqa: E731
    aux = PassOutputs(
        gbuffer_bary=whole_of([g["bary"] for g in gb]),
        gbuffer_prim=whole_of([g["prim"] for g in gb]),
        direct=whole_of(direct),
        albedo=whole_of(albedo),
        nd_oct=whole_of([x["oct"] for x in nd]),
        nd_depth=whole_of([x["depth"] for x in nd]),
        indirect_raw=whole_of(indirect),
        indirect_gathered=whole_of(gathered),
        denoised=whole_of(denoised),
        combined=whole_of(combined),
    )
    return display, new_state, aux
