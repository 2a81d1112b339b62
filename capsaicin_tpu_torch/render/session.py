"""RenderSession: the host-side orchestration of the port (the torch
counterpart of capsaicin_tpu/render/session.py): device placement, scene
upload and accumulation, camera updates, the frame state, its checkpoint,
per-pass timings and readback.

PyTorch runs eagerly, so there is no compile cache: a frame is a sequence
of kernel launches on the current stream, and `render_async` returns
before the device has finished. An options change takes effect on the
next frame; `precompile_variants` builds the kernel library and runs a
frame of each variant once, so that the first flip to it does not hitch.

With a mesh (parallel.sharding.make_mesh) one session drives several
devices: the state is split over image rows, the scene and its
acceleration structure are replicated, and each frame runs its passes
block by block (pipeline.render_frame_sharded).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import convert, kernels
from ..ops.camera import Camera, camera_to, default_camera
from ..parallel import sharding as sh
from ..scene import textures
from . import pipeline, shading
from .profiling import span
from .settings import RenderOptions, Settings, default_settings
from .traversal import (build_accel, make_bounce_fns, make_stream_bounce_fns, make_traversal,
                        resolve_mode, with_ray_sorting, with_ray_sorting_any)


class RenderSession:
    def __init__(
        self,
        width: int = 1920,
        height: int = 1080,
        options: Optional[RenderOptions] = None,
        settings: Optional[Settings] = None,
        traversal: str = "auto",
        camera: Optional[Camera] = None,
        device=None,
        stream_block_tris: Optional[int] = None,
        mesh: Optional[sh.Mesh] = None,
    ):
        """device: "cuda" (the default) runs the frame through the CUDA
        kernels and raises if CUDA is absent; "cpu" runs their plain
        versions. stream_block_tris: the block size of traversal="stream"
        (None: ops.stream.BLOCK_TRIS, 32).

        mesh: a parallel.sharding.Mesh, to render over several devices
        (the session's device is then the mesh's first, and `device`, if
        given, must be of its type): the per-pixel state and the frame are
        split over image rows, the scene replicated on each distinct
        device, each block traced and filtered on its device with the
        stencils' halo exchanged, and the display gathered on the first
        device. `height` must divide by the mesh size, as in the JAX
        package; blocks may then still be uneven (their boundaries are at
        even rows, parallel.sharding.row_sharding). Example:

            mesh = capsaicin_tpu_torch.parallel.make_mesh(["cuda:0"] * 2)
            session = RenderSession(1920, 1080, mesh=mesh)
        """
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh[0].type:
                raise ValueError(f"device {device} is not of the mesh's type {mesh[0].type}")
            device = mesh[0]
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for the CPU path")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._set_size(width, height)
        self.options = options or RenderOptions()
        self.settings = settings or default_settings()
        self.traversal_mode = traversal
        self.stream_block_tris = stream_block_tris
        self.camera = camera_to(camera or default_camera(aspect=height / width), self.device)
        self.noise = torch.from_numpy(textures.blue_noise_256()).to(self.device)
        self.scene_dev = None
        self.scene_host = None
        self.shade: Optional[shading.ShadingScene] = None
        self.accel = None
        self._trace = None
        self._sorted_trace = None
        self._sorted_shadow = None
        self._replicas = {}  # mesh sessions: {device: (ShadingScene, accel, noise)}
        self._block_traces = {}  # mesh sessions: {(device, rows): traces}
        self.state: Optional[pipeline.FrameState] = None
        self._timings: Dict[str, float] = {}
        # the variants precompile_variants has run a frame of, since the
        # last set_scene or resize
        self._warm = set()
        self._precompile_lock = threading.Lock()
        self._bg_kick_lock = threading.Lock()
        self._bg_thread = None
        self._bg_pending = self._BG_IDLE
        self.bg_served = None  # the last request the background worker took

    # -- scene ------------------------------------------------------------

    def set_scene(self, scene):
        """Upload a Scene of numpy arrays (textured or not; either atlas
        form) and build its acceleration structure and shading tables."""
        scene_dev = convert.scene_from_numpy(scene, self.device)
        self._mode = mode = resolve_mode(self.traversal_mode, scene_dev.tri_v0.shape[0])
        self.accel = build_accel(scene_dev, mode, self.stream_block_tris)
        self._trace, self._sorted_trace, self._sorted_shadow = self._traces(
            self.accel, lambda: (self.width, self.height))
        self.shade = shading.shading_scene(scene_dev)
        self.scene_dev = scene_dev
        self.scene_host = scene
        if self.mesh is not None:
            # one replica a distinct device; the BVH is built once, on the host
            self._replicas = sh.replicated(self.mesh, (self.shade, self.accel, self.noise))
            self._block_traces = {}
        self._warm.clear()
        self.reset()

    def _traces(self, accel, pixels):
        """(closest, any) of the scene's mode on `accel`, the pixel-order
        ones knowing the frame's (W, H) from `pixels`; the bounce-ray
        (closest, any) of the modes that have their own, else None; and the
        sorted direct shadow any-hit of the stream mode, else None. As the
        JAX package: the BVH and wavefront modes trace bounce rays sorted
        (so not in pixel order) while options.sort_bounce_rays holds; the
        stream mode then also sorts the direct shadow rays (by octant) and
        balances the bounce closest-hit trace; the cull mode always traces
        bounce rays through its incoherent funnel, sorted
        (traversal.make_bounce_fns)."""
        mode = self._mode
        closest, any_hit = make_traversal(mode, accel)
        sorted_trace = sorted_shadow = None
        if mode in ("bvh", "wavefront"):
            sorted_trace = (with_ray_sorting(closest), with_ray_sorting_any(any_hit))
        elif mode == "stream":
            sorted_trace = make_stream_bounce_fns(accel)
            sorted_shadow = with_ray_sorting_any(any_hit)
        elif mode == "cull":
            sorted_trace = make_bounce_fns(accel)
        return make_traversal(mode, accel, pixels), sorted_trace, sorted_shadow

    def _pick(self, traces, options):
        """(closest, any, bounce closest, bounce any) of `_traces` for
        `options`: the cull mode's bounce functions whatever
        sort_bounce_rays says, the others' only while it holds."""
        (closest, any_hit), sorted_trace, sorted_shadow = traces
        bounce = bounce_any = None
        if sorted_trace is not None and (options.sort_bounce_rays or self._mode == "cull"):
            bounce, bounce_any = sorted_trace
            any_hit = sorted_shadow or any_hit
        return closest, any_hit, bounce, bounce_any

    def _set_size(self, width: int, height: int):
        """The resolution, and a mesh session's frame step over its row
        blocks (the height must divide by the mesh size)."""
        if self.mesh is not None and height % self.mesh.size != 0:
            raise ValueError(f"height {height} must divide by mesh size {self.mesh.size}")
        self.width, self.height = width, height
        self._step = None if self.mesh is None else sh.build_sharded_step(self.mesh, height)

    @property
    def sharding(self) -> Optional[sh.RowSharding]:
        """The row blocks of a mesh session's frame (None without a mesh)."""
        return None if self._step is None else self._step.keywords["sharding"]

    def _block_trace(self, block):
        """`_traces` of a mesh session's block, on its device's replica."""
        key = (block.device, block.rows)
        if key not in self._block_traces:
            self._block_traces[key] = self._traces(
                self._replicas[block.device][1], lambda: (self.width, block.rows))
        return self._block_traces[key]

    def add_scene(self, scene):
        """Append another Scene's meshes to the session's geometry and
        rebuild its acceleration structure: a repeated LoadSceneFromOBJ,
        which adds to the reference's persistent pools
        (asset_load_system.cpp:162-255, capsaicin.cpp:65-73). The first
        call is set_scene. Resets accumulation, as set_scene does."""
        from ..scene.scene import merge_scenes

        if self.scene_host is None:
            self.set_scene(scene)
        else:
            self.set_scene(merge_scenes(self.scene_host, scene))

    def set_camera(self, camera: Camera):
        self.camera = camera_to(camera, self.device)

    def reset(self):
        """Reset temporal accumulation (frame_count 0 disoccludes everything)."""
        self.state = self._init_state(self.options)

    def _init_state(self, options):
        """A fresh FrameState for `options`, split into row blocks on a mesh."""
        state = pipeline.init_state(self.width, self.height, self.camera, options)
        return state if self.mesh is None else sh.shard_frame_state(self.mesh, state, self.height)

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

    def precompile_variants(self, variants=None) -> int:
        """Make the first frame of each variant (default: panel_variants())
        as fast as the next: build the kernel library (a CUDA session),
        then run one frame of every variant not run here before, from the
        session's state, without advancing it. Returns how many variants
        were new (0 on a repeat). Needs a scene."""
        if self.shade is None:
            raise RuntimeError("set_scene() first")
        variants = self.panel_variants() if variants is None else variants
        with self._precompile_lock:
            if self.device.type == "cuda":
                kernels.load()
            n = 0
            for opt in dict.fromkeys(variants):
                if opt in self._warm:
                    continue
                state = self.state
                if opt.history_dtype != self.options.history_dtype:
                    state = self._init_state(opt)
                self.frame(options=opt, state=state)
                self._warm.add(opt)
                n += 1
            self._synchronize()
            return n

    _BG_IDLE = object()  # no background request pending

    def precompile_background(self, variants=None) -> threading.Thread:
        """Build the kernel library on a daemon thread while the session
        renders on: a frame there would race the render loop on the
        device, so the frames of precompile_variants are left to the
        caller's thread. Kicks coalesce onto one worker, which takes the
        latest request (`bg_served`) until none is pending. Returns the
        thread (join() to wait)."""
        with self._bg_kick_lock:
            self._bg_pending = variants
            if self._bg_thread is not None:
                return self._bg_thread

            def worker():
                while True:
                    with self._bg_kick_lock:
                        pending = self._bg_pending
                        if pending is self._BG_IDLE:
                            # retire inside the lock: a kick that saw a
                            # live worker is sure to be taken
                            self._bg_thread = None
                            return
                        self._bg_pending = self._BG_IDLE
                    with self._precompile_lock:
                        if self.device.type == "cuda":
                            kernels.load()
                        self.bg_served = pending

            t = threading.Thread(target=worker, daemon=True)
            self._bg_thread = t
            t.start()
            return t

    def resize(self, width: int, height: int):
        """Change the resolution, refitting the camera sensor's height to
        the new aspect (camera_system.cpp:10-17), and reset accumulation.
        On a mesh the height must divide by its size."""
        if (width, height) == (self.width, self.height):
            return
        self._set_size(width, height)
        s0 = self.camera.sensor_size[0]
        self.camera = self.camera._replace(sensor_size=torch.stack([s0, s0 * height / width]))
        self._warm.clear()
        self.reset()

    # -- frame ------------------------------------------------------------

    def frame(self, options: Optional[RenderOptions] = None, state=None, timer=None,
              collect_aux: bool = False):
        """Queue one frame from `state` (default: the session's) with
        `options` (default: the session's) and the session's camera;
        returns (display, next FrameState[, PassOutputs with collect_aux])
        and leaves the session as it was. timer: pipeline.render_frame's
        per-pass timer hook. On a mesh the states are row-sharded and the
        display and PassOutputs lie on the mesh's first device."""
        if self.shade is None:
            raise RuntimeError("set_scene() first")
        options = self.options if options is None else options
        state = self.state if state is None else state
        if self.mesh is not None:
            return self._step(
                {d: r[0] for d, r in self._replicas.items()},
                [self._pick(self._block_trace(b), options) for b in self.sharding.blocks],
                self.camera, state, self.settings, {d: r[2] for d, r in self._replicas.items()},
                self.width, self.height, options, collect_aux=collect_aux, timer=timer)
        closest, any_hit, bounce, bounce_any = self._pick(
            (self._trace, self._sorted_trace, self._sorted_shadow), options)
        return pipeline.render_frame(
            self.shade, closest, any_hit, self.camera, state, self.settings, self.noise,
            self.width, self.height, options, collect_aux=collect_aux,
            closest_bounce_fn=bounce, any_bounce_fn=bounce_any, timer=timer)

    def render_async(self, camera: Optional[Camera] = None) -> torch.Tensor:
        """Queue one frame and advance the state without waiting for the
        device. Returns the display image [H,W,3] as a device tensor."""
        if self.shade is None:
            raise RuntimeError("set_scene() first")
        if camera is not None:
            self.set_camera(camera)
        with span("session.queue"):  # the host issuing the frame's launches
            display, self.state = self.frame()
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
        [H,W,3] as a numpy array. Its host seconds up to the finished
        frame, before the readback, go to timings["frame"]."""
        t0 = time.perf_counter()
        display = self.render_async(camera)
        self._synchronize()
        self._timings["frame"] = time.perf_counter() - t0
        with span("session.readback"):
            return display.cpu().numpy()

    @property
    def devices(self) -> List[torch.device]:
        """The session's distinct devices (the mesh's, or its one)."""
        return [self.device] if self.mesh is None else sh.distinct(self.mesh)

    def _synchronize(self):
        """Wait for the work queued on each CUDA device of the session."""
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- observability ----------------------------------------------------

    @property
    def timings(self) -> Dict[str, float]:
        """The last render()'s host seconds under "frame", as the
        reference's named timestamp table (render_system.cpp:271-281)."""
        return dict(self._timings)

    def measure_pass_timings(self, iters: int = 3, method: str = "inframe") -> Dict[str, float]:
        """Seconds of each pass under the reference's timer names, and of
        the whole frame (render.profiling.measure_pass_timings): "inframe"
        times the passes of one frame with CUDA events, "isolated" syncs
        around each pass. The state does not advance."""
        from . import profiling

        return profiling.measure_pass_timings(self, iters=iters, method=method)

    # -- checkpoint / resume ----------------------------------------------

    def save_state(self, path: str):
        """Write the temporal state (histories, previous G-buffer, previous
        camera as cam_0.., frame counter) to an .npz with the JAX
        package's keys, shapes and dtypes, so either package resumes it.
        A mesh session writes the whole image's state, as the JAX package's."""
        state = self.state
        if self.mesh is not None:
            state = sh.gather_frame_state(state, "cpu")
        st = convert.state_to_numpy(state)
        np.savez_compressed(
            path,
            **{f: getattr(st, f) for f in pipeline.FrameState._fields
               if f not in ("prev_camera", "frame_count")},
            frame_count=np.asarray(st.frame_count, np.int32),
            **{f"cam_{i}": np.asarray(x, np.float32) for i, x in enumerate(st.prev_camera)},
        )

    def load_state(self, path: str):
        """Resume the temporal state that save_state (of either package, with
        or without a mesh) wrote; a mesh session splits it into row blocks."""
        with np.load(path) as data:
            st = {f: data[f] for f in data.files}
        cam = Camera(*[st[f"cam_{i}"] for i in range(len(Camera._fields))])
        self.state = convert.state_from_numpy(
            pipeline.FrameState(**{f: st[f] for f in pipeline.FrameState._fields
                                   if f not in ("prev_camera", "frame_count")},
                                prev_camera=cam, frame_count=st["frame_count"]),
            self.device)
        if self.mesh is not None:
            self.state = sh.shard_frame_state(self.mesh, self.state, self.height)

    def save_png(self, path: str, image: Optional[np.ndarray] = None):
        from PIL import Image

        img = image if image is not None else self.render()
        # row 0 of the framebuffer is sensor -v (camera.h:44-58): flip for display
        arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)[::-1]
        Image.fromarray(arr).save(path)
