"""Multi-device rendering: the frame's per-pixel state split over image rows
across a mesh of devices. The torch counterpart of
capsaicin_tpu/parallel/sharding.py.

A mesh is an ordered tuple of torch devices of one type, repeats allowed:
n x "cpu" in the tests, n x cuda:0 on one GPU, n distinct GPUs. One
process drives every device, as the JAX package's single controller drives
a `jax.sharding.Mesh`; there is no multi-process backend.

  * the framebuffer and every per-pixel state are split over image rows
    (`row_sharding`): block i holds rows [start, stop) on the mesh's
    device i, with boundaries at even rows, so that the 2x2 interleave
    phases and the half-resolution rows of lowres_indirect stay whole in
    a block (and at multiples of 4 where the height allows, for K7's 8x4
    pixel tiles)
  * the scene and the acceleration structure are replicated, one copy
    per distinct device (`replicated`, `shard_scene`)
  * each block's rays are traced on its device by the unchanged
    single-device trace (`shard_trace` does it for a flat ray batch)
  * a stencil runs unchanged on each block extended by `reach` rows of
    its neighbours, and the halo is cropped (`halo_map`): the halo
    exchange that XLA's SPMD partitioner inserts for the JAX package
  * the display is gathered on the mesh's first device, the frame loop's
    one collective besides the previous frame's buffers, which the
    reprojection reads anywhere (render.pipeline.render_frame_sharded)

A row-sharded value is a list with one tensor per block, in row order.
"""

from __future__ import annotations

import copy
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

ROWS = "rows"
EDGES = ("zero", "clamp")


class Mesh(tuple):
    """An ordered tuple of torch.devices of one type; repeats allowed. Its
    one axis is the image rows, as the JAX package's mesh axis ROWS."""

    axis_names = (ROWS,)

    @property
    def size(self) -> int:
        return len(self)

    @property
    def devices(self) -> tuple:
        return tuple(self)


def distinct(devices) -> List[torch.device]:
    """The devices in first-seen order, each once."""
    return list(dict.fromkeys(devices))


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `devices` (torch.device or names, in order, repeats
    allowed), by default every visible CUDA device. Raises where CUDA is
    absent and a CUDA device is asked for (the default included: there is
    no fallback to the CPU), on an empty list, on a mesh that mixes device
    types and on a device type other than "cuda" and "cpu"."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices "
                               "(e.g. ['cpu'] * 8) for a mesh of CPU devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    kinds = sorted({d.type for d in devs})
    if len(kinds) != 1:
        raise ValueError(f"make_mesh: a mesh is of one device type, got {kinds}")
    if kinds[0] == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available")
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
                for d in devs]
        bad = [str(d) for d in devs if d.index >= count]
        if bad:
            raise ValueError(f"make_mesh: {bad} not among the {count} CUDA devices")
    elif kinds[0] == "cpu":
        devs = [torch.device("cpu")] * len(devs)
    else:
        raise ValueError(f"make_mesh: unsupported device type {kinds[0]!r}")
    return Mesh(devs)


class Block(NamedTuple):
    """Image rows [start, stop) on `device`."""

    device: torch.device
    start: int
    stop: int

    @property
    def rows(self) -> int:
        return self.stop - self.start


class RowSharding(NamedTuple):
    """A height's rows split into blocks over a mesh (`row_sharding`);
    `home` is the mesh's first device, where the display is gathered."""

    height: int
    blocks: tuple
    home: torch.device

    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.blocks)


def row_sharding(mesh: Mesh, height: int) -> RowSharding:
    """Split `height` rows over the mesh in units of 4 rows where there are
    as many as devices, else of 2: block i takes the units [floor(i U / n),
    floor((i + 1) U / n)) of the U = height // unit, the last block also
    the rows left over. Blocks may be uneven; every boundary is at an even
    row (the interleave phases stay whole), and at a multiple of 4 where it
    can be (K7 takes a block's pixel-order rays as 8x4 tiles when its rows
    are a multiple of 4). A device whose block would be empty (fewer units
    than devices) gets none."""
    if height < 1:
        raise ValueError(f"row_sharding: height {height}")
    n = mesh.size
    unit = 4 if height // 4 >= n else 2
    units = height // unit
    cuts = [unit * (i * units // n) for i in range(n)] + [height]
    return RowSharding(height, tuple(Block(d, a, b) for d, a, b in zip(mesh, cuts, cuts[1:])
                                     if b > a), mesh[0])


def shard_rows(sharding: RowSharding, x: torch.Tensor) -> list:
    """x [height, ...] -> its row blocks, each on its block's device."""
    if x.shape[0] != sharding.height:
        raise ValueError(f"shard_rows: {x.shape[0]} rows, expected {sharding.height}")
    return [x[b.start:b.stop].to(b.device) for b in sharding.blocks]


def gather_rows(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Row blocks -> the whole [height, ...] tensor on `device` (one block
    is returned as it is, moved if it lies elsewhere)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], 0)


def to_device(x, device):
    """`x` with every tensor in it on `device`: tensors, named tuples,
    lists, tuples, dicts and objects holding tensors as attributes (the
    acceleration structures); anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_device(v, device) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if hasattr(x, "__dict__") and any(isinstance(v, torch.Tensor) for v in vars(x).values()):
        y = copy.copy(x)
        for k, v in vars(x).items():
            setattr(y, k, to_device(v, device))
        return y
    return x


def replicated(mesh, tree) -> dict:
    """{device: tree on device} for each distinct device of the mesh (or
    of a RowSharding's blocks): n blocks on one device share one copy."""
    return {d: to_device(tree, d) for d in distinct(mesh.devices)}


def shard_scene(mesh, scene) -> dict:
    """The scene replicated across the mesh (`replicated`)."""
    return replicated(mesh, scene)


def shard_frame_state(mesh: Mesh, state, height: int):
    """A FrameState (any named tuple) with every tensor of `height` rows
    split into the mesh's row blocks; other fields (the previous camera,
    the frame count) as they are."""
    sharding = row_sharding(mesh, height)
    return type(state)(*[
        shard_rows(sharding, v) if isinstance(v, torch.Tensor) and v.ndim >= 1
        and v.shape[0] == height else v for v in state])


def gather_frame_state(state, device):
    """The inverse of shard_frame_state: every row-sharded field gathered
    into one tensor on `device`."""
    return type(state)(*[gather_rows(v, device) if isinstance(v, list) else v for v in state])


def shard_trace(mesh: Mesh, accels: dict, select: Callable) -> Callable:
    """A trace function of the standard signature fn(origins [N,3],
    dirs [N,3], tmin, tmax) that cuts the ray batch into mesh.size
    contiguous parts and traces part i on the mesh's device i with
    select(accels[device]), the unchanged single-device trace function on
    that device's replica; results come back on the rays' device, in the
    caller's order. tmax (a scalar or per-ray [N]) is cut with the rays.
    A sorting wrapper inside `select` sorts per part, as the JAX package's
    shard_map does: locality where the rays form packets, no cross-device
    sort. The mesh session does not call it: a frame's rays are already
    split by row block, and each block is traced by trace functions that
    know its (W, rows) (RenderSession._block_trace)."""

    def fn(origins, dirs, tmin, tmax):
        n, home = origins.shape[0], origins.device
        tmx = torch.as_tensor(tmax, dtype=torch.float32, device=home).expand(n)
        parts = [p for p in zip(mesh, *(torch.tensor_split(x, mesh.size) for x in
                                        (origins, dirs, tmx))) if p[1].shape[0] > 0]
        outs = [select(accels[dev])(o.to(dev), d.to(dev), tmin, t.to(dev))
                for dev, o, d, t in parts or [(mesh[0], origins, dirs, tmx)]]
        if isinstance(outs[0], dict):
            return {k: gather_rows([o[k] for o in outs], home) for k in outs[0]}
        return gather_rows(outs, home)

    return fn


def halo_blocks(parts: Sequence[torch.Tensor], reach: int, edge: str = "zero") -> list:
    """Each row block extended by `reach` rows of its neighbours, on its
    own device: from as many blocks as it takes when a block is shorter
    than the reach (multi-hop), and past the image's top and bottom by
    zero rows (edge "zero") or copies of the edge row ("clamp")."""
    if edge not in EDGES:
        raise ValueError(f"halo edge {edge!r}: expected one of {EDGES}")
    if reach == 0:
        return list(parts)
    out = []
    for i, part in enumerate(parts):
        dev = part.device
        rows = [part]
        for step in (-1, 1):  # above, then below
            need, j, got = reach, i + step, []
            while need > 0 and 0 <= j < len(parts):
                take = parts[j][-need:] if step < 0 else parts[j][:need]
                got.append(take.to(dev))
                need -= take.shape[0]
                j += step
            if need > 0:
                if edge == "zero":
                    pad = part.new_zeros((need,) + tuple(part.shape[1:]))
                else:
                    pad = (parts[0][:1] if step < 0 else parts[-1][-1:]).to(dev)
                    pad = pad.expand((need,) + tuple(part.shape[1:]))
                got.append(pad)
            rows = got[::-1] + rows if step < 0 else rows + got
        out.append(torch.cat(rows, 0))
    return out


def halo_map(mesh, fn: Callable, reach: int, *row_blocks, edge: str = "zero") -> list:
    """Run a row stencil `fn` per block with an explicit halo exchange:
    each of `row_blocks` (a row-sharded value: one tensor per block of
    the mesh, or of a RowSharding's blocks, on that block's device) is
    extended by `reach` rows (`halo_blocks`), the UNCHANGED `fn` runs on
    each block's extended arrays, and its result (a tensor or a tuple of
    them) is cropped back to the block's rows. Returns one result per
    block. One block is the whole image: `fn` runs on it as it is, and its
    own edge handling is the halo's.

    One exchange covers a chain of stencils when `reach` is the sum of
    their reaches: the kept rows depend only on taps whose intermediate
    values are exact at every stage. Edge "zero" is what the K3-K6
    stencils need: every tap of depth < 1e-5 is rejected, and a zero row
    has depth 0, as the kernels' own zero padding does. Edge "clamp" is
    for a stencil that replicates the image's edge row (TAA's AABB)."""
    devices = tuple(mesh.devices)
    for blocks in row_blocks:
        if len(blocks) != len(devices) or any(b.device != d for b, d in zip(blocks, devices)):
            raise ValueError("halo_map: a row-sharded value does not match the mesh's blocks")
    if len(devices) == 1:
        return [fn(*[blocks[0] for blocks in row_blocks])]
    extended = [halo_blocks(blocks, reach, edge) for blocks in row_blocks]
    out = []
    for i, block in enumerate(row_blocks[0]):
        rows = block.shape[0]
        res = fn(*[ext[i] for ext in extended])
        crop = lambda y: y[reach:reach + rows]  # noqa: E731
        out.append(tuple(crop(y) for y in res) if isinstance(res, tuple) else crop(res))
    return out


def build_sharded_step(mesh: Mesh, height: int) -> Callable:
    """The mesh's frame step for images of `height` rows:
    render.pipeline.render_frame_sharded with the row sharding bound. It
    takes and returns a FrameState split into row blocks
    (`shard_frame_state`) and returns the display gathered on the mesh's
    first device. The mesh session holds this step, made once per
    resolution."""
    import functools

    from ..render.pipeline import render_frame_sharded

    return functools.partial(render_frame_sharded, sharding=row_sharding(mesh, height))


def all_max(values: Sequence[torch.Tensor]) -> list:
    """The max over the mesh of each block's 0-d `values`, on each block's
    device, computed on the devices (no host sync): the frame's one global
    reduction (the static-camera test of the reprojection)."""
    if len(values) == 1:
        return list(values)
    home = values[0].device
    total = torch.stack([v.to(home) for v in values]).max()
    return [total.to(v.device) for v in values]
