"""K10's launch plan (ops/stream.launch_plan, a host function) and the
plain stream traversal on a scene of more than 16,384 blocks, on the CPU.

The plan must take every scene size: a fixed shared-memory tile under
SHARED_CEILING, and a scratch in device memory of two lists of n_blocks
8-byte keys for each block of the grid, plus the 8-byte counter. The
colonnade of 20,000 triangles at blocks of one triangle has 32,768 blocks;
the plain stream must agree there with the port's brute force, with the
tolerance of tests/test_torch_stream.py:test_plain_stream_matches_brute_force.
"""

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch.ops import brute, static, stream
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade

from test_torch_stream import _hold_closest, _tris

RESIDENT = 132 * 8  # an H100's SMs x the 8 blocks of 128 threads K10 is built for
RAYS_1080P = 1920 * 1080


@pytest.mark.parametrize("block_tris", [8, 32, 128])
@pytest.mark.parametrize("n_blocks", [1 << 13, 1 << 15, 1 << 17, 1 << 20])
def test_launch_plan(n_blocks, block_tris):
    plan = stream.launch_plan(n_blocks, block_tris, RAYS_1080P, RESIDENT)
    assert plan["shared_bytes"] <= stream.SHARED_CEILING
    assert plan["shared_bytes"] == stream.launch_plan(2, block_tris, 128, 1)["shared_bytes"]
    per_block = 2 * n_blocks * 8
    grid = min(RESIDENT, -(-RAYS_1080P // stream.LANE), stream.SCRATCH_BUDGET // per_block)
    assert plan["grid"] == grid >= 1
    assert plan["scratch_bytes"] == grid * per_block + 8
    assert plan["scratch_bytes"] <= stream.SCRATCH_BUDGET + 8
    # fewer sub-packets than resident blocks: one block a sub-packet
    small = stream.launch_plan(n_blocks, block_tris, 300, RESIDENT)
    assert small["grid"] == 3 and small["scratch_bytes"] == 3 * per_block + 8


def test_launch_plan_refuses_what_no_kernel_takes():
    for args in ((0, 32, 128, 8), (8192, 0, 128, 8), (8192, 129, 128, 8), (8192, 32, 128, 0)):
        with pytest.raises(ValueError):
            stream.launch_plan(*args)


def _rays(rng):
    """256 rays, two sub-packets: a fan of 128 from a point in the hall,
    then 128 scattered rays; every seventh dead, every third short."""
    c = np.array([2.0, 3.0, 1.0])
    axis = np.array([0.6, -0.2, 0.77])
    o = np.concatenate([c + rng.normal(scale=0.05, size=(128, 3)),
                        rng.uniform([-15.0, 1.0, -7.0], [15.0, 6.0, 7.0], (128, 3))])
    d = np.concatenate([axis + rng.normal(scale=0.15, size=(128, 3)), rng.normal(size=(128, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(256, 1e6, np.float32)
    tmax[::3] = rng.uniform(0.5, 8.0, len(tmax[::3]))
    tmax[::7] = -1.0
    return [torch.from_numpy(x.astype(np.float32)) for x in (o, d, tmax)]


def test_plain_stream_beyond_16384_blocks():
    tris = _tris(build_scene(colonnade(target_tris=20_000)))
    sbvh = stream.build_stream_bvh(tris, 1)
    assert sbvh.n_blocks == 1 << 15
    o, d, tmax = _rays(np.random.default_rng(5))
    packed = static.pack_triangles(torch.from_numpy(tris))
    bt, bu, bv, bp = brute.brute_trace_plain(packed.tris, o, d, 0.0, tmax, False)
    got = stream.stream_closest(sbvh, o, d, 0.0, tmax)
    _hold_closest(got, {"t": bt.numpy(), "u": bu.numpy(), "v": bv.numpy(), "prim": bp.numpy()},
                  min_hits=100)
    hit = stream.stream_any(sbvh, o, d, 1e-4, tmax)
    np.testing.assert_array_equal(hit.numpy(),
                                  brute.brute_trace_plain(packed.tris, o, d, 1e-4, tmax, True))
    assert 0 < int(hit.sum()) < 256
