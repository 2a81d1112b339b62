"""The GBUFFER_FEEDBACK fetch's plain version (ops.feedback, the plain
version of kernel K12) bit for bit against the benchmark reference's frozen
copy of the fetch it was moved from (portbench/reference/passes.py), on
hand-made lanes at the image's edges: corners at -1 (bx = -1, by = -1),
points at x = W-1 and y = H-1, offscreen uv, a hit at the camera's position
(0/0, a NaN uv), a history value past fp16's range, and images one pixel
wide or tall. The wrapper takes the plain version for CPU tensors and
launches nothing; K12 itself is held to the plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch import kernels
from capsaicin_tpu_torch.ops import camera as cam
from capsaicin_tpu_torch.ops import feedback
from portbench.reference import passes as reference
from torch_threads import share_cores

share_cores()


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bool:
        assert torch.equal(got, want)
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _case(width, height, seed=0):
    """(p [N,3], camera, history [H,W,3], depth [H,W]): lanes placed at
    chosen uv with distances that match, nearly match or miss the depth of
    the pixel they land on, and the edge lanes of the module docstring."""
    rng = np.random.default_rng(seed)
    camera = cam.default_camera(aspect=height / width)
    history = torch.as_tensor(rng.uniform(0.0, 2.0, (height, width, 3)), dtype=torch.float32)
    history[0, min(1, width - 1), 1] = 1e5  # past fp16's 65504: inf after the rounding
    depth = torch.as_tensor(rng.uniform(1.0, 10.0, (height, width)), dtype=torch.float32)

    ex, ey = 0.2 / width, 0.2 / height
    uv = [(ex, ey), (ex, 0.5), (0.5, ey),  # the -1 corners
          (1.0, 1.0), (1.0 - ex, 1.0 - ey), (1.0, 0.5), (0.5, 1.0),  # x = W-1, y = H-1
          (-0.3, 0.5), (1.4, 0.5), (0.5, -2.0), (0.5, 1.7), (-5.0, -5.0), (0.0, 0.0),
          (0.5 / width, 0.5 / height), (1.5 / width, 0.5)]  # pixel centres: weight 0
    uv += [tuple(x) for x in rng.uniform(0.0, 1.0, (48, 2))]
    uv = torch.tensor(uv, dtype=torch.float32)
    px = (uv[:, 0] * width).floor().clamp(0, width - 1).long()
    py = (uv[:, 1] * height).floor().clamp(0, height - 1).long()
    factor = torch.as_tensor(rng.choice([1.0, 1.03, 0.97, 1.2, 0.8], len(uv)), dtype=torch.float32)
    dist = depth[py, px] * factor
    p = cam.reconstruct_world_position(camera, uv, dist)
    p = torch.cat([p, camera.position[None],  # 0/0: a NaN uv
                   (camera.position - 3.0 * camera.forward)[None]])  # behind the camera
    return p, camera, history, depth


@pytest.mark.parametrize("width, height", [(16, 9), (1, 5), (7, 1), (1, 1)],
                         ids=["16x9", "one_pixel_wide", "one_pixel_tall", "one_pixel"])
def test_plain_fetch_equals_the_fetch_it_was_moved_from(width, height):
    p, camera, history, depth = _case(width, height)
    hist, disocc = feedback.feedback_fetch_plain(p, camera, history, depth, width, height)
    want_hist, want_disocc = reference._feedback_fetch(p, camera, history, depth, width, height)
    _bits_equal(hist, want_hist)
    _bits_equal(disocc, want_disocc)
    assert hist.shape == (p.shape[0], 3) and disocc.shape == (p.shape[0],)
    assert bool(disocc.any()) and bool((~disocc).any())
    assert bool(torch.isnan(hist).any())  # the inf corner under a zero weight


def test_plain_fetch_edge_lanes():
    """The edge lanes read what the edge-clamped bilinear fetch reads."""
    width, height = 16, 9
    p, camera, history, depth = _case(width, height)
    hist, disocc = feedback.feedback_fetch_plain(p, camera, history, depth, width, height)
    fb = history.half().float()
    # uv (1, 1): the point x = W-1, y = H-1; its corners are (W-2..W-1, H-2..H-1)
    # at weight 0.5, and its depth is the point fetch of (W-1, H-1)
    quad = fb[height - 2:, width - 2:].reshape(4, 3)
    assert torch.allclose(hist[3], quad.mean(0), rtol=1e-6, atol=0)
    # uv (-0.3, 0.5) is offscreen, so disoccluded whatever its depth
    assert bool(disocc[7]) and bool(disocc[8]) and bool(disocc[9]) and bool(disocc[10])
    # the hit at the camera's position: a NaN uv reads the corner (0, 0) at
    # weight 1 and (1, 0), whose fp16 green is inf, at weight 0; it is
    # disoccluded (|d| / 1e-20)
    assert bool(disocc[-2]) and torch.isnan(hist[-2, 1]) and hist[-2, 0] == fb[0, 0, 0]


def test_wrapper_takes_the_plain_version_on_the_cpu():
    p, camera, history, depth = _case(16, 9)
    kernels.reset_counts()
    got = feedback.feedback_fetch(p, camera, history, depth, 16, 9)
    want = feedback.feedback_fetch_plain(p, camera, history, depth, 16, 9)
    assert feedback.K12.launches == 0
    for g, w in zip(got, want):
        _bits_equal(g, w)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        feedback.feedback_fetch(p.to("meta"), camera, history, depth, 16, 9)
