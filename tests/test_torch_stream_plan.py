"""K10's launch plan (ops/stream.launch_plan, a host function), the plain
stream traversal on a scene of more than 16,384 blocks, and a model of
K11's counting, on the CPU.

The plan must take every scene size: a fixed shared-memory tile under
SHARED_CEILING, and a scratch in device memory of two lists of n_blocks
8-byte keys for each block of the grid, plus the 8-byte counter. The
colonnade of 20,000 triangles at blocks of one triangle has 32,768 blocks;
the plain stream must agree there with the port's brute force, with the
tolerance of tests/test_torch_stream.py:test_plain_stream_matches_brute_force.

K11 (csrc/stream_count.cu) counts COUNT_GROUP sub-packets a block of 128
threads, each thread taking every 128th box, and tests a valid box whose
faces are ordered with one interval product per axis (over [lo - o_hi,
hi - o_lo], from the two corners for each extreme that the signs of the
sub-packet's inverse-direction interval name; where those straddle 0 on
every axis, tf >= tmin_lo alone; where every ray has one direction, one
product an extreme), any other valid box with the plain version's test. A model of
that, group by group and thread by thread, must give counts equal to
`stream_count_plain` (and visit each sub-packet and box pair once) with N
not a multiple of 128, an all-dead sub-packet, a group cut short, n_blocks
not a multiple of 128, 32,768 blocks, valid boxes whose faces are not
ordered, and rays of one direction; on every live sub-packet and ordered
box the one-product test equals the plain version's exactly.
"""

import os
import re

import numpy as np
import pytest
import torch

from capsaicin_tpu_torch.ops import brute, static, stream
from capsaicin_tpu_torch.scene import build_scene
from capsaicin_tpu_torch.scene.procedural import colonnade

from test_torch_cuda import _sub_packet_rays
from test_torch_stream import _hold_closest, _tris
from torch_threads import share_cores

share_cores()

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


def _case_product(a, b, il, ih):
    """[a, b] x [il, ih] from the two corners the signs of [il, ih] name for
    the minimum and the two for the maximum (k11_product)."""
    cases = ((torch.minimum(a * il, a * ih), torch.maximum(b * il, b * ih)),  # il >= 0
             (torch.minimum(b * il, b * ih), torch.maximum(a * il, a * ih)),  # ih <= 0
             (torch.minimum(b * il, a * ih), torch.maximum(a * il, b * ih)))  # il < 0 < ih
    c0, c1 = il >= 0, (il < 0) & (ih <= 0)
    return tuple(torch.where(c0, x0, torch.where(c1, x1, x2)) for x0, x1, x2 in zip(*cases))


def straddles(bounds):
    """[P]: every axis's inverse-direction interval straddles 0 and tcap0
    >= 0, where K11 decides on tf >= tmin_lo alone (K11_STRADDLE)."""
    i_lo, i_hi, tcap0 = bounds[2], bounds[3], bounds[5]
    return ((i_lo < 0) & (i_hi > 0)).all(1) & (tcap0 >= 0)


def _ordered_hit(bounds, boxes):
    """K11's test of ordered boxes: one interval product a axis over
    [lo - o_hi, hi - o_lo] x [i_lo, i_hi], from the corners its sign case
    names; where the sub-packet straddles, tf >= tmin_lo over the products
    that hold the maxima alone -> [P, B] (torch.minimum and maximum
    propagate NaN, as min.NaN.f32 does)."""
    o_lo, o_hi, i_lo, i_hi, tmin_lo, tcap0, _ = bounds
    tn = tf = tf_straddle = None
    for ax in range(3):
        a = boxes[:, ax] - o_hi[:, ax, None]
        b = boxes[:, 4 + ax] - o_lo[:, ax, None]
        il, ih = i_lo[:, ax, None], i_hi[:, ax, None]
        lo, hi = _case_product(a, b, il, ih)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
        top = torch.maximum(a * il, b * ih)
        tf_straddle = top if tf_straddle is None else torch.minimum(tf_straddle, top)
    hit = (tn <= tf) & (tf >= tmin_lo[:, None]) & (tn <= tcap0[:, None])
    hit = torch.where(straddles(bounds)[:, None], tf_straddle >= tmin_lo[:, None], hit)
    # one direction: each extreme one product, by the sign of the direction
    tn = tf = None
    for ax in range(3):
        a = boxes[:, ax] - o_hi[:, ax, None]
        b = boxes[:, 4 + ax] - o_lo[:, ax, None]
        i = i_lo[:, ax, None]
        lo, hi = torch.where(i < 0, b * i, a * i), torch.where(i < 0, a * i, b * i)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    point = (tn <= tf) & (tf >= tmin_lo[:, None]) & (tn <= tcap0[:, None])
    return torch.where(points(bounds)[:, None], point, hit)


def points(bounds):
    """[P]: every ray of the sub-packet has the same direction (i_lo ==
    i_hi on every axis), where K11 takes one product an extreme (K11_POINT)."""
    return (bounds[2] == bounds[3]).all(1)


def count_model(sbvh, origins, dirs, tmin, tmax):
    """K11 as csrc/stream_count.cu counts: block g takes sub-packets
    [COUNT_GROUP g, COUNT_GROUP (g + 1)) (those that exist), its thread t
    the boxes t, t + 128, ...; a live sub-packet and a valid box add the
    ordered test's hit where the box's faces are ordered, the plain test's
    otherwise. Returns the counts and how often each (sub-packet, box)
    pair was tested."""
    o, d, tmin_t, tm = stream._sub_packets(origins, dirs, tmin, tmax)
    p, nb = o.shape[0], sbvh.n_blocks
    bounds = stream._bounds(o, d, tmin_t, tm)
    boxes = sbvh.boxes
    general = stream._cull(bounds, boxes)[1]
    fast = _ordered_hit(bounds, boxes)
    ordered = (boxes[:, 0:3] <= boxes[:, 4:7]).all(1)
    live, valid = bounds[6], boxes[:, 3] > 0
    on_lattice = live[:, None] & valid[None]
    assert torch.equal((fast & on_lattice)[:, ordered], (general & on_lattice)[:, ordered])
    hit = torch.where(ordered[None], fast, general) & on_lattice
    counts = torch.full((p,), -1, dtype=torch.int32)
    visits = torch.zeros(p, nb, dtype=torch.int32)
    for g in range(stream.count_plan(origins.shape[0])):
        sp = torch.arange(g * stream.COUNT_GROUP, min(p, (g + 1) * stream.COUNT_GROUP))
        total = torch.zeros(len(sp), dtype=torch.int32)
        for t in range(stream.LANE):
            k = torch.arange(t, nb, stream.LANE)
            visits[sp[:, None], k[None]] += 1
            total += hit[sp][:, k].sum(1, dtype=torch.int32)
        counts[sp] = total
    return counts, visits


def _count_case(case):
    """(StreamBVH, origins, dirs, tmax) of an edge case of K11's tiling."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "blocks_32768":
        sbvh = stream.build_stream_bvh(_tris(build_scene(colonnade(target_tris=20_000))), 1)
        assert sbvh.n_blocks == 1 << 15
    else:
        sbvh = stream.build_stream_bvh(_tris(build_scene(colonnade(target_tris=2000))), 8)
    n = {"ragged": 128 * 9 + 37, "group_tail": 128 * 70 - 5, "blocks_32768": 384}.get(case, 1280)
    o, d, tmax = _sub_packet_rays("cpu", rng, n)
    if case == "dead_sub_packet":
        tmax[128 * 3: 128 * 4] = -1.0
    if case == "one_direction":  # the shadow rays of a directional light
        d[:] = torch.tensor([0.3, 0.8, -0.52]) / torch.tensor([0.3, 0.8, -0.52]).norm()
    if case == "odd_blocks":  # n_blocks not a multiple of the 128 threads
        nb = 128 * (sbvh.n_blocks // 128 - 1) + 77
        sbvh = stream.StreamBVH(sbvh.boxes[:nb].contiguous(),
                                sbvh.tris[: nb * sbvh.block_tris].contiguous(), nb,
                                sbvh.block_tris)
    if case == "unordered":  # valid boxes with a face pair swapped, as no build makes them
        boxes = sbvh.boxes.clone()
        valid = torch.nonzero(boxes[:, 3] > 0)[:, 0]
        for ax, sel in ((1, valid[::7]), (2, valid[3::11])):
            boxes[sel, ax], boxes[sel, 4 + ax] = boxes[sel, 4 + ax].clone(), boxes[sel, ax].clone()
        sbvh = stream.StreamBVH(boxes, sbvh.tris, sbvh.n_blocks, sbvh.block_tris)
    return sbvh, o, d, tmax


COUNT_CASES = ["ragged", "dead_sub_packet", "group_tail", "odd_blocks", "blocks_32768",
               "unordered", "one_direction"]


@pytest.mark.parametrize("case", COUNT_CASES)
def test_count_model_matches_plain(case):
    sbvh, o, d, tmax = _count_case(case)
    counts, visits = count_model(sbvh, o, d, 0.0, tmax)
    want = stream.stream_count_plain(sbvh, o, d, 0.0, tmax)
    assert torch.equal(counts, want)
    assert bool((visits == 1).all())
    live = torch.nn.functional.pad(tmax >= 0.0, (0, -o.shape[0] % 128)).reshape(-1, 128).any(1)
    assert bool((want[~live] == 0).all()) and int(want.sum()) > 0
    if case == "ragged":  # every sign case, and sub-packets that straddle on every axis
        bounds = stream._bounds(*stream._sub_packets(o, d, 0.0, tmax))
        cases = torch.where(bounds[2] >= 0, 0, torch.where(bounds[3] <= 0, 1, 2))[live]
        assert set(cases.flatten().tolist()) == {0, 1, 2}
        assert bool(straddles(bounds)[live].any()) and not bool(straddles(bounds)[live].all())
        mixed = ((bounds[2] < 0) & (bounds[3] > 0)).sum(1)
        assert bool(((mixed > 0) & (mixed < 3))[live].any())  # some axes straddle, not all
    if case == "one_direction":
        assert bool(points(stream._bounds(*stream._sub_packets(o, d, 0.0, tmax)))[live].all())
    if case == "dead_sub_packet":
        assert not bool(live[3])
    if case == "group_tail":
        assert want.shape[0] % stream.COUNT_GROUP != 0
    if case == "odd_blocks":
        assert sbvh.n_blocks % 128 != 0
    if case == "unordered":
        ordered = (sbvh.boxes[:, 0:3] <= sbvh.boxes[:, 4:7]).all(1)
        assert int((~ordered & (sbvh.boxes[:, 3] > 0)).sum()) > 0


def test_count_group_matches_the_cuda_source():
    path = os.path.join(os.path.dirname(stream.__file__), os.pardir, "csrc", "stream_count.cu")
    with open(path) as f:
        defs = dict(re.findall(r"#define K11_(\w+) (\d+)", f.read()))
    assert int(defs["GROUP"]) == stream.COUNT_GROUP
    assert stream.count_plan(stream.LANE * stream.COUNT_GROUP + 1) == 2
    assert stream.count_plan(0) == 0
