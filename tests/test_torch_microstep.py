"""The port's walk microbenchmark (capsaicin_tpu_torch/tools/microstep.py,
kernel K9's plain version on the CPU) against the TPU kernel of
tools/microstep.py, run through pl.pallas_call in interpret mode at one
packet, with STEPS cut to 40: the same rays and node table give the same
`out`, exactly (integer accumulators held in float32). And a model of
the CUDA kernel's schedule (several rays a thread, the any() of each
thread's hits and then of the packet's threads, the next records read
before the any()) against the plain walk."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from capsaicin_tpu_torch import kernels
from capsaicin_tpu_torch.tools import microstep as ms

STEPS = 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_microstep():
    spec = importlib.util.spec_from_file_location(
        "tpu_microstep", os.path.join(ROOT, "tools", "microstep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ms.VARIANTS)
def test_plain_walk_matches_the_tpu_kernel(jax_microstep, monkeypatch, variant):
    monkeypatch.setattr(jax_microstep, "STEPS", STEPS)
    rays, nodes = ms.make_inputs(1, seed=3)
    call = pl.pallas_call(
        jax_microstep.make_kernel(variant), grid=(1,),
        in_specs=[pl.BlockSpec((1, 8, 8, 128), lambda p: (p, 0, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((512, 128), lambda p: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, 8, 128), lambda p: (p, 0, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1, 8, 128), jnp.float32), interpret=True)
    want = np.asarray(call(jnp.asarray(rays.numpy().reshape(1, 8, 8, 128)),
                           jnp.asarray(nodes.numpy())))
    before = ms.K9.launches
    got = ms.microstep(variant, rays, nodes, STEPS)
    assert ms.K9.launches == before  # a CPU tensor takes the plain version
    assert got.shape == (1, 1, 8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if variant == "reduce":  # steps whose box some ray hits, and steps whose box none hits
        assert 0 < want[0, 0, 0, 0] < STEPS
    assert ms.K9 in kernels.REGISTRY


def k9_schedule(variant, rays, nodes, steps, per_thread=ms.RAYS_PER_THREAD):
    """K9's step schedule (csrc/microstep.cu) in torch: a packet is
    1024 / per_thread threads of `per_thread` rays (ray t + j * threads of
    thread t); the table's first six floats a record as the kernel stages
    them; fetch reads the record, onehot one float a lane (lanes 0-5) and
    takes float c from lane c; reduce and full test the record read before
    the any() (reduce: k + 1's; full: the records of both successors, each
    wrapped, which the any() selects between), the any() an OR of each
    thread's hits and then of the packet's threads. Returns (out, the steps
    whose any() was true, and those whose successor wrapped)."""
    p = rays.shape[0]
    threads = ms.PACKET // per_thread
    staged = nodes.reshape(ms.N_ROWS * ms.LANES // 8, 8)[:, :6]
    # [P, threads, per_thread] of each ray component
    o, inv, tmin, t_best = (
        [rays[:, c].reshape(p, per_thread, threads).transpose(1, 2) for c in cs]
        for cs in ((0, 1, 2), (3, 4, 5), (6,), (7,)))
    tmin, t_best = tmin[0], t_best[0]

    def record(k):  # [P] -> the box [6][P, 1, 1]
        b = staged[(k % ms.N_ROWS) * 16 + k % 16]
        return [b[:, c, None, None] for c in range(6)]

    def tests(b):
        return ms._aabb(torch.stack(b[:3]), torch.stack(b[3:]), torch.stack(o),
                        torch.stack(inv), tmin, t_best)

    def wrap(k):
        return torch.where(k >= 8 * ms.N_ROWS, k % ms.N_ROWS + 2, k)

    k = torch.full((p,), 2, dtype=torch.int64)
    acc = torch.zeros(p, dtype=torch.int64)
    ones = torch.zeros(p)
    anys = wraps = 0
    b = record(k)
    for step in range(steps):
        if variant == "const":
            one = torch.ones(1, 1, 1)
            tests([-one] * 3 + [one] * 3)  # discarded, as the kernel's
            acc += step
            k += 1
            continue
        if variant in ("fetch", "onehot"):
            if variant == "onehot":
                rec = staged[(k % ms.N_ROWS) * 16 + k % 16]  # [P, 6]
                lanes = rec[:, torch.clamp(torch.arange(32), max=5)]  # a float a lane
                b = [lanes[:, c, None, None] for c in range(6)]  # shuffle from lane c
            else:
                b = record(k)
            tests(b)
            acc += k
            k += 1
            continue
        hit = tests(b).any(2).any(1)  # a thread's rays, then the packet's threads
        anys += int(hit.sum())
        if variant == "reduce":
            b = record(k + 1)
            k += 1
        else:
            up = k >> ms._popcount(((~k) & (k + 1)) - 1)
            k_hit, k_miss = wrap(2 * k), wrap(torch.where(up <= 1, 1, up + 1))
            wraps += int(((2 * k >= 8 * ms.N_ROWS) & hit).sum())
            b_hit, b_miss = record(k_hit), record(k_miss)
            ones += (hit & (k % 64 == 0)).float()
            k = torch.where(hit, k_hit, k_miss)
            b = [torch.where(hit[:, None, None], x, y) for x, y in zip(b_hit, b_miss)]
        acc += hit.long()
    out = (ones + acc.float())[:, None].expand(p, ms.PACKET)
    return out.reshape(p, 1, 8, ms.LANES).contiguous(), anys, wraps


@pytest.mark.parametrize("variant", ms.VARIANTS)
def test_k9_schedule_equals_the_plain_walk(variant):
    """The kernel's schedule, at 4 rays a thread and at its own 8, gives
    microstep_plain's out; full's walk takes both successors and wraps."""
    rays, nodes = ms.make_inputs(3, seed=5)
    steps = 64
    want = ms.microstep_plain(variant, rays, nodes, steps)
    for per_thread in (4, ms.RAYS_PER_THREAD):
        got, anys, wraps = k9_schedule(variant, rays, nodes, steps, per_thread)
        assert torch.equal(got, want)
    with open(os.path.join(os.path.dirname(ms.__file__), "..", "csrc", "microstep.cu")) as f:
        assert f"#define MS_RAYS {ms.RAYS_PER_THREAD} " in f.read()  # the kernel's own
    if variant in ("reduce", "full"):
        assert 0 < anys < 3 * steps
    if variant == "full":
        assert wraps > 0
