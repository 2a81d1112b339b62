"""The port's walk microbenchmark (capsaicin_tpu_torch/tools/microstep.py,
kernel K9's plain version on the CPU) against the TPU kernel of
tools/microstep.py, run through pl.pallas_call in interpret mode at one
packet, with STEPS cut to 40: the same rays and node table give the same
`out`, exactly (integer accumulators held in float32)."""

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
