"""The port's spatial gather (kernel K5's plain version on the CPU, and the
pass around it) against the JAX package: the Pallas kernel
(pallas_stencil.spatial_gather, interpret mode off the TPU) in float32 and
bf16 storage, and the jnp pass. Odd sizes exercise the borders and the
half-resolution shapes of lowres_indirect.

Tolerances. Float32: rtol 1e-3, atol 1e-4, as tests/test_pallas_stencil.py
holds the Pallas stencils to the jnp ones (the jnp gather divides by the
weight sum where the kernel multiplies by its reciprocal). bf16 storage:
max abs err <= 2e-2 and mean abs err <= 1e-3, since a float32 sum taken in
another order can flip one bf16 rounding by an ulp (about 4e-3 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops import mathops as jm
from capsaicin_tpu.ops import pallas_stencil
from capsaicin_tpu.render import passes as jpasses
from capsaicin_tpu.render.settings import RenderOptions as JOptions
from capsaicin_tpu.render.settings import default_settings as jdefault_settings
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.ops import stencil
from capsaicin_tpu_torch.render import passes as tpasses
from capsaicin_tpu_torch.render.settings import RenderOptions
from torch_threads import share_cores

share_cores()

H, W = 23, 45
TOL = dict(rtol=1e-3, atol=1e-4)
BF16_MAX, BF16_MEAN = 2e-2, 1e-3


def _inputs(rng, h=H, w=W):
    indirect = (rng.random((h, w, 3), dtype=np.float32) * 2.0).astype(np.float32)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    oct = np.array(jm.oct_encode(jnp.asarray(n)))  # writable, for torch.from_numpy
    depth = (rng.random((h, w), dtype=np.float32) * 20.0 + 1.0).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0  # background pixels
    return indirect, oct, depth


def _port(indirect, normal, depth, dtype):
    s = convert.settings_from_numpy(jdefault_settings())
    out = stencil.spatial_gather(
        torch.from_numpy(indirect).to(dtype),
        stencil.pack_geo(torch.from_numpy(normal), torch.from_numpy(depth), dtype),
        s.gather_normal_sigma, s.gather_depth_sigma, s.gather_luma_sigma)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_gather_matches_pallas_kernel(rng, storage):
    indirect, oct, depth = _inputs(rng)
    normal = np.array(jm.oct_decode(jnp.asarray(oct)))
    want = np.asarray(pallas_stencil.spatial_gather(
        jnp.asarray(indirect), jnp.asarray(normal), jnp.asarray(depth), jdefault_settings(),
        storage=storage == "bf16"))
    before = stencil.K5.launches
    got = _port(indirect, normal, depth, torch.bfloat16 if storage == "bf16" else torch.float32)
    assert stencil.K5.launches == before  # CPU tensors take the plain version
    if storage == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        err = np.abs(got - want)
        assert err.max() <= BF16_MAX and err.mean() <= BF16_MEAN, (err.max(), err.mean())


def _gather_pass(indirect, oct, depth, frame_count, options):
    """The port's spatial gather pass, as the frame runs it on one block."""
    nd = {"oct": torch.from_numpy(oct), "depth": torch.from_numpy(depth)}
    return tpasses.gather_filter(
        *tpasses.gather_inputs(torch.from_numpy(indirect), nd, frame_count, options),
        convert.settings_from_numpy(jdefault_settings()))


@pytest.mark.parametrize("lowres", [False, True], ids=["full", "lowres"])
def test_gather_pass_matches_jnp(rng, lowres):
    """The pass against the jnp pass; under lowres_indirect the normals and
    depth are the 2x2 interleave phase's subsample (frame 5: phase (0, 1))
    and the gather runs at the odd half resolution."""
    h, w = (2 * H, 2 * W) if lowres else (H, W)
    _, oct, depth = _inputs(rng, h, w)
    indirect = _inputs(rng, H, W)[0]
    jnd = {"oct": jnp.asarray(oct), "depth": jnp.asarray(depth)}
    with jpasses.stencil_jnp_scope():
        want = jpasses.spatial_gather(
            jnp.asarray(indirect), jnd, w, h, 5, jdefault_settings(),
            JOptions(lowres_indirect=lowres, eaw_fused="0", eaw_bf16=False))
    got = _gather_pass(indirect, oct, depth, 5, RenderOptions(lowres_indirect=lowres))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_bf16_pass_rounds_inputs_once(rng):
    """Under eaw_bf16 the pass rounds the indirect and geo to bf16, runs the
    bf16 kernel and widens the result: it equals the plain version on the
    rounded inputs, rounded, exactly."""
    indirect, oct, depth = _inputs(rng)
    got = _gather_pass(indirect, oct, depth, 0, RenderOptions(eaw_bf16=True))
    assert got.dtype == torch.float32
    normal = tpasses.m.oct_decode(torch.from_numpy(oct))
    want = _port(indirect, normal.numpy(), depth, torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), want)
