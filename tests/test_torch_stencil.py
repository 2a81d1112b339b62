"""The port's EAW denoise chain (ops/stencil.py, kernels K3, K4 and K6 in
their plain versions on the CPU) against the JAX package: the Pallas chain
(pallas_stencil.denoise_chain, interpret mode off the TPU), sequential and
fused, in float32 and bf16 storage, and the jnp passes. Odd sizes exercise
the borders. Tolerance rtol 1e-3, atol 1e-4 in float32, as
tests/test_pallas_stencil.py holds the Pallas chain to the jnp one; bf16
tolerances are stated where they are used."""

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

H, W = 40, 150
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture
def buffers(rng):
    color4 = rng.random((H, W, 4), dtype=np.float32) * 2.0
    color4[..., 3] *= 0.1
    color4[3, 5, :3] = 40.0  # a firefly above the clamp
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    oct = np.asarray(jm.oct_encode(jnp.asarray(n)))
    depth = (rng.random((H, W), dtype=np.float32) * 20.0 + 1.0).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0  # background pixels
    moments4 = rng.random((H, W, 4), dtype=np.float32)
    moments4[..., 3] = rng.integers(0, 20, (H, W)).astype(np.float32)
    return color4, oct, depth, moments4


def _options(**kw):
    """Both packages' options, with the EAW storage variants pinned (the
    JAX defaults read environment variables)."""
    return (JOptions(eaw_fused="0", eaw_bf16=False, **kw), RenderOptions(**kw))


def _port_chain(buffers, options):
    color4, oct, depth, moments4 = buffers
    nd = {"oct": torch.tensor(oct), "depth": torch.tensor(depth)}
    settings = convert.settings_from_numpy(jdefault_settings())
    return stencil.denoise_chain(*tpasses.denoise_inputs(
        torch.from_numpy(color4), nd, torch.from_numpy(moments4)), settings, options).numpy()


def test_chain_matches_pallas_chain(buffers):
    color4, oct, depth, moments4 = buffers
    jopt, topt = _options(eaw5=True)
    want = pallas_stencil.denoise_chain(
        jnp.asarray(color4), jm.oct_decode(jnp.asarray(oct)), jnp.asarray(depth),
        jnp.asarray(moments4), jdefault_settings(), jopt)
    np.testing.assert_allclose(_port_chain(buffers, topt), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [dict(eaw5=False), dict(use_variance=False)],
                         ids=["eaw3", "no_variance"])
def test_chain_matches_jnp_passes(buffers, kw):
    color4, oct, depth, moments4 = buffers
    jopt, topt = _options(**kw)
    nd = {"oct": jnp.asarray(oct), "depth": jnp.asarray(depth),
          "inst": jnp.zeros((H, W), jnp.int32)}
    with jpasses.stencil_jnp_scope():
        want = jpasses.denoise(jnp.asarray(color4), nd, jnp.asarray(moments4),
                               jdefault_settings(), jopt)
    np.testing.assert_allclose(_port_chain(buffers, topt), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride", [1, 3, 7])
def test_single_stage_matches_jnp(buffers, stride):
    color4, oct, depth, moments4 = buffers
    jopt, _ = _options()
    nd = {"oct": jnp.asarray(oct), "depth": jnp.asarray(depth)}
    want = jpasses.eaw_blur(jnp.asarray(color4), nd, stride, jdefault_settings(), jopt)
    s = convert.settings_from_numpy(jdefault_settings())
    normal = torch.tensor(np.asarray(jm.oct_decode(jnp.asarray(oct))))
    geo = torch.cat([normal, torch.from_numpy(depth)[..., None]], -1)
    got = stencil.eaw_stage(torch.from_numpy(color4), geo, stride, True,
                            s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_disocclusion_matches_jnp(buffers):
    color4, oct, depth, moments4 = buffers
    jopt, _ = _options()
    nd = {"oct": jnp.asarray(oct), "depth": jnp.asarray(depth)}
    want = jpasses.eaw_blur_disocclusion(jnp.asarray(color4), nd, jnp.asarray(moments4),
                                         jdefault_settings(), jopt)
    s = convert.settings_from_numpy(jdefault_settings())
    normal = torch.tensor(np.asarray(jm.oct_decode(jnp.asarray(oct))))
    geo = torch.cat([normal, torch.from_numpy(depth)[..., None]], -1)
    mom = torch.from_numpy(moments4)[..., [0, 1, 3]]
    before = stencil.K3.launches
    got = stencil.eaw_disocclusion(torch.from_numpy(color4), geo, mom,
                                   s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    assert stencil.K3.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pallas_chain(buffers, jopt):
    color4, oct, depth, moments4 = buffers
    return np.asarray(pallas_stencil.denoise_chain(
        jnp.asarray(color4), jm.oct_decode(jnp.asarray(oct)), jnp.asarray(depth),
        jnp.asarray(moments4), jdefault_settings(), jopt))


def test_unported_chain_variants_raise(buffers):
    """The fused chain eaw_fused="1" (K3, then K6 for (1, 3) and (5, 7)) in
    float32 against the Pallas chain with the same option."""
    before = stencil.K6.launches
    got = _port_chain(buffers, RenderOptions(eaw_fused="1"))
    assert stencil.K6.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(
        got, _pallas_chain(buffers, JOptions(eaw_fused="1", eaw_bf16=False)), **TOL)


def test_fused_13_bf16_chain_matches_pallas_chain(buffers):
    """eaw_fused="13" (K6 for (1, 3), then K4 at 5 and 7) with bf16 storage
    against the Pallas chain with the same options. Tolerance max abs err
    <= 2e-2 and mean abs err <= 1e-3: both round at the same points, but a
    float32 sum in another order can flip a bf16 rounding by an ulp (about
    4e-3 relative), and the flip carries down the chain."""
    got = _port_chain(buffers, RenderOptions(eaw_fused="13", eaw_bf16=True))
    want = _pallas_chain(buffers, JOptions(eaw_fused="13", eaw_bf16=True))
    assert got.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() <= 2e-2 and err.mean() <= 1e-3, (err.max(), err.mean())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_pair_is_two_stages_unrounded_between(buffers, bf16):
    """K6's plain version is the stage at stride_a and the stage at
    stride_b with the intermediate in float32: exactly so in float32; in
    bf16 it differs from two bf16 stages by the one rounding it skips."""
    color4, oct, depth, _ = buffers
    dt = torch.bfloat16 if bf16 else torch.float32
    s = convert.settings_from_numpy(jdefault_settings())
    sig = (s.eaw_normal_sigma, s.eaw_depth_sigma, s.eaw_luma_sigma)
    normal = torch.tensor(np.asarray(jm.oct_decode(jnp.asarray(oct))))
    geo = stencil.pack_geo(normal, torch.from_numpy(depth), dt)
    col = torch.from_numpy(color4).to(dt)
    pair = stencil.eaw_pair(col, geo, 5, 7, True, *sig)
    assert pair.dtype == dt
    mid = stencil.eaw_stage(col.float(), geo, 5, True, *sig)
    np.testing.assert_array_equal(
        pair.float().numpy(), stencil.eaw_stage(mid, geo, 7, True, *sig).to(dt).float().numpy())
    rounded_twice = stencil.eaw_stage(stencil.eaw_stage(col, geo, 5, True, *sig), geo, 7, True, *sig)
    err = (pair.float() - rounded_twice.float()).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 1e-3
