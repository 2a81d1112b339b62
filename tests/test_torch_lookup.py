"""The port's hit-attribute fetch (ops/lookup.py, kernel K2's plain version
on the CPU) against the JAX package: the Pallas table lookup (interpret
mode) must be matched exactly, shading.fetch_hit_attributes to 1e-6."""

import jax.numpy as jnp
import numpy as np
import torch

from capsaicin_tpu.ops.pallas_lookup import table_lookup
from capsaicin_tpu.render import shading as jshading
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import cornell_box as jcornell_box
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.ops import lookup
from capsaicin_tpu_torch.render import shading as tshading


def _inputs(rng, n=5000):
    scene = jbuild_scene(jcornell_box())
    prim = rng.integers(-1, 40, n).astype(np.int32)
    u = rng.random(n, dtype=np.float32)
    v = (rng.random(n, dtype=np.float32) * (1.0 - u)).astype(np.float32)
    return scene, prim, u, v


def test_attr_table_matches_jax():
    scene = jbuild_scene(jcornell_box())
    want = np.asarray(jshading._tri_attr_table(jax_scene(scene)))
    got = tshading.tri_attr_table(convert.scene_from_numpy(scene)).numpy()
    assert got.shape == (40, lookup.TABLE_COLS)
    np.testing.assert_array_equal(got, want)


def jax_scene(scene):
    return type(scene)(*[jnp.asarray(x) for x in scene])


def test_rows_match_pallas_table_lookup(rng):
    """The row K2 reads is the row the one-hot MXU lookup returns."""
    table = rng.normal(size=(40, lookup.TABLE_COLS)).astype(np.float32)
    idx = rng.integers(-3, 45, 5000).astype(np.int32)
    want = np.asarray(table_lookup(jnp.asarray(table), jnp.asarray(idx)))
    # u = 1, v = 0 interpolates to the second vertex block; u = v = 0 to the
    # first: together they expose every column of the row
    t = torch.from_numpy(table)
    p = torch.from_numpy(idx)
    zero = torch.zeros(len(idx))
    out0 = lookup.hit_attributes(t, p, zero, zero)
    np.testing.assert_array_equal(out0["p"].numpy(), want[:, 0:3])
    np.testing.assert_array_equal(out0["tx"].numpy(), want[:, 18:20])
    np.testing.assert_array_equal(out0["kd"].numpy(), want[:, 24:27])
    np.testing.assert_array_equal(out0["tex"].numpy(), want[:, 27].astype(np.int32))
    np.testing.assert_array_equal(out0["mesh"].numpy(), want[:, 28].astype(np.int32))
    out1 = lookup.hit_attributes(t, p, torch.ones(len(idx)), zero)
    np.testing.assert_array_equal(out1["p"].numpy(), want[:, 3:6])
    np.testing.assert_array_equal(out1["tx"].numpy(), want[:, 20:22])


def test_fetch_hit_attributes_matches_jax(rng):
    scene, prim, u, v = _inputs(rng)
    want = jshading.fetch_hit_attributes(jax_scene(scene), jnp.asarray(prim), jnp.asarray(u),
                                         jnp.asarray(v))
    table = tshading.tri_attr_table(convert.scene_from_numpy(scene))
    before = lookup.K2.launches
    got = tshading.fetch_hit_attributes(table, torch.from_numpy(prim), torch.from_numpy(u),
                                        torch.from_numpy(v))
    assert lookup.K2.launches == before  # CPU tensors take the plain version
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == (torch.int32 if key in ("tex", "mesh") else torch.float32)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    kd_want = np.asarray(jshading.material_from_hit(jax_scene(scene), want))
    np.testing.assert_allclose(tshading.material_from_hit(got).numpy(), kd_want,
                               rtol=1e-6, atol=1e-6)
