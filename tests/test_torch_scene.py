"""The port's scene, camera and blue-noise host code against the JAX
package's, and the convert.py round trip."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops.camera import Camera as JCamera
from capsaicin_tpu.render import pipeline as jpipe
from capsaicin_tpu.render.settings import RenderOptions as JOptions
from capsaicin_tpu.render.settings import default_settings as jdefault_settings
from capsaicin_tpu.scene import build_scene as jbuild_scene
from capsaicin_tpu.scene.procedural import cornell_box as jcornell_box
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu.scene.textures import blue_noise_256 as jblue_noise
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.render import pipeline as tpipe
from capsaicin_tpu_torch.render.settings import default_settings as tdefault_settings
from capsaicin_tpu_torch.scene import Scene, build_scene
from capsaicin_tpu_torch.scene.procedural import cornell_box, make_camera
from capsaicin_tpu_torch.scene.textures import blue_noise_256
from torch_threads import share_cores

share_cores()


def test_cornell_scene_matches_jax():
    want = jbuild_scene(jcornell_box())
    got = build_scene(cornell_box())
    assert got.num_triangles == 40
    assert Scene._fields == type(want)._fields
    for field in Scene._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_blue_noise_matches_jax():
    np.testing.assert_array_equal(blue_noise_256(), jblue_noise())


@pytest.mark.parametrize("size", [(1920, 1080), (64, 64), (37, 21)])
def test_make_camera_matches_jax(size):
    want = jmake_camera("cornell", *size)
    got = make_camera("cornell", *size)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_settings_match_jax():
    want = jdefault_settings()
    assert convert.settings_from_numpy(want) == tdefault_settings()


def test_convert_roundtrip(rng):
    h, w = 6, 5
    cam = jmake_camera("cornell", w, h)
    state = jpipe.init_state(w, h, cam, JOptions(eaw_fused="0", eaw_bf16=False))
    state = state._replace(
        color_history=jnp.asarray(rng.random((h, w, 4), dtype=np.float32)),
        prev_nd_inst=jnp.asarray(rng.integers(-1, 7, (h, w)).astype(np.int32)),
        frame_count=jnp.int32(5),
    )
    state_np = type(state)(*[
        JCamera(*[np.asarray(x) for x in leaf]) if isinstance(leaf, JCamera) else np.asarray(leaf)
        for leaf in state
    ])
    port = convert.state_from_numpy(state_np)
    assert isinstance(port, tpipe.FrameState)
    assert port.frame_count == 5
    back = convert.state_to_numpy(port)
    for field in tpipe.FrameState._fields:
        a, b = getattr(back, field), getattr(state_np, field)
        if field == "prev_camera":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
            if field != "frame_count":
                assert a.dtype == b.dtype, field
    scene = convert.scene_from_numpy(jbuild_scene(jcornell_box()))
    assert all(isinstance(x, torch.Tensor) for x in scene)
    np.testing.assert_array_equal(scene.tri_v0.numpy(), build_scene(cornell_box()).tri_v0)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX."""
    code = (
        "import pkgutil, sys, capsaicin_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(mods) >= 20, mods\n"
        "for m in mods: __import__(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'capsaicin_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("which", ["textured", "multitextured"])
def test_textured_scenes_match_jax(which):
    """The textured Cornell boxes (one 128x128 checker; or with a 48x96
    stripe texture too, padded into one atlas) and the rgba8 atlas, whose
    int32 bits are the JAX package's uint32 ones."""
    from capsaicin_tpu.scene import procedural as jprocedural
    from capsaicin_tpu.scene.scene import quantize_atlas as jquantize_atlas
    from capsaicin_tpu_torch.scene import procedural
    from capsaicin_tpu_torch.scene.scene import quantize_atlas

    want = jbuild_scene(*getattr(jprocedural, f"cornell_box_{which}")())
    got = build_scene(*getattr(procedural, f"cornell_box_{which}")())
    for field in Scene._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.atlas.dtype == np.float32
    q, jq = quantize_atlas(got), jquantize_atlas(want)
    assert q.atlas.dtype == np.int32 and jq.atlas.dtype == np.uint32
    np.testing.assert_array_equal(q.atlas, jq.atlas.view(np.int32))
    assert quantize_atlas(q) is q
    np.testing.assert_array_equal(convert.scene_from_numpy(jq).atlas.numpy(), q.atlas)


def test_rgba8_atlas_samples_as_the_float_atlas(rng):
    """On 8-bit-grid textures the int32 rgba8 atlas samples bit-equal to
    the float32 atlas, and both equal the JAX package's sample_atlas, for
    any uv (wrapping outside [0,1]) and texture id (clamped)."""
    from capsaicin_tpu.render import shading as jshading
    from capsaicin_tpu.scene.scene import quantize_atlas as jquantize_atlas
    from capsaicin_tpu_torch.render import shading
    from capsaicin_tpu_torch.scene.procedural import cornell_box_multitextured
    from capsaicin_tpu_torch.scene.scene import quantize_atlas

    scene = build_scene(*cornell_box_multitextured())
    uv = (rng.random((500, 2), dtype=np.float32) * 3.0 - 1.0).astype(np.float32)
    tex = rng.integers(-1, 3, 500).astype(np.int32)
    sizes = torch.from_numpy(scene.atlas_size)

    def sample(atlas):
        return shading.sample_atlas(torch.from_numpy(atlas), sizes, torch.from_numpy(tex),
                                    torch.from_numpy(uv)).numpy()

    f32, rgba8 = sample(scene.atlas), sample(quantize_atlas(scene).atlas)
    np.testing.assert_array_equal(rgba8, f32)
    for atlas in (scene.atlas, jquantize_atlas(scene).atlas):
        want = jshading.sample_atlas(jnp.asarray(atlas), jnp.asarray(scene.atlas_size),
                                     jnp.asarray(tex), jnp.asarray(uv))
        np.testing.assert_allclose(f32, np.asarray(want), rtol=0, atol=1e-6)
