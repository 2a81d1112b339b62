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
