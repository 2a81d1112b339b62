"""The port's device math (capsaicin_tpu_torch.ops: mathops, sampling,
color, camera, resample) against the JAX package on the same inputs, made
from a numpy seed. Tolerance: atol 1e-6 (float32 ops in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capsaicin_tpu.ops import camera as jcam
from capsaicin_tpu.ops import color as jcol
from capsaicin_tpu.ops import mathops as jm
from capsaicin_tpu.ops import resample as jres
from capsaicin_tpu.ops import sampling as jsamp
from capsaicin_tpu.scene.procedural import make_camera as jmake_camera
from capsaicin_tpu.scene.textures import blue_noise_256
from capsaicin_tpu_torch import convert
from capsaicin_tpu_torch.ops import camera as tcam
from capsaicin_tpu_torch.ops import color as tcol
from capsaicin_tpu_torch.ops import mathops as tm
from capsaicin_tpu_torch.ops import resample as tres
from capsaicin_tpu_torch.ops import sampling as tsamp

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _both(fn_j, fn_t, *arrays):
    return fn_j(*[jnp.asarray(a) for a in arrays]), fn_t(*[torch.from_numpy(a) for a in arrays])


MATH_CASES = {
    "dot": (jm.dot, tm.dot, lambda r: (_unit(r, 64), _unit(r, 64))),
    "normalize": (jm.normalize, tm.normalize,
                  lambda r: (r.normal(size=(64, 3)).astype(np.float32),)),
    "oct_encode": (jm.oct_encode, tm.oct_encode, lambda r: (_unit(r, 256),)),
    "oct_decode": (jm.oct_decode, tm.oct_decode,
                   lambda r: (r.random((256, 2), dtype=np.float32),)),
    "cubic": (lambda x: jm.cubic(x, 0.0, 0.5), lambda x: tm.cubic(x, 0.0, 0.5),
              lambda r: ((r.random(256, dtype=np.float32) * 5.0 - 2.5),)),
    "luminance": (jm.luminance, tm.luminance,
                  lambda r: (r.random((64, 3), dtype=np.float32) * 4,)),
    "normal_weight": (lambda a, b: jm.normal_weight(a, b, 128.0),
                      lambda a, b: tm.normal_weight(a, b, 128.0),
                      lambda r: (_unit(r, 64), _unit(r, 64))),
    "depth_weight": (jm.depth_weight, tm.depth_weight,
                     lambda r: (r.random(64, dtype=np.float32) * 10,
                                r.random(64, dtype=np.float32) * 10,
                                np.where(r.random(64) < 0.2, 0.0, r.random(64) * 3).astype(np.float32))),
    "luma_weight": (lambda a, b: jm.luma_weight(a, b, 3.0),
                    lambda a, b: tm.luma_weight(a, b, 3.0),
                    lambda r: (r.random(64, dtype=np.float32), r.random(64, dtype=np.float32))),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_mathops_match_jax(rng, name):
    fn_j, fn_t, make = MATH_CASES[name]
    _close(*_both(fn_j, fn_t, *make(rng)))


COLOR_CASES = {
    "rgb_to_ycocg": (jcol.rgb_to_ycocg, tcol.rgb_to_ycocg, 1),
    "ycocg_to_rgb": (jcol.ycocg_to_rgb, tcol.ycocg_to_rgb, 1),
    "simple_tonemap": (jcol.simple_tonemap, tcol.simple_tonemap, 1),
    "invert_simple_tonemap": (jcol.invert_simple_tonemap, tcol.invert_simple_tonemap, 1),
    "clip_to_aabb": (jcol.clip_to_aabb, tcol.clip_to_aabb, 3),
}


@pytest.mark.parametrize("name", sorted(COLOR_CASES))
def test_color_matches_jax(rng, name):
    fn_j, fn_t, nargs = COLOR_CASES[name]
    args = [rng.random((128, 3), dtype=np.float32) * 0.9 for _ in range(nargs)]
    if name == "clip_to_aabb":
        args[1] = args[0] + args[1]  # pmax >= pmin
        args[2] = args[2] * 3.0 - 1.0  # some points outside the box
    _close(*_both(fn_j, fn_t, *args))


@pytest.mark.parametrize("frame", [0, 1, 7, 9, 123])
def test_halton23_matches_jax(frame):
    _close(jsamp.sample2d_halton23(frame), tsamp.sample2d_halton23(frame))


@pytest.mark.parametrize("count,stride,offset", [
    (0, 1, (0, 0)), (5, 1, (0, 0)), (17, 1, (0, 0)), (16 * 25 + 3, 1, (0, 0)),
    (1234, 1, (0, 0)), (7, 2, (1, 0)), (42, 2, (0, 1)),
])
def test_bluenoise4x4_field_matches_jax(count, stride, offset):
    noise = blue_noise_256()
    w, h = 45, 37
    want = jsamp.bluenoise4x4_field(jnp.asarray(noise), w, h, count, stride=stride, offset=offset)
    got = tsamp.bluenoise4x4_field(torch.from_numpy(noise), w, h, count, stride=stride,
                                   offset=offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hemisphere_sampling_matches_jax(rng):
    n = _unit(rng, 256)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]  # ortho_vector's branches
    s = rng.random((256, 2), dtype=np.float32)
    _close(jsamp.ortho_vector(jnp.asarray(n)), tsamp.ortho_vector(torch.from_numpy(n)))
    _close(jsamp.map_to_hemisphere(jnp.asarray(s), jnp.asarray(n), 1.0),
           tsamp.map_to_hemisphere(torch.from_numpy(s), torch.from_numpy(n), 1.0))


def _cameras(w, h):
    jc = jmake_camera("cornell", w, h)
    return jc, convert.camera_from_numpy(jc)


@pytest.mark.parametrize("frame", [0, 1, 5, 8, 13])
def test_primary_rays_match_jax(frame):
    w, h = 40, 24
    jc, tc = _cameras(w, h)
    jxy = jcam.pixel_grid(w, h)
    txy = tcam.pixel_grid(w, h)
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    jo, jd = jcam.create_primary_rays(jc, jxy, (w, h), frame)
    to, td = tcam.create_primary_rays(tc, txy, (w, h), frame)
    _close(to, jo)
    _close(td, jd)


def test_reprojection_matches_jax(rng):
    w, h = 40, 24
    jc, tc = _cameras(w, h)
    uv = rng.random((h, w, 2), dtype=np.float32)
    depth = (rng.random((h, w), dtype=np.float32) * 4 + 1).astype(np.float32)
    jp = jcam.reconstruct_world_position(jc, jnp.asarray(uv), jnp.asarray(depth))
    tp = tcam.reconstruct_world_position(tc, torch.from_numpy(uv), torch.from_numpy(depth))
    _close(tp, jp, atol=1e-5)  # positions of magnitude ~5
    _close(tcam.calculate_image_plane_uv(tc, tp), jcam.calculate_image_plane_uv(jc, jp))


def test_resample_matches_jax(rng):
    w, h = 21, 13
    uv = (rng.random((64, 2), dtype=np.float32) * 1.4 - 0.2).astype(np.float32)
    _close(tres.uv_to_xy(torch.from_numpy(uv), (w, h)), jres.uv_to_xy(jnp.asarray(uv), (w, h)))
    img = rng.random((h, w, 5), dtype=np.float32)
    ix = rng.integers(-3, w + 3, 64).astype(np.int32)
    iy = rng.integers(-3, h + 3, 64).astype(np.int32)
    want = jres._gather_pixels(jnp.asarray(img), jnp.asarray(ix), jnp.asarray(iy))
    got = tres._gather_pixels(torch.from_numpy(img), torch.from_numpy(ix), torch.from_numpy(iy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
