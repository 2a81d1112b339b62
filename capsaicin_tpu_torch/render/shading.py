"""Shading: attribute interpolation, material, the directional light and
the Lambert BRDF. The torch counterpart of capsaicin_tpu/render/shading.py
(scene.h, lighting.h and shading.h of the reference).

`prim` is the global triangle id; -1 means miss. The hit-attribute fetch
reads a [T,29] per-triangle table built once per scene (`tri_attr_table`)
through kernel K2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import lookup
from ..ops import mathops as m
from ..ops import sampling

PI = sampling.PI

SKY_COLOR = (0.7, 0.7, 0.85)  # rt_direct_lighting.hlsl:56

LIGHT_DISTANCE = 100000.0
SHADOW_TMIN = 0.0001  # lighting.h:44


def tri_attr_table(scene):
    """[T,29] per-triangle records (positions, normals, texcoords, material
    kd, texture id, mesh id) from a Scene of tensors."""
    mesh = scene.tri_mesh.long()
    return torch.cat(
        [
            scene.tri_v0, scene.tri_v1, scene.tri_v2,
            scene.tri_n0, scene.tri_n1, scene.tri_n2,
            scene.tri_t0, scene.tri_t1, scene.tri_t2,
            scene.mesh_kd[mesh],
            scene.mesh_texture[mesh].float()[:, None],
            scene.tri_mesh.float()[:, None],
        ],
        -1,
    ).contiguous()


def fetch_hit_attributes(table, prim, u, v):
    """(prim [N], barycentrics) -> dict with position, shading normal,
    texcoord, material kd, texture id and mesh id (scene.h:5-50): P and UV
    interpolated with (1-u-v, u, v), the normal normalized after."""
    return lookup.hit_attributes(table, prim, u, v)


def material_from_hit(hit, use_material_kd: bool = False):
    """Diffuse albedo of an untextured hit; scene.h:52-61. The reference
    uses a constant 0.75; `use_material_kd` substitutes the MTL Kd."""
    base = hit["kd"] if use_material_kd else torch.full_like(hit["kd"], 0.75)
    return torch.pow(base.clamp_min(0.0), 2.2)


@functools.lru_cache(maxsize=8)
def _light_table(device: str):
    """The light of each of its 4096 animation steps, in float32, uploaded
    once per device: a frame picks its row with a host index, so it makes
    no host-to-device copy."""
    t = np.float32(2.0 * 3.14) * np.arange(4096, dtype=np.float32) / np.float32(4096.0)
    d = np.stack([40.0 * np.sin(t), np.full_like(t, 100.0), 40.0 * np.cos(t)], -1)
    d = d / np.sqrt(np.sum(d * d, -1, keepdims=True))
    intensity = np.stack(
        [np.full_like(t, 28.0), np.full_like(t, 24.0), 20.0 + 2.0 + 2.0 * np.cos(t)], -1)
    return torch.from_numpy(d).to(device), torch.from_numpy(intensity).to(device)


def directional_light_sample(frame_count: int, device=None):
    """The animated directional light (lighting.h:20-33).
    Returns (direction [3], intensity [3])."""
    d, intensity = _light_table(str(torch.device(device or "cpu")))
    i = int(frame_count) % 4096
    return d[i], intensity[i]


def lambert_eval():
    """1/pi; shading.h:15-18."""
    return 1.0 / PI


def lambert_pdf(n, o):
    """max(0, n.o)/pi; shading.h:20-23."""
    return m.dot(n, o).clamp_min(0.0) / PI


def lambert_sample(s, n):
    """Cosine hemisphere sample; shading.h:25-33. Returns (direction,
    brdf, pdf)."""
    d = sampling.map_to_hemisphere(s, n, 1.0)
    return d, lambert_eval(), lambert_pdf(n, d)


def direct_illumination_terms(p, n, kd, frame_count: int):
    """The unshadowed NEE integrand and the shadow-ray direction
    (lighting.h:35-61; the caller traces the shadow ray)."""
    ldir, li = directional_light_sample(frame_count, p.device)
    ldir = ldir.expand(p.shape)
    ndotl = m.dot(n, ldir).clamp_min(0.0)
    unshadowed = li * kd * lambert_eval() * ndotl[..., None]
    return ldir, unshadowed
