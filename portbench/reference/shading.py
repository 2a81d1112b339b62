"""Shading: attribute interpolation, material, the directional light and
the Lambert BRDF, as a frozen copy of capsaicin_tpu_torch/render/shading.py
with the hit-attribute fetch's plain version (ops/lookup.py) in place of
its kernel.

`prim` is the global triangle id; -1 means miss. The passes read a
`ShadingScene` built once per scene: the [T,29] per-triangle table
(`tri_attr_table`) and the texture atlas with its sizes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import mathops as m
from . import sampling

PI = sampling.PI

SKY_COLOR = (0.7, 0.7, 0.85)  # rt_direct_lighting.hlsl:56

LIGHT_DISTANCE = 100000.0
SHADOW_TMIN = 0.0001  # lighting.h:44


class ShadingScene(NamedTuple):
    """What the passes read of a scene: the [T,29] attribute table, the
    quad-packed texture atlas ([N,TH,TW,16] float32, or [N,TH,TW,4] int32
    holding rgba8 bits) and its per-texture sizes [N,2] (w, h)."""

    table: torch.Tensor
    atlas: torch.Tensor
    atlas_size: torch.Tensor


def shading_scene(scene, device) -> ShadingScene:
    """The ShadingScene of a Scene of numpy arrays, on `device`."""
    scene = type(scene)(*[torch.from_numpy(np.array(x)).to(device) for x in scene])
    return ShadingScene(tri_attr_table(scene), scene.atlas.contiguous(), scene.atlas_size)


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
    return hit_attributes_plain(table, prim, u, v)


def hit_attributes_plain(table, prim, u, v):
    """The plain version of K2: a row gather and the interpolation."""
    a = table[prim.clamp(0, table.shape[0] - 1).long()]
    w = (1.0 - u - v)[..., None]
    uu = u[..., None]
    vv = v[..., None]
    return {
        "p": a[..., 0:3] * w + a[..., 3:6] * uu + a[..., 6:9] * vv,
        "n": m.normalize(a[..., 9:12] * w + a[..., 12:15] * uu + a[..., 15:18] * vv),
        "tx": a[..., 18:20] * w + a[..., 20:22] * uu + a[..., 22:24] * vv,
        "kd": a[..., 24:27],
        "tex": a[..., 27].to(torch.int32),
        "mesh": a[..., 28].to(torch.int32),
    }



def _unpack_rgba8(u):
    """int32 holding rgba8 bits -> [...,4] float32 in [0,1]. The mask makes
    the arithmetic shift of the top byte safe; dividing (not multiplying by
    1/255) rounds k/255 correctly, so the result is bit-equal to the
    float32 atlas of round(v*255)/255."""
    return torch.stack([(u >> s) & 0xFF for s in (0, 8, 16, 24)], -1).float() / 255.0


def sample_atlas(atlas, sizes, tex_id, uv):
    """Bilinear, wrap-mode fetch from the quad-packed texture atlas
    (SampleLevel on the bindless texture array, scene.h:58): one row read
    per sample gives all four corners. atlas [N,TH,TW,16] float32 or
    [N,TH,TW,4] int32 rgba8 (scene.quantize_atlas); sizes [N,2] (w, h);
    tex_id [...] int; uv [...,2]. Every index lands inside the atlas, even
    for a garbage uv: the wrap is a floor-mod by a size of at least 1."""
    t = tex_id.clamp(0, atlas.shape[0] - 1).long()
    wh = sizes[t].long()
    xy = uv * wh.float() - 0.5
    fl = torch.floor(xy)
    fx = (xy[..., 0] - fl[..., 0])[..., None]
    fy = (xy[..., 1] - fl[..., 1])[..., None]
    jx = torch.remainder(fl[..., 0].long(), wh[..., 0])
    jy = torch.remainder(fl[..., 1].long(), wh[..., 1])
    n, th, tw, c = atlas.shape
    quad = atlas.reshape(n * th * tw, c)[(t * th + jy) * tw + jx]
    if atlas.dtype == torch.int32:
        v00, v10, v01, v11 = (_unpack_rgba8(quad[..., k]) for k in range(4))
    else:
        v00, v10, v01, v11 = (quad[..., 4 * k: 4 * k + 4] for k in range(4))
    top = v00 * (1 - fx) + v10 * fx
    bot = v01 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def has_textures(scene: ShadingScene) -> bool:
    """Whether the atlas holds a texture: known from its shape (the
    untextured scene carries the 1x1 fallback), so it costs no sync."""
    return scene.atlas.shape[1] > 1 or scene.atlas.shape[2] > 1


def material_from_hit(scene: ShadingScene, hit, use_material_kd: bool = False):
    """Diffuse albedo kd of a hit; scene.h:52-61. Untextured meshes: the
    reference's constant 0.75 (`use_material_kd` substitutes the MTL Kd).
    Textured: v-flip, the bilinear atlas fetch, then the gamma-2.2 decode.
    The fetch is skipped for a scene without textures."""
    base = hit["kd"] if use_material_kd else torch.full_like(hit["kd"], 0.75)
    if has_textures(scene):
        tx = hit["tx"]
        flip = torch.stack([tx[..., 0], 1.0 - tx[..., 1]], -1)
        tex_rgb = sample_atlas(scene.atlas, scene.atlas_size, hit["tex"], flip)[..., :3]
        base = torch.where((hit["tex"] >= 0)[..., None], tex_rgb, base)
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
