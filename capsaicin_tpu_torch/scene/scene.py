"""The Scene: flat arrays describing all geometry and materials, with the
fields of capsaicin_tpu/scene/scene.py. A Scene built here holds numpy
arrays; `convert.scene_from_numpy` gives the same Scene with torch tensors
on a device.

The texture atlas is quad-packed: for every texel, the four corners of
its bilinear footprint ((0,0), (+1,0), (0,+1), (+1,+1), wrapped at the
texture's own size), so one row read fetches a whole bilinear sample.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from .obj_loader import MeshData, mesh_arrays


class Scene(NamedTuple):
    # pooled streams
    positions: np.ndarray  # [V,3] f32
    normals: np.ndarray  # [V,3] f32
    texcoords: np.ndarray  # [V,2] f32
    indices: np.ndarray  # [I] i32

    # mesh descriptor table (data_payload.h:21-31)
    mesh_first_vertex: np.ndarray  # [M] i32
    mesh_vertex_count: np.ndarray  # [M] i32
    mesh_first_index: np.ndarray  # [M] i32
    mesh_index_count: np.ndarray  # [M] i32
    mesh_texture: np.ndarray  # [M] i32, -1 == no texture
    mesh_kd: np.ndarray  # [M,3] f32
    mesh_first_prim: np.ndarray  # [M] i32

    # flattened triangle SoA
    tri_v0: np.ndarray  # [T,3]
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_n0: np.ndarray  # [T,3]
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_t0: np.ndarray  # [T,2]
    tri_t1: np.ndarray
    tri_t2: np.ndarray
    tri_mesh: np.ndarray  # [T] i32

    atlas: np.ndarray  # [N,TH,TW,16] f32 quad-packed texels, or [N,TH,TW,4]
    #                    int32 holding each corner's rgba8 bits (quantize_atlas)
    atlas_size: np.ndarray  # [N,2] i32 (w,h)

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_meshes(self) -> int:
        return self.mesh_first_vertex.shape[0]


def _pack_atlas(images: List[np.ndarray]):
    """Quad-packed atlas [N,TH,TW,16] and sizes [N,2] of [H,W,4] images,
    padded to the largest; the 1x1 zero atlas where there are none."""
    if not images:
        return np.zeros((1, 1, 1, 16), np.float32), np.ones((1, 2), np.int32)
    th = max(i.shape[0] for i in images)
    tw = max(i.shape[1] for i in images)
    atlas = np.zeros((len(images), th, tw, 16), np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    for k, img in enumerate(images):
        quad = np.concatenate(
            [img, np.roll(img, -1, axis=1), np.roll(img, -1, axis=0),
             np.roll(img, (-1, -1), axis=(0, 1))], axis=-1)
        atlas[k, : img.shape[0], : img.shape[1], :] = quad
        sizes[k] = (img.shape[1], img.shape[0])
    return atlas, sizes


def build_scene(meshes: List[MeshData],
                textures: Optional[Dict[str, np.ndarray]] = None) -> Scene:
    """Assemble a Scene from per-mesh data. textures: name -> [H,W,4]
    float image in [0,1], before the gamma-2.2 decode the shading does. A
    mesh without a texture name gets texture id -1 (constant albedo); a
    named texture that is missing becomes a 1x1 black texel
    (texture_system.cpp:47-56), as does one mapped to None (a file
    `textures.load_texture` could not read)."""
    textures = textures or {}
    tex_names: List[str] = []
    for mesh in meshes:
        if mesh.texture_name and mesh.texture_name not in tex_names:
            tex_names.append(mesh.texture_name)
    pos_list, nrm_list, uv_list, idx_list = [], [], [], []
    mfv, mvc, mfi, mic, mkd, mfp = [], [], [], [], [], []
    tri = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "t0", "t1", "t2")}
    tmesh = []
    first_vertex = first_index = first_prim = 0
    for mesh_id, mesh in enumerate(meshes):
        pos, nrm, uv, idx = mesh_arrays(mesh)
        pos_list.append(pos)
        nrm_list.append(nrm)
        uv_list.append(uv)
        idx_list.append(idx)
        mfv.append(first_vertex)
        mvc.append(pos.shape[0])
        mfi.append(first_index)
        mic.append(idx.shape[0])
        mkd.append(mesh.material.kd if mesh.material else (0.75, 0.75, 0.75))
        mfp.append(first_prim)
        corners = idx.reshape(-1, 3)
        for k in range(3):
            tri[f"v{k}"].append(pos[corners[:, k]])
            tri[f"n{k}"].append(nrm[corners[:, k]])
            tri[f"t{k}"].append(uv[corners[:, k]])
        tmesh.append(np.full(corners.shape[0], mesh_id, np.int32))
        first_vertex += pos.shape[0]
        first_index += idx.shape[0]
        first_prim += corners.shape[0]

    blank = np.zeros((1, 1, 4), np.float32)
    images = [textures.get(name) for name in tex_names]
    atlas, sizes = _pack_atlas([blank if img is None else img for img in images])
    cat = np.concatenate
    f32 = np.float32
    return Scene(
        positions=cat(pos_list).astype(f32),
        normals=cat(nrm_list).astype(f32),
        texcoords=cat(uv_list).astype(f32),
        indices=cat(idx_list).astype(np.int32),
        mesh_first_vertex=np.asarray(mfv, np.int32),
        mesh_vertex_count=np.asarray(mvc, np.int32),
        mesh_first_index=np.asarray(mfi, np.int32),
        mesh_index_count=np.asarray(mic, np.int32),
        mesh_texture=np.asarray(
            [tex_names.index(mesh.texture_name) if mesh.texture_name else -1
             for mesh in meshes], np.int32),
        mesh_kd=np.asarray(mkd, f32),
        mesh_first_prim=np.asarray(mfp, np.int32),
        **{f"tri_{k}": cat(v).astype(f32) for k, v in tri.items()},
        tri_mesh=cat(tmesh).astype(np.int32),
        atlas=atlas,
        atlas_size=sizes,
    )


def quantize_atlas(scene: Scene) -> Scene:
    """The float32 quad atlas [N,TH,TW,16] -> [N,TH,TW,4] int32, each
    channel one corner's rgba8 bits (r in the low byte): the reference's
    R8G8B8A8_UNORM texel precision (texture_system.cpp:58-66) at a quarter
    of the bytes. The bits are those of the JAX package's uint32 atlas,
    held as int32. Exact for sources on the 8-bit grid (PNG loads and the
    procedural textures)."""
    if scene.atlas.dtype == np.int32:
        return scene
    q = np.round(np.clip(scene.atlas, 0.0, 1.0) * 255.0).astype(np.uint32)
    packed = q[..., 0::4] | (q[..., 1::4] << 8) | (q[..., 2::4] << 16) | (q[..., 3::4] << 24)
    return scene._replace(atlas=packed.view(np.int32))


def _has_textures(scene: Scene) -> bool:
    return bool(np.any(scene.mesh_texture >= 0))


def merge_scenes(a: Scene, b: Scene) -> Scene:
    """Append scene `b`'s meshes to `a`'s pooled buffers, as repeated
    LoadSceneFromOBJ calls accumulate into the reference's geometry pools
    (asset_load_system.cpp:162-255, capsaicin.cpp:65-73). The streams
    concatenate (indices are mesh-local) and the mesh table's offsets
    shift by `a`'s totals. The atlases are padded to the joint tile size
    and concatenated, `b`'s texture ids shifted, unless one side has no
    textured mesh: its placeholder atlas is then dropped."""
    cat = np.concatenate
    if not _has_textures(b):
        atlas, sizes, b_tex_shift = a.atlas, a.atlas_size, 0
    elif not _has_textures(a):
        atlas, sizes, b_tex_shift = b.atlas, b.atlas_size, 0
    else:
        if a.atlas.dtype != b.atlas.dtype:
            raise ValueError("mixed atlas formats: quantize_atlas both scenes or neither")
        th = max(a.atlas.shape[1], b.atlas.shape[1])
        tw = max(a.atlas.shape[2], b.atlas.shape[2])
        na = a.atlas.shape[0]
        atlas = np.zeros((na + b.atlas.shape[0], th, tw, a.atlas.shape[3]), a.atlas.dtype)
        atlas[:na, : a.atlas.shape[1], : a.atlas.shape[2]] = a.atlas
        atlas[na:, : b.atlas.shape[1], : b.atlas.shape[2]] = b.atlas
        sizes, b_tex_shift = cat([a.atlas_size, b.atlas_size]), na

    def shifted(field, offset):
        return cat([getattr(a, field), getattr(b, field) + offset]).astype(np.int32)

    pooled = ("positions", "normals", "texcoords", "indices", "mesh_vertex_count",
              "mesh_index_count", "mesh_kd", "tri_v0", "tri_v1", "tri_v2", "tri_n0",
              "tri_n1", "tri_n2", "tri_t0", "tri_t1", "tri_t2")
    return Scene(
        **{f: cat([getattr(a, f), getattr(b, f)]) for f in pooled},
        mesh_first_vertex=shifted("mesh_first_vertex", a.positions.shape[0]),
        mesh_first_index=shifted("mesh_first_index", a.indices.shape[0]),
        mesh_texture=cat([a.mesh_texture,
                          np.where(b.mesh_texture >= 0, b.mesh_texture + b_tex_shift, -1)]
                         ).astype(np.int32),
        mesh_first_prim=shifted("mesh_first_prim", a.num_triangles),
        tri_mesh=shifted("tri_mesh", a.num_meshes),
        atlas=atlas,
        atlas_size=sizes,
    )


def load_scene_obj(path: str, texture_dir: Optional[str] = None) -> Scene:
    """OBJ file -> Scene in one call, with its diffuse textures read by
    `textures.load_texture` (the public API's LoadSceneFromOBJ,
    capsaicin.cpp:65-73)."""
    from . import textures as tex
    from .obj_loader import load_obj

    meshes, _ = load_obj(path)
    names = {m.texture_name for m in meshes if m.texture_name}
    return build_scene(meshes, {n: tex.load_texture(n, texture_dir) for n in names})
