"""The Scene: flat arrays describing all geometry and materials, with the
fields of capsaicin_tpu/scene/scene.py. A Scene built here holds numpy
arrays; `convert.scene_from_numpy` gives the same Scene with torch tensors
on a device.

Only untextured scenes are built so far: the atlas is the 1x1 fallback.
Textured scenes wait for ROADMAP A8.
"""

from __future__ import annotations

from typing import List, NamedTuple

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

    atlas: np.ndarray  # [N,TH,TW,16] f32 quad-packed texels
    atlas_size: np.ndarray  # [N,2] i32 (w,h)

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]


def build_scene(meshes: List[MeshData]) -> Scene:
    """Assemble an untextured Scene from per-mesh data."""
    if any(mesh.texture_name for mesh in meshes):
        raise NotImplementedError("textured scenes are not ported yet (ROADMAP A8)")
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
        mesh_texture=np.full(len(meshes), -1, np.int32),
        mesh_kd=np.asarray(mkd, f32),
        mesh_first_prim=np.asarray(mfp, np.int32),
        **{f"tri_{k}": cat(v).astype(f32) for k, v in tri.items()},
        tri_mesh=cat(tmesh).astype(np.int32),
        atlas=np.zeros((1, 1, 1, 16), f32),
        atlas_size=np.ones((1, 2), np.int32),
    )
