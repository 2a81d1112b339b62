"""Scenes as the benchmark makes them: meshes of triangles with their
materials, from a generator under portbench/scenes/ named by the
configuration, assembled into the arrays that the program's set_scene and
the reference both take (the fields of capsaicin_tpu_torch's Scene, by
name). A frozen copy of the port's mesh helpers and build_scene
(scene/procedural.py, scene/scene.py), without textures.
"""

from __future__ import annotations

import importlib.util
import math
import os
from dataclasses import dataclass, field
from typing import List, NamedTuple, Tuple

import numpy as np

SCENES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


@dataclass
class Material:
    name: str
    kd: Tuple[float, float, float] = (0.75, 0.75, 0.75)


@dataclass
class MeshData:
    name: str = ""
    positions: List[float] = field(default_factory=list)  # flat xyz
    normals: List[float] = field(default_factory=list)  # flat xyz
    texcoords: List[float] = field(default_factory=list)  # flat uv
    indices: List[int] = field(default_factory=list)
    material: Material = None


class Scene(NamedTuple):
    positions: np.ndarray  # [V,3] f32
    normals: np.ndarray  # [V,3] f32
    texcoords: np.ndarray  # [V,2] f32
    indices: np.ndarray  # [I] i32
    mesh_first_vertex: np.ndarray  # [M] i32
    mesh_vertex_count: np.ndarray
    mesh_first_index: np.ndarray
    mesh_index_count: np.ndarray
    mesh_texture: np.ndarray  # [M] i32, -1: no texture
    mesh_kd: np.ndarray  # [M,3] f32
    mesh_first_prim: np.ndarray  # [M] i32
    tri_v0: np.ndarray  # [T,3]
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_n0: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_t0: np.ndarray  # [T,2]
    tri_t1: np.ndarray
    tri_t2: np.ndarray
    tri_mesh: np.ndarray  # [T] i32
    atlas: np.ndarray  # [1,1,1,16] f32: no texture
    atlas_size: np.ndarray  # [1,2] i32

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    def triangles(self) -> np.ndarray:
        """[T,3,3] float32 (v0, v1, v2)."""
        return np.stack([self.tri_v0, self.tri_v1, self.tri_v2], 1)


def quad(mesh: MeshData, v0, v1, v2, v3, normal, uvs=None):
    """Append a quad (two fan triangles) with a shared normal."""
    base = len(mesh.positions) // 3
    uvs = uvs or [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    for v, uv in zip((v0, v1, v2, v3), uvs):
        mesh.positions.extend(v)
        mesh.normals.extend(normal)
        mesh.texcoords.extend(uv)
    mesh.indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])


def rot_y(p, deg, cx=0.0, cz=0.0):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = p
    x -= cx
    z -= cz
    return (c * x + s * z + cx, y, -s * x + c * z + cz)


def box(name: str, mat: Material, center, size, rot_deg=0.0) -> MeshData:
    """Axis-aligned box rotated about Y; 12 triangles, outward normals."""
    mesh = MeshData(name=name, material=mat)
    cx, cy, cz = center
    hx, hy, hz = size[0] / 2, size[1] / 2, size[2] / 2
    faces = [
        ([(-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz), (hx, -hy, -hz)], (0, 0, -1)),
        ([(hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz), (-hx, -hy, hz)], (0, 0, 1)),
        ([(-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz), (-hx, -hy, -hz)], (-1, 0, 0)),
        ([(hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz), (hx, -hy, hz)], (1, 0, 0)),
        ([(-hx, hy, -hz), (-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz)], (0, 1, 0)),
        ([(-hx, -hy, hz), (-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz)], (0, -1, 0)),
    ]
    for corners, n in faces:
        pts = [rot_y((cx + dx, cy + dy, cz + dz), rot_deg, cx, cz) for (dx, dy, dz) in corners]
        quad(mesh, *pts, normal=rot_y(n, rot_deg))
    return mesh


def build_scene(meshes: List[MeshData]) -> Scene:
    """The pooled streams, mesh table and flattened triangles of `meshes`
    (scene/scene.py's build_scene for meshes without textures)."""
    pos_l, nrm_l, uv_l, idx_l, tri_l, mesh_l = [], [], [], [], [], []
    table = {k: [] for k in ("fv", "vc", "fi", "ic", "kd", "fp")}
    first_vertex = first_index = first_prim = 0
    for mesh_id, mesh in enumerate(meshes):
        pos = np.asarray(mesh.positions, np.float32).reshape(-1, 3)
        nrm = np.asarray(mesh.normals, np.float32).reshape(-1, 3)
        uv = np.asarray(mesh.texcoords, np.float32).reshape(-1, 2)
        idx = np.asarray(mesh.indices, np.int32)
        corners = idx.reshape(-1, 3)
        pos_l.append(pos)
        nrm_l.append(nrm)
        uv_l.append(uv)
        idx_l.append(idx)
        tri_l.append((pos[corners], nrm[corners], uv[corners]))
        mesh_l.append(np.full(corners.shape[0], mesh_id, np.int32))
        for key, value in (("fv", first_vertex), ("vc", pos.shape[0]), ("fi", first_index),
                           ("ic", idx.shape[0]), ("fp", first_prim),
                           ("kd", mesh.material.kd if mesh.material else (0.75, 0.75, 0.75))):
            table[key].append(value)
        first_vertex += pos.shape[0]
        first_index += idx.shape[0]
        first_prim += corners.shape[0]
    cat = np.concatenate
    p, n, t = (cat([x[i] for x in tri_l]) for i in range(3))
    i32 = lambda key: np.asarray(table[key], np.int32)  # noqa: E731
    return Scene(
        positions=cat(pos_l), normals=cat(nrm_l), texcoords=cat(uv_l), indices=cat(idx_l),
        mesh_first_vertex=i32("fv"), mesh_vertex_count=i32("vc"), mesh_first_index=i32("fi"),
        mesh_index_count=i32("ic"), mesh_texture=np.full(len(meshes), -1, np.int32),
        mesh_kd=np.asarray(table["kd"], np.float32), mesh_first_prim=i32("fp"),
        tri_v0=p[:, 0], tri_v1=p[:, 1], tri_v2=p[:, 2], tri_n0=n[:, 0], tri_n1=n[:, 1],
        tri_n2=n[:, 2], tri_t0=t[:, 0], tri_t1=t[:, 1], tri_t2=t[:, 2], tri_mesh=cat(mesh_l),
        atlas=np.zeros((1, 1, 1, 16), np.float32), atlas_size=np.ones((1, 2), np.int32),
    )


def make_scene(spec: dict) -> Scene:
    """The scene of a configuration's "scene" entry: {"generator": name,
    ...its parameters}, the generator being portbench/scenes/<name>.py's
    `meshes(**parameters)`."""
    params = dict(spec)
    name = params.pop("generator")
    path = os.path.join(SCENES_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no scene generator {name!r} ({path})")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_scene_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return build_scene(module.meshes(**params))
