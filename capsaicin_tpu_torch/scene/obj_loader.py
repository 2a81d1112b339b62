"""Wavefront OBJ/MTL ingest: the host-side asset pipeline of the reference
(asset_load_system.cpp:40-160, tinyobjloader), with the semantics of
capsaicin_tpu/scene/obj_loader.py:

  - one mesh per OBJ shape (an `o`/`g` group holding faces)
  - polygon faces triangulated as fans (tinyobjloader `triangulate`)
  - per-shape (v, t, n)-index-triple de-duplication into a compact local
    vertex stream (asset_load_system.cpp:100-142)
  - a missing normal -> (0,0,0); a missing texcoord -> (0,0)
  - a mesh's texture is the diffuse texture of its *first* face's material
    (asset_load_system.cpp:145-153); MTL `Kd` colours are recorded but the
    default shading ignores them (scene.h:52-61)

Files of 1 MiB and more go through the C++ loader (`capsaicin_tpu_torch.native`,
built from native/objloader.cpp at first use) when a host compiler is
there; the parser here is the reference and the fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Material:
    name: str
    kd: Tuple[float, float, float] = (0.75, 0.75, 0.75)
    ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    diffuse_texname: str = ""


@dataclass
class MeshData:
    """Per-mesh compacted geometry; mirrors MeshData/MeshComponent
    (asset_load_system.cpp:24-39, asset_load_system.h:29-39)."""

    name: str = ""
    positions: List[float] = field(default_factory=list)  # flat xyz
    normals: List[float] = field(default_factory=list)  # flat xyz
    texcoords: List[float] = field(default_factory=list)  # flat uv
    indices: List[int] = field(default_factory=list)
    texture_name: str = ""
    material: Optional[Material] = None


def parse_mtl(path: str) -> Dict[str, Material]:
    """The materials of an MTL file by name (Kd, Ke, map_Kd); {} if missing."""
    materials: Dict[str, Material] = {}
    cur: Optional[Material] = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl":
                cur = Material(name=parts[1] if len(parts) > 1 else "")
                materials[cur.name] = cur
            elif cur is None:
                continue
            elif tag == "Kd" and len(parts) >= 4:
                cur.kd = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif tag == "Ke" and len(parts) >= 4:
                cur.ke = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif tag == "map_Kd" and len(parts) >= 2:
                cur.diffuse_texname = parts[-1]
    return materials


def _resolve_index(raw: str, count: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based."""
    i = int(raw)
    return i - 1 if i > 0 else count + i


class _ShapeBuilder:
    """One shape's mesh, de-duplicating its (v, t, n) corners."""

    def __init__(self, name: str):
        self.mesh = MeshData(name=name)
        self.cache: Dict[Tuple[int, int, int], int] = {}
        self.first_mtl: Optional[str] = None

    def add_corner(self, triple, positions, normals, texcoords):
        vi, ti, ni = triple
        idx = self.cache.get(triple)
        if idx is None:
            idx = len(self.mesh.positions) // 3
            self.cache[triple] = idx
            self.mesh.positions.extend(positions[vi])
            self.mesh.normals.extend(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
            self.mesh.texcoords.extend(texcoords[ti] if ti >= 0 else (0.0, 0.0))
        self.mesh.indices.append(idx)


NATIVE_SIZE_THRESHOLD = 1 << 20  # files this large go through the C++ loader


def load_obj(path: str, material_dir: Optional[str] = None, force_python: bool = False
             ) -> Tuple[List[MeshData], Dict[str, Material]]:
    """Parse an OBJ file into per-shape MeshData and its materials. Files
    of NATIVE_SIZE_THRESHOLD bytes or more take the C++ loader where it
    builds (`native.available()`); the result is the same either way."""
    material_dir = material_dir or os.path.dirname(os.path.abspath(path))
    if not force_python and os.path.getsize(path) >= NATIVE_SIZE_THRESHOLD:
        result = _try_native(path, material_dir)
        if result is not None:
            return result
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    materials: Dict[str, Material] = {}
    shapes: List[_ShapeBuilder] = []
    cur = _ShapeBuilder("")
    cur_mtl: Optional[str] = None

    def close(shape):
        # tinyobjloader drops a shape without faces
        if shape.mesh.indices:
            shapes.append(shape)

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                texcoords.append((float(parts[1]), float(parts[2])))
            elif tag in ("o", "g"):
                close(cur)
                cur = _ShapeBuilder(parts[1] if len(parts) > 1 else "")
            elif tag == "usemtl":
                cur_mtl = parts[1] if len(parts) > 1 else None
            elif tag == "mtllib" and len(parts) > 1:
                materials.update(parse_mtl(os.path.join(material_dir, parts[1])))
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _resolve_index(comps[0], len(positions))
                    ti = (_resolve_index(comps[1], len(texcoords))
                          if len(comps) > 1 and comps[1] else -1)
                    ni = (_resolve_index(comps[2], len(normals))
                          if len(comps) > 2 and comps[2] else -1)
                    corners.append((vi, ti, ni))
                if cur.first_mtl is None:
                    cur.first_mtl = cur_mtl
                for k in range(1, len(corners) - 1):  # fan triangulation
                    for triple in (corners[0], corners[k], corners[k + 1]):
                        cur.add_corner(triple, positions, normals, texcoords)
    close(cur)

    meshes: List[MeshData] = []
    for shape in shapes:
        mesh = shape.mesh
        mat = materials.get(shape.first_mtl) if shape.first_mtl else None
        mesh.material = mat
        mesh.texture_name = mat.diffuse_texname if mat else ""
        meshes.append(mesh)
    return meshes, materials


def _try_native(path: str, material_dir: str):
    """load_obj through the C++ loader; None where it does not build."""
    from .. import native

    loaded = native.load_obj_native(path)
    if loaded is None:
        return None
    meshes, mtllib = loaded
    materials = parse_mtl(os.path.join(material_dir, mtllib)) if mtllib else {}
    for mesh in meshes:
        mat = materials.get(mesh._material_name)
        mesh.material = mat
        mesh.texture_name = mat.diffuse_texname if mat else ""
    return meshes, materials


def mesh_arrays(mesh: MeshData):
    """MeshData -> numpy arrays (positions [V,3], normals [V,3], uvs [V,2], indices [I])."""
    pos = np.asarray(mesh.positions, np.float32).reshape(-1, 3)
    nrm = np.asarray(mesh.normals, np.float32).reshape(-1, 3)
    uv = np.asarray(mesh.texcoords, np.float32).reshape(-1, 2)
    idx = np.asarray(mesh.indices, np.int32)
    return pos, nrm, uv, idx
